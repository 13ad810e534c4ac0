"""The port's objective evaluation (gradtts_tpu_torch/eval): YIN F0, DTW,
mcep, metric formulas, the MCD tool and the WORLD backend, held to the
checks and committed golden values of tests/test_eval.py; then every public
function of gradtts_tpu.eval (and of its worldnp module) against the port's
copy on the same seeded inputs, the results exactly equal."""

import os

import numpy as np
import pytest

from gradtts_tpu_torch.eval import (
    align, dtw_path, evaluate_pair, f0_frame_error, gross_pitch_error,
    log_f0_rmse, mcd, mcep_from_waveform, voicing_decision_error,
    warp_frequency, yin_f0, evaluate_mcd_dirs,
)

FS = 16000


def _tone(f0, seconds=0.5, fs=FS, amp=0.3):
    t = np.arange(int(seconds * fs)) / fs
    return amp * np.sin(2 * np.pi * f0 * t)


# --- YIN -------------------------------------------------------------------


def test_yin_pure_tone():
    for f0 in (110.0, 220.0, 330.0):
        track = yin_f0(_tone(f0), FS)
        voiced = track[track > 0]
        assert voiced.size > 0.8 * track.size
        np.testing.assert_allclose(np.median(voiced), f0, rtol=0.02)


def test_yin_silence_is_unvoiced():
    track = yin_f0(np.zeros(8000), FS)
    assert np.all(track == 0)


def test_yin_noise_mostly_unvoiced():
    rng = np.random.default_rng(0)
    track = yin_f0(rng.standard_normal(8000) * 0.1, FS)
    assert np.mean(track > 0) < 0.35


def test_yin_voiced_unvoiced_boundary():
    x = np.concatenate([_tone(220, 0.3), np.zeros(FS // 4)])
    track = yin_f0(x, FS)
    third = len(track) // 3
    assert np.mean(track[:third] > 0) > 0.8
    assert np.mean(track[-third:] > 0) < 0.2


# --- DTW -------------------------------------------------------------------


def test_dtw_identity():
    a = np.random.default_rng(0).standard_normal((10, 3))
    cost, path = dtw_path(a, a)
    assert cost == pytest.approx(0.0, abs=1e-6)
    assert path == [(i, i) for i in range(10)]


def test_dtw_shift_alignment():
    a = np.array([[0.], [0.], [1.], [2.], [3.]])
    b = np.array([[0.], [1.], [2.], [3.]])
    cost, path = dtw_path(a, b)
    assert cost == pytest.approx(0.0)
    ai, bi = np.array(path).T
    # aligned values must match exactly
    np.testing.assert_array_equal(a[ai], b[bi])


def test_dtw_monotone_and_complete():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((12, 2)), rng.standard_normal((7, 2))
    _, path = dtw_path(a, b)
    ai, bi = np.array(path).T
    assert path[0] == (0, 0) and path[-1] == (11, 6)
    assert np.all(np.diff(ai) >= 0) and np.all(np.diff(bi) >= 0)
    assert np.all((np.diff(ai) + np.diff(bi)) >= 1)


# --- mcep ------------------------------------------------------------------


def test_warp_frequency_endpoints_and_inverse():
    om = np.linspace(0, np.pi, 50)
    w = warp_frequency(om, 0.42)
    assert w[0] == pytest.approx(0.0)
    assert w[-1] == pytest.approx(np.pi)
    assert np.all(np.diff(w) > 0)
    np.testing.assert_allclose(warp_frequency(w, -0.42), om, atol=1e-9)


def test_mcep_shapes_and_sensitivity():
    x = _tone(220)
    mc = mcep_from_waveform(x, FS, n_fft=512, n_shift=256, order=23,
                            alpha=0.42)
    assert mc.shape == ((len(x) - 512) // 256 + 1, 24)
    mc2 = mcep_from_waveform(_tone(440), FS, n_fft=512, n_shift=256,
                             order=23, alpha=0.42)
    # different spectra -> different cepstra
    assert np.mean(np.abs(mc.mean(0) - mc2.mean(0))) > 1e-3


def test_mcd_zero_for_identical():
    x = _tone(220)
    mc = mcep_from_waveform(x, FS)
    assert mcd(mc, mc) == pytest.approx(0.0)
    assert mcd(mc, mc, use_dtw=False) == pytest.approx(0.0)


# --- F0 metric formulas (hand values) -------------------------------------


def test_f0_metric_formulas():
    true_f = np.array([100.0, 100.0, 0.0, 200.0, 0.0])
    est_f = np.array([100.0, 150.0, 50.0, 0.0, 0.0])
    # both-voiced frames: idx 0, 1; gross errors among them: idx 1 (50% off)
    assert gross_pitch_error(true_f, est_f) == pytest.approx(1 / 2)
    # voicing mismatches: idx 2 (est voiced), idx 3 (est unvoiced) -> 2/5
    assert voicing_decision_error(true_f, est_f) == pytest.approx(2 / 5)
    # ffe = (gpe_frames + vde_frames) / len = (1 + 2)/5
    assert f0_frame_error(true_f, est_f) == pytest.approx(3 / 5)
    # log rmse over both-voiced frames 0,1
    expected = np.sqrt(np.mean([0.0, (np.log(150) - np.log(100)) ** 2]))
    assert log_f0_rmse(true_f, est_f) == pytest.approx(expected)


# --- end-to-end pair evaluation -------------------------------------------


def test_evaluate_pair_self_is_perfect():
    x = _tone(220, 0.6)
    m = evaluate_pair(x, x, FS)
    assert m['mcd'] == pytest.approx(0.0, abs=1e-9)
    assert m['log_f0_rmse'] == pytest.approx(0.0, abs=1e-9)
    assert m['gpe'] == 0.0 and m['vde'] == 0.0 and m['ffe'] == 0.0


def test_evaluate_pair_detects_pitch_shift():
    a = _tone(200, 0.6)
    b = _tone(300, 0.6)
    m = evaluate_pair(a, b, FS)
    assert m['gpe'] > 0.5                      # 50% off >> 20% band
    expected = abs(np.log(200) - np.log(300))
    assert m['log_f0_rmse'] == pytest.approx(expected, rel=0.1)
    assert m['mcd'] > 0.5


# --- MCD tool --------------------------------------------------------------


def test_evaluate_mcd_dirs(tmp_path):
    from scipy.io import wavfile
    gen, gt = tmp_path / 'gen', tmp_path / 'gt'
    gen.mkdir()
    gt.mkdir()
    for i, f0 in enumerate([220.0, 330.0]):
        ref = _tone(f0)
        pred = _tone(f0 * 1.01)
        wavfile.write(str(gt / f'utt{i}.wav'), FS,
                      (ref * 32767).astype(np.int16))
        wavfile.write(str(gen / f'utt{i}_gen.wav'), FS,
                      (pred * 32767).astype(np.int16))
    out = tmp_path / 'out'
    mcd_dict = evaluate_mcd_dirs(str(gen), str(gt), outdir=str(out), nj=2,
                                 n_fft=512, n_shift=256)
    assert sorted(mcd_dict) == ['utt0', 'utt1']
    assert all(np.isfinite(v) and v >= 0 for v in mcd_dict.values())
    utt2mcd = (out / 'utt2mcd').read_text().strip().splitlines()
    assert len(utt2mcd) == 2 and utt2mcd[0].startswith('utt0 ')
    assert (out / 'mcd_avg_result.txt').exists()


def test_evaluate_mcd_dirs_world_backend(tmp_path):
    """The standalone MCD tool's 'world' backend (SPTK mel-cepstral
    analysis, the reference tool's extractor) runs end-to-end through the
    directory driver and the CLI flag."""
    from scipy.io import wavfile
    gen, gt = tmp_path / 'gen', tmp_path / 'gt'
    gen.mkdir()
    gt.mkdir()
    ref = _tone(220.0, 0.4)
    pred = _tone(220.0 * 1.03, 0.4)
    wavfile.write(str(gt / 'u.wav'), FS, (ref * 32767).astype(np.int16))
    wavfile.write(str(gen / 'u_gen.wav'), FS,
                  (pred * 32767).astype(np.int16))
    out = tmp_path / 'out'
    mcd_dict = evaluate_mcd_dirs(str(gen), str(gt), outdir=str(out), nj=1,
                                 n_fft=512, n_shift=256, backend='world')
    assert np.isfinite(mcd_dict['u']) and mcd_dict['u'] > 0
    from gradtts_tpu_torch.eval.mcd_tool import mcd_for_pair
    same = mcd_for_pair(str(gen / 'u_gen.wav'), str(gen / 'u_gen.wav'),
                        n_fft=512, n_shift=256, backend='world')
    assert same == pytest.approx(0.0, abs=1e-9)
    with pytest.raises(ValueError):
        mcd_for_pair(str(gen / 'u_gen.wav'), str(gt / 'u.wav'),
                     backend='nope')
    from gradtts_tpu_torch.cli.evaluate_mcd import main as mcd_main
    mcd_main([str(gen), str(gt), '--outdir', str(out), '--nj', '1',
              '--n_fft', '512', '--n_shift', '256',
              '--dsp-backend', 'world'])
    assert (out / 'utt2mcd').exists()


# --- golden-value regression guard (committed fixtures) --------------------

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


def test_dsp_golden_values():
    """Frozen YIN/mcep/metric outputs for the committed fixture wavs: any
    change to the built-in DSP (eval/f0.py, eval/mcep.py, eval/metrics.py)
    that shifts numbers must be deliberate and re-freeze these values
    (regenerate via the script in this test's git history)."""
    from gradtts_tpu_torch.data.dataset import load_wav
    golden = np.load(os.path.join(FIXTURES, 'eval_golden.npz'))
    a, fs = load_wav(os.path.join(FIXTURES, 'eval_a.wav'))
    b, _ = load_wav(os.path.join(FIXTURES, 'eval_b.wav'))

    np.testing.assert_allclose(
        yin_f0(a, fs, frame_length=512, hop=256), golden['f0_a'],
        rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(
        yin_f0(b, fs, frame_length=512, hop=256), golden['f0_b'],
        rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(mcep_from_waveform(a, fs), golden['mcep_a'],
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(mcep_from_waveform(b, fs), golden['mcep_b'],
                               rtol=1e-10, atol=1e-10)

    names = [str(n) for n in golden['metric_names']]
    m_ab = evaluate_pair(a, b, fs, backend='yin')
    np.testing.assert_allclose([m_ab[k] for k in names],
                               golden['metrics_ab'], rtol=1e-8)
    m_aa = evaluate_pair(a, a, fs, backend='yin')
    np.testing.assert_allclose([m_aa[k] for k in names],
                               golden['metrics_aa'], rtol=1e-8, atol=1e-12)


def test_dsp_backend_selection():
    from gradtts_tpu_torch.data.dataset import load_wav
    from gradtts_tpu_torch.eval.world import world_available
    a, fs = load_wav(os.path.join(FIXTURES, 'eval_a.wav'))
    with pytest.raises(ValueError):
        evaluate_pair(a, a, fs, backend='nope')
    # 'auto' resolves to whichever backend this environment has
    m = evaluate_pair(a, a, fs, backend='auto')
    assert m['mcd'] == pytest.approx(0.0, abs=1e-8)


def test_world_backend_reference_comparable():
    """The 'world' backend (WORLD harvest + CheapTrick + SPTK mcep — the
    reference toolchain's extractors) executes everywhere: through
    pyworld/pysptk when installed, else through the from-scratch numpy
    implementations in eval/worldnp.py.  Either way self-comparison is
    exactly zero and distinct audio separates."""
    from gradtts_tpu_torch.data.dataset import load_wav
    a, fs = load_wav(os.path.join(FIXTURES, 'eval_a.wav'))
    b, _ = load_wav(os.path.join(FIXTURES, 'eval_b.wav'))
    m_aa = evaluate_pair(a, a, fs, backend='world')
    assert m_aa['mcd'] == pytest.approx(0.0, abs=1e-6)
    assert m_aa['log_f0_rmse'] == pytest.approx(0.0, abs=1e-9)
    assert m_aa['gpe'] == 0.0 and m_aa['vde'] == 0.0 and m_aa['ffe'] == 0.0
    m_ab = evaluate_pair(a, b, fs, backend='world')
    assert m_ab['mcd'] > 0.5 and m_ab['log_f0_rmse'] > 0.05


def test_world_golden_values():
    """Frozen outputs of the from-scratch WORLD/SPTK backend
    (eval/worldnp.py) on the committed fixture wavs: any change that
    shifts harvest F0 tracks, mcep tracks, or metrics must be deliberate
    and re-freeze these values (regenerate via
    tools/freeze_world_golden.py).  Complements tests/test_worldnp.py's
    ground-truth accuracy suite with an exact regression pin."""
    from gradtts_tpu_torch.data.dataset import load_wav
    from gradtts_tpu_torch.eval.world import sptk_mcep, world_extract
    golden = np.load(os.path.join(FIXTURES, 'world_golden.npz'))
    a, fs = load_wav(os.path.join(FIXTURES, 'eval_a.wav'))
    b, _ = load_wav(os.path.join(FIXTURES, 'eval_b.wav'))

    mc_a, f0_a = world_extract(a, fs, impl='numpy')
    _, f0_b = world_extract(b, fs, impl='numpy')
    np.testing.assert_array_equal(f0_a > 0, golden['f0_a'] > 0)
    np.testing.assert_allclose(f0_a, golden['f0_a'], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(f0_b, golden['f0_b'], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(mc_a, golden['mcep_f0_a'], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(sptk_mcep(a, fs, impl='numpy'),
                               golden['sptk_mcep_a'], rtol=1e-5, atol=1e-7)
    m_ab = evaluate_pair(a, b, fs, backend='world')
    names = [str(n) for n in golden['metric_names']]
    np.testing.assert_allclose([m_ab[k] for k in names],
                               golden['metrics_ab'], rtol=1e-6)


def test_world_numpy_crosschecks_pyworld():
    """Where pyworld/pysptk ARE installed, the numpy re-implementations
    must agree with the C libraries on the fixture audio: same voicing
    decisions on >=85% of frames, median voiced F0 within 1%, and SPTK
    mcep tracks close enough that the MCD between the two implementations'
    cepstra of the SAME audio is far below a real inter-audio MCD.
    Skipped only where the C libraries are absent (the numpy side is then
    covered by tests/test_worldnp.py's ground-truth suite)."""
    from gradtts_tpu_torch.eval.world import world_available
    if not world_available():
        pytest.skip('pyworld/pysptk not installed in this environment')
    from gradtts_tpu_torch.data.dataset import load_wav
    from gradtts_tpu_torch.eval.world import sptk_mcep, world_extract
    a, fs = load_wav(os.path.join(FIXTURES, 'eval_a.wav'))
    mc_c, f0_c = world_extract(a, fs, impl='pyworld')
    mc_n, f0_n = world_extract(a, fs, impl='numpy')
    n = min(len(f0_c), len(f0_n))
    agree = np.mean((f0_c[:n] > 0) == (f0_n[:n] > 0))
    assert agree >= 0.85
    both = (f0_c[:n] > 0) & (f0_n[:n] > 0)
    if both.any():
        assert (np.median(f0_n[:n][both])
                == pytest.approx(np.median(f0_c[:n][both]), rel=0.01))
    m_c = sptk_mcep(a, fs, impl='pyworld')
    m_n = sptk_mcep(a, fs, impl='numpy')
    assert mcd(m_n, m_c) < 1.0  # same audio, two impls: near-identical


# --- the port's copies against the JAX package's functions -----------------

import inspect  # noqa: E402

import gradtts_tpu.eval as jeval  # noqa: E402
import gradtts_tpu_torch.eval as teval  # noqa: E402
from gradtts_tpu.eval import worldnp as jworldnp  # noqa: E402
from gradtts_tpu_torch.eval import worldnp as tworldnp  # noqa: E402


def _voice(seed, seconds=0.4, fs=FS):
    """A harmonic tone of a seeded pitch with a vibrato, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    f0 = rng.uniform(110, 260) * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(np.sin(h * phase) / h for h in range(1, 5))
    return 0.2 * x + 0.01 * rng.standard_normal(t.shape)


def _f0_pair(seed, n=40):
    rng = np.random.default_rng(seed)
    true_f = rng.uniform(80, 300, n) * (rng.random(n) > 0.3)
    est_f = true_f * rng.uniform(0.7, 1.3, n) * (rng.random(n) > 0.2)
    return true_f, est_f


@pytest.fixture(scope='module')
def wav_dirs(tmp_path_factory):
    """gen/ and gt/ directories of three seeded wav pairs (16 kHz)."""
    from scipy.io import wavfile
    root = tmp_path_factory.mktemp('mcd')
    for d in ('gen', 'gt'):
        (root / d).mkdir()
    for i in range(3):
        wavfile.write(str(root / 'gt' / f'utt{i}.wav'), FS,
                      (_voice(10 + i) * 32767).astype(np.int16))
        wavfile.write(str(root / 'gen' / f'utt{i}_gen.wav'), FS,
                      (_voice(20 + i) * 32767).astype(np.int16))
    return root


def _args(name, dirs, out):
    """(args, kwargs) of the case ``name``: seeded numpy inputs, or files
    under ``dirs``; functions that write get the directory ``out``."""
    rng = np.random.default_rng(CASES.index(name))
    x, y = _voice(1), _voice(2)
    gen, gt = str(dirs / 'gen' / 'utt0_gen.wav'), str(dirs / 'gt' / 'utt0.wav')
    frames = (x[:512 * 4].reshape(4, 512) * np.hamming(512))
    sp = np.abs(np.fft.rfft(frames, axis=-1)) ** 2 + 1e-6
    return {
        'find_files': ((str(dirs),), {}),
        'basename_noext': (('/a/b/utt1_gen.wav',), {}),
        'resample': ((x, 16000, 22050), {}),
        'frame_signal': ((x, 512, 256), {}),
        'best_mcep_params': ((22050,), {}),
        'dtw_path': ((rng.standard_normal((30, 5)),
                      rng.standard_normal((24, 5))), {}),
        'align': ((rng.standard_normal((30, 5)),
                   rng.standard_normal((24, 5))), {}),
        'warping_indices': ((rng.standard_normal((30, 5)),
                             rng.standard_normal((24, 5))), {}),
        'yin_f0': ((x, FS), {}),
        'warp_frequency': ((np.linspace(0, np.pi, 77), 0.42), {}),
        'log_spectrum_to_mcep': ((np.log(sp), 24, 0.42), {}),
        'mcep_from_waveform': ((x, FS), dict(order=23, alpha=0.42)),
        'gross_pitch_error': (_f0_pair(3), {}),
        'voicing_decision_error': (_f0_pair(4), {}),
        'f0_frame_error': (_f0_pair(5), {}),
        'log_f0_rmse': (_f0_pair(6), {}),
        'mcd': ((rng.standard_normal((30, 24)),
                 rng.standard_normal((26, 24))), {}),
        'mel_dtw_distance': ((rng.standard_normal((30, 80)),
                              rng.standard_normal((26, 80))), {}),
        'evaluate_pair[yin]': ((x, y, FS), dict(backend='yin')),
        'evaluate_pair[world]': ((x, y, FS), dict(backend='world')),
        'mcd_for_pair[yin]': ((gen, gt), dict(n_fft=512, backend='yin')),
        'mcd_for_pair[world]': ((gen, gt), dict(n_fft=512, backend='world')),
        'evaluate_mcd_dirs': ((str(dirs / 'gen'), str(dirs / 'gt')),
                              dict(outdir=str(out), nj=1, n_fft=512)),
        'world_available': ((), {}),
        'world_extract': ((x, FS), dict(impl='numpy')),
        'sptk_mcep': ((x, FS), dict(impl='numpy')),
        'worldnp.hamming': ((400,), {}),
        'worldnp.freqt': ((rng.standard_normal((3, 20)), 30, 0.45), {}),
        'worldnp.sp2mc': ((sp, 34, 0.45), {}),
        'worldnp.mc2sp': ((rng.standard_normal((3, 25)) * 0.3, 0.45, 512),
                          {}),
        'worldnp.mcep': ((frames, 24, 0.42), {}),
        'worldnp.mcep_frames_from_waveform': ((x, FS), {}),
        'worldnp.cheaptrick_f0_floor': ((22050, 1024), {}),
        'worldnp.cheaptrick': ((x, np.full(20, 180.0),
                                np.arange(20) * 0.016, FS), {}),
        'worldnp.harvest': ((x, FS), {}),
    }[name]


CASES = ['find_files', 'basename_noext', 'resample', 'frame_signal',
         'best_mcep_params', 'dtw_path', 'align', 'warping_indices',
         'yin_f0', 'warp_frequency', 'log_spectrum_to_mcep',
         'mcep_from_waveform', 'gross_pitch_error', 'voicing_decision_error',
         'f0_frame_error', 'log_f0_rmse', 'mcd', 'mel_dtw_distance',
         'evaluate_pair[yin]', 'evaluate_pair[world]', 'mcd_for_pair[yin]',
         'mcd_for_pair[world]', 'evaluate_mcd_dirs', 'world_available',
         'world_extract', 'sptk_mcep', 'worldnp.hamming', 'worldnp.freqt',
         'worldnp.sp2mc', 'worldnp.mc2sp', 'worldnp.mcep',
         'worldnp.mcep_frames_from_waveform', 'worldnp.cheaptrick_f0_floor',
         'worldnp.cheaptrick', 'worldnp.harvest']


def _fn(package, worldnp, case):
    name = case.split('[')[0]
    if name.startswith('worldnp.'):
        return getattr(worldnp, name[len('worldnp.'):])
    if name == 'basename_noext':
        return getattr(package.dsp, name)
    return getattr(package, name)


def _assert_identical(got, want, where='result'):
    """Equal type and structure, and every number bit for bit (NaN equal
    to NaN)."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_identical(got[k], want[k], f'{where}[{k!r}]')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_identical(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float):
        assert got == want or (np.isnan(got) and np.isnan(want)), \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


def test_every_public_function_has_a_case():
    """The cases cover every public function of gradtts_tpu.eval and of its
    worldnp module, and the port's package has the same public names."""
    public = {n for n, v in vars(jeval).items()
              if not n.startswith('_') and inspect.isfunction(v)}
    public |= {'worldnp.' + n for n, v in vars(jworldnp).items()
               if not n.startswith('_') and inspect.isfunction(v)
               and v.__module__ == jworldnp.__name__}
    public.add('basename_noext')
    assert public == {c.split('[')[0] for c in CASES}
    assert {n for n in dir(jeval) if not n.startswith('_')} == \
        {n for n in dir(teval) if not n.startswith('_')}
    assert teval.MCD_CONST == jeval.MCD_CONST


@pytest.mark.parametrize('case', CASES)
def test_port_function_equals_jax_package(case, wav_dirs, tmp_path):
    """The same seeded inputs through gradtts_tpu.eval and the port's copy:
    the results are exactly equal (the same numpy code), and where the
    function writes files, so are the files."""
    outs = []
    for package, worldnp, side in ((jeval, jworldnp, 'jax'),
                                   (teval, tworldnp, 'port')):
        out = tmp_path / side
        args, kwargs = _args(case, wav_dirs, out)
        outs.append(_fn(package, worldnp, case)(*args, **kwargs))
        assert _fn(package, worldnp, case).__module__.startswith(
            package.__name__)
    _assert_identical(outs[1], outs[0])
    if case == 'evaluate_mcd_dirs':
        for name in ('utt2mcd', 'mcd_avg_result.txt'):
            assert (tmp_path / 'port' / name).read_text() == \
                (tmp_path / 'jax' / name).read_text()
