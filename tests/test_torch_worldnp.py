"""The port's from-scratch WORLD/SPTK DSP backend
(gradtts_tpu_torch/eval/worldnp.py), held to the checks of
tests/test_worldnp.py.

Validates the numpy re-implementations of the reference toolchain's
extractors (upstream evaluate_tts.py:118-156) on synthetic ground
truth: exact algebraic properties for freqt/sp2mc/mc2sp, the Newton
optimality conditions for SPTK mcep, envelope recovery for CheapTrick,
and F0 accuracy / voicing decisions for Harvest."""

import numpy as np
import pytest

from gradtts_tpu_torch.eval import worldnp as W

FS = 16000


def _harmonic(f0, seconds=0.5, n_harm=12, fs=FS, seed=0, tilt=1000.0):
    """Harmonic signal with a smooth 1/(1+(f/tilt)^2) envelope."""
    t = np.arange(int(seconds * fs)) / fs
    rng = np.random.default_rng(seed)
    x = np.zeros_like(t)
    for h in range(1, n_harm + 1):
        f = h * f0
        if f > fs / 2 - 200:
            break
        x += (1.0 / (1 + (f / tilt) ** 2)
              * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)))
    return 0.1 * x


# --- SPTK: freqt / sp2mc / mc2sp ------------------------------------------


def test_hamming_matches_numpy():
    np.testing.assert_allclose(W.hamming(512), np.hamming(512), atol=1e-12)


def test_freqt_identity_and_inverse():
    c = np.random.default_rng(0).standard_normal(20)
    np.testing.assert_allclose(W.freqt(c, 19, 0.0), c, atol=1e-12)
    # warp to high order, then unwarp: recovers the input
    back = W.freqt(W.freqt(c, 120, 0.42), 19, -0.42)
    np.testing.assert_allclose(back, c, atol=1e-10)


def test_freqt_batched_matches_single():
    c = np.random.default_rng(1).standard_normal((3, 2, 16))
    out = W.freqt(c, 10, 0.45)
    assert out.shape == (3, 2, 11)
    np.testing.assert_allclose(out[1, 0], W.freqt(c[1, 0], 10, 0.45),
                               atol=1e-14)


def test_sp2mc_mc2sp_roundtrip():
    """A spectrum generated from an order-34 mel-cepstrum is recovered
    exactly (up to the alpha^k freqt truncation, ~1e-12 at n_fft=512)."""
    mc = np.random.default_rng(1).standard_normal(35) * 0.3
    mc[0] = 1.0
    sp = W.mc2sp(mc, 0.45, 512)
    assert sp.shape == (257,) and np.all(sp > 0)
    np.testing.assert_allclose(W.sp2mc(sp, 34, 0.45), mc, atol=1e-10)


# --- SPTK mcep -------------------------------------------------------------


def _periodogram(frame, eps=1e-6):
    x = np.fft.rfft(frame)
    return x.real ** 2 + x.imag ** 2 + eps


def test_mcep_satisfies_newton_optimality():
    """At the Fukada-1992 optimum the warped autocorrelation of the
    whitened spectrum I/|H|^2 equals the all-pass DC coefficients:
    r~[m] = (-alpha)^m (r~[0] = 1)."""
    x = _harmonic(220, seconds=0.25)
    frame = x[:512] * W.hamming(512)
    order, alpha = 34, 0.45
    # tight stopping threshold to expose the true stationary point (the
    # SPTK default 1e-3 stops ~1% short of it, by design)
    mc = W.mcep(frame, order, alpha, eps=1e-6, etype=1, max_iter=100,
                threshold=1e-10)
    basis, w = W._warped_basis(512, 2 * order, alpha)
    whitened = _periodogram(frame) * np.exp(-2.0 * (mc @ basis[:order + 1]))
    rw = (whitened * (w / 512)) @ basis.T
    target = (-alpha) ** np.arange(order + 1)
    assert rw[0] == pytest.approx(1.0, abs=1e-4)
    assert np.abs(rw[1:order + 1] - target[1:]).max() < 1e-4


def test_mcep_improves_on_sp2mc_init():
    """The Newton refinement strictly lowers the spectral criterion
    E = mean(exp(R) - R - 1) versus the unrefined warped cepstrum."""
    x = _harmonic(180, seconds=0.25, seed=3)
    frame = x[1000:1512] * W.hamming(512)
    order, alpha = 24, 0.42
    per = _periodogram(frame)
    basis, w = W._warped_basis(512, order, alpha)

    def crit(mc):
        r = per * np.exp(-2.0 * (mc @ basis[:order + 1]))
        return ((r - np.log(r) - 1.0) * (w / 512)).sum()

    refined = W.mcep(frame, order, alpha)
    init = W.sp2mc(per, order, alpha)
    assert crit(refined) < crit(init)


def test_mcep_batch_matches_single():
    x = _harmonic(150, seconds=0.3, seed=4)
    frames = np.stack([x[i * 256:i * 256 + 512] for i in range(4)])
    frames = frames * W.hamming(512)
    batch = W.mcep(frames, 20, 0.45)
    assert batch.shape == (4, 21)
    for i in range(4):
        np.testing.assert_allclose(batch[i], W.mcep(frames[i], 20, 0.45),
                                   atol=1e-12)


def test_mcep_silence_is_flat():
    mc = W.mcep(np.zeros(512), 12, 0.45, eps=1e-6, etype=1)
    # periodogram == eps everywhere -> |H| = sqrt(eps), zero higher terms
    assert mc[0] == pytest.approx(0.5 * np.log(1e-6), rel=1e-6)
    assert np.abs(mc[1:]).max() < 1e-8


def test_mcep_rejects_unsupported_etype():
    with pytest.raises(NotImplementedError):
        W.mcep(np.zeros(512), 12, 0.45, etype=2)


def test_mcep_frames_from_waveform_framing():
    """Framing parity with the reference's sptk_extract: hop n_shift,
    (len-n_fft)//n_shift + 1 frames, hamming window."""
    x = _harmonic(200, seconds=0.3, seed=5)
    mc = W.mcep_frames_from_waveform(x, FS, n_fft=512, n_shift=256,
                                     order=18, alpha=0.45)
    assert mc.shape == ((len(x) - 512) // 256 + 1, 19)
    frame0 = x[:512] * W.hamming(512)
    np.testing.assert_allclose(mc[0], W.mcep(frame0, 18, 0.45), atol=1e-12)
    assert W.mcep_frames_from_waveform(np.zeros(100), FS).shape == (0, 35)


# --- CheapTrick ------------------------------------------------------------


def test_cheaptrick_recovers_envelope_tilt():
    """The envelope at harmonic frequencies tracks the known synthesis
    envelope: the 150 Hz -> 1500 Hz tilt of 1/(1+(f/1000)^2)^2 in power
    is -10 dB, recovered within 1.5 dB."""
    f0_true = 150.0
    x = _harmonic(f0_true, seconds=0.5, n_harm=25)
    n = int(0.5 / 0.016) + 1
    taxis = np.arange(n) * 0.016
    f0 = np.full(n, f0_true)
    sp = W.cheaptrick(x, f0, taxis, FS, fft_size=512)
    assert sp.shape == (n, 257) and np.all(np.isfinite(sp)) and np.all(sp > 0)
    k1 = int(round(150 * 512 / FS))
    k2 = int(round(1500 * 512 / FS))
    mid = sp[n // 2]
    tilt_db = 10 * np.log10(mid[k2] / mid[k1])
    true_db = 20 * np.log10((1 / (1 + 1.5 ** 2)) / (1 / (1 + 0.15 ** 2)))
    assert tilt_db == pytest.approx(true_db, abs=1.5)


def test_cheaptrick_unvoiced_frames_use_default_f0():
    """f0=0 frames fall back to WORLD's 500 Hz default window and still
    produce a finite positive envelope; the floor is 3 fs/(fft_size-3)."""
    assert W.cheaptrick_f0_floor(FS, 512) == pytest.approx(3 * FS / 509.0)
    rng = np.random.default_rng(0)
    x = 0.05 * rng.standard_normal(FS // 2)
    taxis = np.arange(10) * 0.016
    sp = W.cheaptrick(x, np.zeros(10), taxis, FS, fft_size=512)
    assert np.all(np.isfinite(sp)) and np.all(sp > 0)


# --- Harvest ---------------------------------------------------------------


def test_harvest_pure_tone_accuracy():
    x = _harmonic(150.0, seconds=0.5)
    f0, taxis = W.harvest(x, FS, 70.0, 400.0, frame_period=16.0)
    assert len(f0) == len(taxis)
    np.testing.assert_allclose(taxis, np.arange(len(f0)) * 0.016, atol=1e-12)
    inner = f0[2:-2]
    assert np.mean(inner > 0) > 0.95
    voiced = inner[inner > 0]
    assert np.max(np.abs(voiced / 150.0 - 1.0)) < 1e-3


def test_harvest_tracks_vibrato():
    dur = 0.8
    t = np.arange(int(dur * FS)) / FS
    f0_inst = 200.0 * (1 + 0.05 * np.sin(2 * np.pi * 4.0 * t))
    phase = 2 * np.pi * np.cumsum(f0_inst) / FS
    x = 0.2 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.05 * np.sin(3 * phase)
    f0, taxis = W.harvest(x, FS, 70.0, 400.0, 16.0)
    truth = 200.0 * (1 + 0.05 * np.sin(2 * np.pi * 4.0 * taxis))
    sl = slice(2, len(f0) - 2)
    voiced = f0[sl] > 0
    assert voiced.mean() > 0.95
    rel = np.abs(f0[sl][voiced] / truth[sl][voiced] - 1.0)
    assert rel.mean() < 2e-3 and rel.max() < 1e-2


def test_harvest_silence_and_noise_are_unvoiced():
    f0s, _ = W.harvest(np.zeros(FS // 2), FS, 70.0, 400.0, 16.0)
    assert np.all(f0s == 0)
    rng = np.random.default_rng(1)
    f0n, _ = W.harvest(0.1 * rng.standard_normal(int(0.6 * FS)), FS,
                       70.0, 400.0, 16.0)
    assert np.mean(f0n > 0) < 0.2


def test_harvest_voiced_unvoiced_segmentation():
    """120 Hz tone | noise | 250 Hz tone: correct pitch in each voiced
    segment, mostly-unvoiced middle (no extension bleed into the gap)."""
    rng = np.random.default_rng(1)
    seg1 = 0.3 * np.sin(2 * np.pi * 120 * np.arange(int(0.3 * FS)) / FS)
    seg2 = 0.02 * rng.standard_normal(int(0.2 * FS))
    seg3 = 0.3 * np.sin(2 * np.pi * 250 * np.arange(int(0.3 * FS)) / FS)
    f0, _ = W.harvest(np.concatenate([seg1, seg2, seg3]), FS, 70.0, 400.0,
                      16.0)
    n1, n2 = int(0.3 / 0.016), int(0.5 / 0.016)
    v1 = f0[2:n1 - 1]
    v3 = f0[n2 + 1:-2]
    assert np.median(v1[v1 > 0]) == pytest.approx(120.0, rel=5e-3)
    assert np.median(v3[v3 > 0]) == pytest.approx(250.0, rel=5e-3)
    assert np.mean(v1 > 0) > 0.9 and np.mean(v3 > 0) > 0.9
    assert np.mean(f0[n1 + 1:n2 - 1] > 0) < 0.3


def test_harvest_bridges_attenuated_dropout():
    """A 30 ms heavy attenuation inside a steady tone is bridged by the
    candidate pool (forward+backward agreement), not left unvoiced."""
    t = np.arange(int(0.6 * FS)) / FS
    x = 0.3 * np.sin(2 * np.pi * 180 * t)
    x[int(0.28 * FS):int(0.31 * FS)] *= 0.05
    f0, _ = W.harvest(x, FS, 70.0, 400.0, 16.0)
    notch = f0[int(0.28 / 0.016):int(0.31 / 0.016) + 1]
    assert np.all(notch > 0)
    np.testing.assert_allclose(notch, 180.0, rtol=0.02)


def test_harvest_and_cheaptrick_on_glottal_pulse_train():
    """Speech-like stress test: an impulse train with a gliding pitch
    (220 -> 130 Hz) through two formant resonators.  Harvest must track
    the glide (sharp pulses excite ALL harmonics — much harder than the
    smooth _harmonic fixtures) and CheapTrick must place the envelope
    peak on the 500 Hz formant, not on individual harmonics."""
    from scipy import signal
    fs, dur = FS, 0.7
    n = int(dur * fs)
    t = np.arange(n) / fs
    f0_inst = 220.0 * (130.0 / 220.0) ** (t / dur)
    phase = np.cumsum(f0_inst) / fs
    exc = np.zeros(n)
    exc[np.searchsorted(phase, np.arange(1, int(phase[-1])))] = 1.0
    for fc, bw in [(500.0, 80.0), (1500.0, 120.0)]:
        r = np.exp(-np.pi * bw / fs)
        exc = signal.lfilter(
            [1.0], [1.0, -2 * r * np.cos(2 * np.pi * fc / fs), r * r], exc)
    x = 0.3 * exc / np.abs(exc).max()

    f0, taxis = W.harvest(x, fs, 70.0, 400.0, 16.0)
    truth = 220.0 * (130.0 / 220.0) ** (taxis / dur)
    sl = slice(2, len(f0) - 2)
    voiced = f0[sl] > 0
    assert voiced.mean() > 0.95
    rel = np.abs(f0[sl][voiced] / truth[sl][voiced] - 1.0)
    assert rel.mean() < 5e-3 and rel.max() < 2e-2

    sp = W.cheaptrick(x, f0, taxis, fs, fft_size=512)
    mid = sp[len(f0) // 2]
    peak_hz = np.argmax(mid[:40]) * fs / 512.0   # search below 1250 Hz
    assert peak_hz == pytest.approx(500.0, abs=1.5 * fs / 512.0)


def test_harvest_respects_search_range():
    x = _harmonic(150.0, seconds=0.4)
    f0, _ = W.harvest(x, FS, 200.0, 400.0, 16.0)  # 150 outside range
    assert np.all((f0 == 0) | (f0 >= 200.0))
    assert np.mean(f0 > 0) < 0.5  # the true pitch cannot be reported


@pytest.mark.parametrize('fs', [8000, 22050, 44100])
def test_harvest_across_sampling_rates(fs):
    """Decimation ratio and grids adapt to fs (8 kHz: no decimation;
    22.05/44.1 kHz: the synthesis-side rates)."""
    t = np.arange(int(0.5 * fs)) / fs
    x = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.15 * np.sin(2 * np.pi * 360 * t)
    f0, _ = W.harvest(x, fs, 70.0, 400.0, 256.0 / fs * 1000.0)
    inner = f0[2:-2]
    assert np.mean(inner > 0) > 0.9
    assert np.median(inner[inner > 0]) == pytest.approx(180.0, rel=2e-3)


def test_harvest_empty_input():
    f0, taxis = W.harvest(np.zeros(0), FS)
    assert len(f0) == 0 and len(taxis) == 0


# --- world.py dispatch ------------------------------------------------------


def test_world_extract_numpy_impl_shapes():
    from gradtts_tpu_torch.eval.world import sptk_mcep, world_extract
    x = _harmonic(180.0, seconds=0.4, seed=7)
    mcep_track, f0 = world_extract(x, FS, 70.0, 400.0, 512, 256, 34, 0.45,
                                   impl='numpy')
    assert mcep_track.shape == (len(f0), 35)
    assert np.all(np.isfinite(mcep_track))
    voiced = f0[f0 > 0]
    assert voiced.size and np.median(voiced) == pytest.approx(180.0,
                                                              rel=5e-3)
    mc = sptk_mcep(x, FS, 512, 256, 34, 0.45, impl='numpy')
    assert mc.shape == ((len(x) - 512) // 256 + 1, 35)


def test_world_impl_validation():
    from gradtts_tpu_torch.eval.world import world_extract
    with pytest.raises(ValueError):
        world_extract(np.zeros(FS), FS, impl='nope')
