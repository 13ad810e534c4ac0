"""``cli.evaluate`` and ``cli.evaluate_mcd``: the port's per-utterance
function against the JAX CLI's per-utterance steps
(gradtts_tpu/cli/evaluate.py:86-116) with the noise the JAX key draws
there, on a tiny ljspeech model with JAX weights (through
``utils.convert``) and a tiny seeded HiFi-GAN: the mel within 1e-4 of its
largest value at a one-bucket budget and within 1e-5 at the preset's
buckets with both packages' GroupNorm statistics in f64, the waveform
within 1e-4, and the DSP bit for bit on the same waveform. Then the CLI
as that function with noise from its seeded generator (``.pt`` and JAX
vocoder directories, read as ``params['gen']``; the JAX CLI reads
``['params']`` at :79 and fails on the trainer's directories), the ``MEAN:``
line against ``metrics.json``, V1 when no vocoder config is given, the
speaker branches on a tiny tedlium-spk model, and ``cli.evaluate_mcd``
against ``gradtts_tpu.eval.evaluate_mcd_dirs`` at one and two jobs."""

import contextlib
import json
import re

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from _torch_port import (CMUDICT, TINY_SET, f64_groupnorm_statistics,
                         jax_model_and_params, seeded_tree, torch_model,
                         write_corpus)
from gradtts_tpu.cli.train_vocoder import _ckpt_payload
from gradtts_tpu.config import fix_len_compatibility as jax_fix_len
from gradtts_tpu.config import get_config as jax_get_config
from gradtts_tpu.data import dataset as jds
from gradtts_tpu.eval import evaluate_mcd_dirs as jax_evaluate_mcd_dirs
from gradtts_tpu.eval import evaluate_pair as jax_evaluate_pair
from gradtts_tpu.models import synthesize as jax_synthesize
from gradtts_tpu.models.hifigan import Generator as JaxGenerator
from gradtts_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from gradtts_tpu.train.checkpoint import save_checkpoint
from gradtts_tpu.train.vocoder import VocoderTrainState
from gradtts_tpu.utils.io import save_params_npz
from gradtts_tpu_torch.cli import evaluate
from gradtts_tpu_torch.cli.evaluate_mcd import main as evaluate_mcd_main
from gradtts_tpu_torch.cli.inference import load_vocoder
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.data.dataset import dataset_from_config, load_wav
from gradtts_tpu_torch.eval import evaluate_pair
from gradtts_tpu_torch.models.hifigan import HiFiGANConfig
from gradtts_tpu_torch.utils.convert import hifigan_flax_to_state_dict

N_ITEMS, STEPS = 3, 2
# hop 256 (8 * 8 * 4) at 16-8-4-2 channels: the presets' frame rate
VOCODER = dict(resblock='1', upsample_rates=[8, 8, 4],
               upsample_kernel_sizes=[16, 16, 8],
               upsample_initial_channel=16, resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 3]])
ONE_BUCKET = {'data.y_buckets': (64,)}


def _tiny(filelist, **extra):
    """The tiny widths' overrides of a preset, reading ``filelist``."""
    tiny = {k: int(v) for k, v in (s.split('=') for s in TINY_SET)}
    return {**tiny, 'data.cmudict_path': CMUDICT,
            'data.test_filelist_path': filelist, **extra}


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """A 3-utterance ljspeech test split, a tiny .npz checkpoint, and the
    tiny seeded vocoder as a .pt, a config JSON and a JAX vocoder
    trainer's directory."""
    tmp = tmp_path_factory.mktemp('evaluate')
    filelist = write_corpus(tmp, N_ITEMS)
    jmodel, params = jax_model_and_params(seed=81)
    ckpt = str(tmp / 'params.npz')
    save_params_npz(ckpt, params)
    jcfg = JaxHiFiGANConfig.from_json(VOCODER)
    gen = seeded_tree(jax.eval_shape(JaxGenerator(jcfg).init,
                                     jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8, 80))), 82)
    pt = str(tmp / 'hifigan.pt')
    torch.save({'generator': hifigan_flax_to_state_dict(
        gen, HiFiGANConfig.from_json(VOCODER))}, pt)
    config = str(tmp / 'hifigan.json')
    with open(config, 'w') as f:
        json.dump(VOCODER, f)
    # the trainer's payload; the discriminators and optimizer states are
    # stand-ins that the generator's reader never opens
    state = VocoderTrainState(step=np.int32(3), gen_params=gen,
                              mpd_params={'w': np.ones(2, np.float32)},
                              msd_params={'w': np.ones(2, np.float32)},
                              gen_opt={}, disc_opt={})
    voc_dir = str(tmp / 'voc_ckpt')
    save_checkpoint(voc_dir, _ckpt_payload(state), 3)
    return dict(filelist=filelist, jmodel=jmodel, params=params, ckpt=ckpt,
                gen=gen, jcfg=jcfg, pt=pt, config=config, voc_dir=voc_dir)


def _jax_cli_steps(s, cfg_over, n, seed=0, spk_of=None, preset='ljspeech'):
    """The JAX CLI's loop (gradtts_tpu/cli/evaluate.py:86-116) over the
    first ``n`` items: yields (item, ref wav, fs, budget, the noise its
    split key draws inside ``synthesize``, mel [frames, F], clipped
    waveform, metrics). ``spk_of(item)`` gives the speaker input."""
    jcfg = jax_get_config(preset, **cfg_over)
    dataset = jds.dataset_from_config(jcfg, 'test')
    vocoder = JaxGenerator(s['jcfg'])
    key = jax.random.PRNGKey(seed)
    for i in range(n):
        item = dataset[i]
        ref_x, fs = jds.load_wav(dataset.filepaths_and_text[i][0])
        budget = jax_fix_len(jds.bucket_length(2 * item['y'].shape[0] + 8,
                                               jcfg.data.y_buckets))
        key, sub = jax.random.split(key)
        spk = None if spk_of is None else spk_of(item)
        res = jax_synthesize(s['jmodel'], s['params'],
                             jnp.asarray(item['x'])[None],
                             jnp.asarray([item['x'].shape[0]]),
                             n_timesteps=STEPS, y_max_length=budget,
                             key=sub, temperature=1.5, spk=spk)
        frames = int(res.y_lengths[0])
        mel = res.decoder_outputs[:, :frames]
        pred = np.clip(np.asarray(vocoder.apply(s['gen'], mel))[0], -1, 1)
        metrics = jax_evaluate_pair(pred, ref_x, fs, backend='auto')
        # synthesize splits its key in three and draws z from the second
        noise = np.asarray(jax.random.normal(
            jax.random.split(sub, 3)[1], (1, budget, 80), jnp.float32))
        yield (item, ref_x, fs, budget, noise, np.asarray(mel[0]), pred,
               metrics)


@pytest.mark.parametrize('buckets,tol', [('one bucket', 1e-4),
                                         ('preset buckets', 1e-5)])
def test_utterance_matches_jax_cli_steps(setup, buckets, tol):
    """Each utterance of the split: the port's dataset item and budget are
    the JAX CLI's; ``evaluate_utterance`` with the noise of the JAX key
    gives the JAX mel (``tol`` of its largest value; at the preset's
    buckets the budget is mostly padding, so both packages' GroupNorm
    statistics are taken in f64 there, see tests/_torch_port.py) and
    waveform (1e-4); the port's DSP on the JAX waveform gives the JAX
    metrics bit for bit. The first utterance also shows that the noise
    is the one the JAX CLI's key draws."""
    s = setup
    over = _tiny(s['filelist'],
                 **(ONE_BUCKET if buckets == 'one bucket' else {}))
    cfg = get_config('ljspeech', **over)
    dataset = dataset_from_config(cfg, 'test')
    model = torch_model(s['params'])
    vocoder = load_vocoder(s['pt'], s['config'], 'cpu')
    context = (f64_groupnorm_statistics() if buckets == 'preset buckets'
               else contextlib.nullcontext())
    with context:
        steps = list(_jax_cli_steps(s, over, N_ITEMS))
        for i, (jitem, ref, fs, budget, noise, mel, wav, metrics) in \
                enumerate(steps):
            item = dataset[i]
            np.testing.assert_array_equal(item['x'], jitem['x'])
            np.testing.assert_array_equal(item['y'], jitem['y'])
            assert evaluate.utterance_budget(item['y'].shape[0],
                                             cfg.data.y_buckets) == budget
            assert (budget == 64) == (buckets == 'one bucket')
            got = evaluate.evaluate_utterance(
                model, vocoder, item, ref, fs, torch.from_numpy(noise),
                n_timesteps=STEPS)
            assert got.mel.shape == mel.shape
            np.testing.assert_allclose(got.mel.numpy(), mel, rtol=tol,
                                       atol=tol * np.abs(mel).max())
            assert got.waveform.dtype == np.float32
            assert got.waveform.shape == wav.shape == (mel.shape[0] * 256,)
            np.testing.assert_allclose(got.waveform, wav, rtol=0, atol=1e-4)
            assert list(got.metrics) == list(metrics)
            assert all(np.isfinite(v) for v in got.metrics.values())
            assert evaluate_pair(wav, ref, fs) == metrics
            assert set(got.seconds) == {'synthesis', 'vocoder', 'dsp'}
    if buckets == 'one bucket':
        # the first utterance through the JAX synthesize given that noise
        item, budget, noise, mel = (steps[0][k] for k in (0, 3, 4, 5))
        res = jax_synthesize(s['jmodel'], s['params'],
                             jnp.asarray(item['x'])[None],
                             jnp.asarray([item['x'].shape[0]]),
                             n_timesteps=STEPS, y_max_length=budget,
                             key=jax.random.PRNGKey(0), temperature=1.5,
                             noise=jnp.asarray(noise))
        np.testing.assert_array_equal(
            np.asarray(res.decoder_outputs[0, :int(res.y_lengths[0])]), mel)


def _cli(s, tmp_path, extra=(), preset='ljspeech', filelist=None, **over):
    """``cli.evaluate`` on the CPU with the preset narrowed to the tiny
    widths by ``--set``; returns the output directory and the config."""
    over = _tiny(filelist or s['filelist'], **over)
    out = tmp_path / 'out'
    evaluate.main(['--checkpoint', s['ckpt'], '--vocoder', s['pt'],
                   '--vocoder-config', s['config'], '--preset', preset,
                   '--n-utterances', str(N_ITEMS), '--timesteps',
                   str(STEPS), '--out-dir', str(out), '--cpu', *extra,
                   '--set', *(f'{k}={v}' for k, v in over.items())])
    return out, get_config(preset, **over)


@pytest.mark.parametrize('vocoder', ['pt', 'jax directory'])
def test_cli_is_the_utterance_function_with_seeded_noise(
        setup, vocoder, tmp_path, capsys):
    """The CLI's wavs and metrics.json are ``evaluate_utterance`` of each
    item with the noise drawn utterance by utterance from a generator
    seeded with --seed, bit for bit; a JAX vocoder directory gives what
    its .pt gives (the port reads the trainer's ``gen``); the MEAN: line
    is the file's mean, and each utterance prints its line."""
    s = setup
    extra = ['--vocoder', s['voc_dir']] if vocoder == 'jax directory' else []
    out, cfg = _cli(s, tmp_path, extra, **ONE_BUCKET)
    lines = capsys.readouterr().out.splitlines()
    saved = json.loads((out / 'metrics.json').read_text())
    mean_line = [ln for ln in lines if ln.startswith('MEAN: ')]
    assert len(mean_line) == 1
    assert json.loads(mean_line[0][len('MEAN: '):]) == saved['mean']
    assert saved['mean'] == {k: float(np.mean([r[k] for r in
                                               saved['per_utt']]))
                             for k in saved['per_utt'][0]}
    per_utt = [ln for ln in lines if re.match(r'\[\d/3\] ', ln)]
    assert len(per_utt) == N_ITEMS and all(
        'synthesis_s=' in ln and 'dsp_s=' in ln for ln in per_utt)

    dataset = dataset_from_config(cfg, 'test')
    model = torch_model(s['params'])
    voc = load_vocoder(s['pt'], s['config'], 'cpu')
    generator = torch.Generator().manual_seed(0)
    for i in range(N_ITEMS):
        item = dataset[i]
        ref, fs = load_wav(dataset.filepaths_and_text[i][0])
        budget = evaluate.utterance_budget(item['y'].shape[0],
                                           cfg.data.y_buckets)
        noise = torch.randn((1, budget, 80), generator=generator)
        want = evaluate.evaluate_utterance(model, voc, item, ref, fs, noise,
                                           n_timesteps=STEPS)
        assert saved['per_utt'][i] == want.metrics
        sr, wav = wavfile.read(out / f'eval_{i}.wav')
        assert sr == fs == 22050
        np.testing.assert_array_equal(
            wav, (want.waveform * 32767).astype(np.int16))


def test_cli_without_vocoder_config_takes_v1(setup, tmp_path):
    """Without --vocoder-config the vocoder is HiFi-GAN V1, the config the
    JAX CLI falls back to when its default path is absent (:68-71); the
    port reads no default path."""
    s = setup

    def plain(v):
        return [plain(e) for e in v] if isinstance(v, (list, tuple)) else v

    assert {k: plain(v) for k, v in vars(HiFiGANConfig()).items()} == \
        {k: plain(v) for k, v in vars(JaxHiFiGANConfig()).items()}
    from gradtts_tpu_torch.models.hifigan import Generator
    torch.manual_seed(83)
    v1 = tmp_path / 'v1.pt'
    torch.save({'generator': Generator().state_dict()}, v1)
    over = _tiny(s['filelist'], **ONE_BUCKET)
    out = tmp_path / 'out'
    evaluate.main(['--checkpoint', s['ckpt'], '--vocoder', str(v1),
                   '--n-utterances', '1', '--timesteps', str(STEPS),
                   '--out-dir', str(out), '--cpu',
                   '--set', *(f'{k}={v}' for k, v in over.items())])
    metrics = json.loads((out / 'metrics.json').read_text())['per_utt'][0]
    assert all(np.isfinite(v) for v in metrics.values())
    _, wav = wavfile.read(out / 'eval_0.wav')
    assert wav.size % 256 == 0 and wav.any()


@pytest.mark.parametrize('speaker_id', [None, 3])
def test_speakers_on_tedlium_spk(setup, speaker_id, tmp_path):
    """A tiny tedlium-spk model (16 kHz): with --speaker-id every utterance
    takes that speaker, without it each item's own; the CLI's metrics are
    ``evaluate_utterance``'s with that speaker, and its first mel is the
    JAX CLI's steps' with the JAX key's noise (1e-4 of the largest
    value)."""
    s = setup
    corpus = tmp_path / 'spk'
    corpus.mkdir()
    filelist = write_corpus(corpus, N_ITEMS, sr=16000, speakers=[5, 9, 11])
    jmodel, params = jax_model_and_params(seed=84, n_spks=675,
                                          spk_emb_dim=128)
    ckpt = str(tmp_path / 'spk.npz')
    save_params_npz(ckpt, params)
    s = {**s, 'jmodel': jmodel, 'params': params, 'ckpt': ckpt}
    out, cfg = _cli(s, tmp_path,
                    [] if speaker_id is None else
                    ['--speaker-id', str(speaker_id)], preset='tedlium-spk',
                    filelist=filelist, **ONE_BUCKET)
    saved = json.loads((out / 'metrics.json').read_text())['per_utt']
    dataset = dataset_from_config(cfg, 'test')
    model = torch_model(params, n_spks=675, spk_emb_dim=128)
    voc = load_vocoder(s['pt'], s['config'], 'cpu')
    generator = torch.Generator().manual_seed(0)
    spks = []
    for i in range(N_ITEMS):
        item = dataset[i]
        ref, fs = load_wav(dataset.filepaths_and_text[i][0])
        assert fs == 16000
        spk = evaluate.utterance_speaker(item, cfg.n_spks, speaker_id, 'cpu')
        assert spk.tolist() == [int(item['spk'][0]) if speaker_id is None
                                else speaker_id]
        spks.append(int(spk))
        noise = torch.randn((1, evaluate.utterance_budget(
            item['y'].shape[0], cfg.data.y_buckets), 80),
            generator=generator)
        want = evaluate.evaluate_utterance(model, voc, item, ref, fs, noise,
                                           n_timesteps=STEPS, spk=spk)
        assert saved[i] == want.metrics
    assert sorted(spks) == ([speaker_id] * N_ITEMS if speaker_id is not None
                            else [5, 9, 11])
    # the first utterance against the JAX CLI's steps with that speaker
    over = _tiny(filelist, **ONE_BUCKET)
    item, ref, fs, budget, noise, mel, wav, _ = next(_jax_cli_steps(
        s, over, 1, preset='tedlium-spk',
        spk_of=lambda it: (jnp.array([speaker_id]) if speaker_id is not None
                           else jnp.asarray(it['spk']).reshape(1))))
    got = evaluate.evaluate_utterance(
        model, voc, dataset[0], ref, fs, torch.from_numpy(noise),
        n_timesteps=STEPS, spk=torch.tensor([spks[0]]))
    np.testing.assert_allclose(got.mel.numpy(), mel, rtol=1e-4,
                               atol=1e-4 * np.abs(mel).max())
    np.testing.assert_allclose(got.waveform, wav, rtol=0, atol=1e-4)


def test_utterance_speaker_branches():
    """The JAX CLI's three speaker rules (:96-102): --speaker-id first,
    then the item's id for a speaker table, its vector for n_spks -1."""
    ids = {'x': np.ones(3), 'spk': np.asarray([7], np.int32)}
    vec = {'x': np.ones(3), 'spk': np.arange(4, dtype=np.float32)}
    assert evaluate.utterance_speaker(ids, 675, 2, 'cpu').tolist() == [2]
    assert evaluate.utterance_speaker(ids, 675, None, 'cpu').tolist() == [7]
    got = evaluate.utterance_speaker(vec, -1, None, 'cpu')
    assert got.shape == (1, 4) and got.dtype == torch.float32
    assert evaluate.utterance_speaker({'x': np.ones(3)}, 1, None,
                                      'cpu') is None


@pytest.mark.parametrize('nj', [1, 2])
def test_evaluate_mcd_cli_matches_jax(nj, tmp_path, capsys):
    """The CLI's utt2mcd and average against the JAX package's
    ``evaluate_mcd_dirs`` on the same directories, line for line."""
    gen, gt = tmp_path / 'gen', tmp_path / 'gt'
    gen.mkdir()
    gt.mkdir()
    fs = 16000
    t = np.arange(int(0.5 * fs)) / fs
    for i, f0 in enumerate([180.0, 240.0, 310.0]):
        for d, f in ((gt, f0), (gen, f0 * 1.02)):
            x = 0.3 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(
                4 * np.pi * f * t)
            name = f'utt{i}.wav' if d is gt else f'utt{i}_gen.wav'
            wavfile.write(str(d / name), fs, (x * 32767).astype(np.int16))
    evaluate_mcd_main([str(gen), str(gt), '--outdir', str(tmp_path / 'port'),
                       '--nj', str(nj), '--n_fft', '512', '--n_shift',
                       '256'])
    want = jax_evaluate_mcd_dirs(str(gen), str(gt),
                                 outdir=str(tmp_path / 'jax'), nj=nj,
                                 n_fft=512, n_shift=256)
    for name in ('utt2mcd', 'mcd_avg_result.txt'):
        assert (tmp_path / 'port' / name).read_text() == \
            (tmp_path / 'jax' / name).read_text()
    rows = (tmp_path / 'port' / 'utt2mcd').read_text().splitlines()
    assert [r.split()[0] for r in rows] == ['utt0', 'utt1', 'utt2']
    values = np.array(list(want.values()))
    assert f'Average: {values.mean():.4f} ± {values.std():.4f}' in \
        capsys.readouterr().out
