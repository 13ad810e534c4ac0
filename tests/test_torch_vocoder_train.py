"""The port's HiFi-GAN training against the JAX package's, on the CPU: the
multi-period and multi-scale discriminators and the three losses on
JAX-initialised weights carried by the bridge, the vocoder dataset draw for
draw, AdamW with the staircase decay against optax, one GAN step (losses
and gradients), and ``cli.train_vocoder`` with a resume and
``cli.inference --vocoder`` on its checkpoint."""

import copy
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp
import optax

from _torch_port import CMUDICT, TINY_SET, jax_model_and_params, seeded_tree
from gradtts_tpu.data import vocoder_dataset as jvd
from gradtts_tpu.models import hifigan as jh
from gradtts_tpu.train import vocoder as jtv
from gradtts_tpu_torch.cli.inference import main as inference_main
from gradtts_tpu_torch.cli.train_vocoder import main as train_vocoder_main
from gradtts_tpu_torch.cli.train_vocoder import vocoder_loader
from gradtts_tpu_torch.data import vocoder_dataset as tvd
from gradtts_tpu_torch.data.mel import mel_spectrogram_np
from gradtts_tpu_torch.models import hifigan as th
from gradtts_tpu_torch.train import vocoder as ttv
from gradtts_tpu_torch.utils.convert import (discriminator_flax_to_state_dict,
                                             flax_params_to_state_dict,
                                             hifigan_flax_to_state_dict)

SR = 22050
# tests/test_vocoder_train.py's TINY generator (16 samples a frame) with
# the small mel analysis its GAN step uses
TINY = dict(resblock='1', upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
            upsample_initial_channel=16, resblock_kernel_sizes=[3],
            resblock_dilation_sizes=[[1, 3]], num_mels=80, sampling_rate=SR)
MEL_KW = dict(n_fft=64, hop_size=16, win_size=64)
SEGMENT = 1024


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _discriminators(seed, T):
    """(JAX module, seeded params, port module) for MPD and MSD."""
    out = []
    for k, (jmod, tmod) in enumerate(
            ((jh.MultiPeriodDiscriminator(), th.MultiPeriodDiscriminator()),
             (jh.MultiScaleDiscriminator(), th.MultiScaleDiscriminator()))):
        shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, T)), jnp.zeros((1, T)))
        params = seeded_tree(shapes, seed + k)
        tmod.load_state_dict(discriminator_flax_to_state_dict(params),
                             strict=True)
        out.append((jmod, params, tmod))
    return out


@pytest.mark.parametrize('T', [1000, 1024], ids=['padded', 'exact'])
def test_discriminators_match_jax(T):
    """Scores and every feature map within 1e-4 of each one's largest
    value (T 1000 is reflect-padded for periods 3, 7, 11)."""
    rng = np.random.default_rng(T)
    y, y_hat = (rng.uniform(-0.9, 0.9, (2, T)).astype(np.float32)
                for _ in range(2))
    for jmod, params, tmod in _discriminators(7, T):
        want = jax.jit(jmod.apply)(params, jnp.asarray(y), jnp.asarray(y_hat))
        with torch.no_grad():
            got = tmod(torch.from_numpy(y), torch.from_numpy(y_hat))
        for g_scores, w_scores in zip(got[:2], want[:2]):
            for g, w in zip(g_scores, w_scores):
                assert tuple(g.shape) == np.shape(w)
                assert _rel_err(g, w) < 1e-4
        for g_maps, w_maps in zip(got[2:], want[2:]):
            for g_disc, w_disc in zip(g_maps, w_maps):
                assert len(g_disc) == len(w_disc)
                for g, w in zip(g_disc, w_disc):
                    # NCHW / NCW against NHWC / NWC
                    g = np.moveaxis(g.numpy(), 1, -1)
                    assert g.shape == np.shape(w)
                    assert _rel_err(g, w) < 1e-4


def test_avg_pool_counts_the_padding():
    x = np.arange(1, 12, dtype=np.float32)[None]
    got = th._avg_pool1d(torch.from_numpy(x)).numpy()
    want = np.asarray(jh._avg_pool1d(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0] == pytest.approx(3 / 4)         # (0 + 0 + 1 + 2) / 4


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    scores = [rng.standard_normal((2, n)).astype(np.float32)
              for n in (5, 9, 3)]
    gen = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 3)]
    maps_r = [[rng.standard_normal((2, 4, n)).astype(np.float32)
               for n in (7, 3)] for _ in range(2)]
    maps_g = [[rng.standard_normal((2, 4, n)).astype(np.float32)
               for n in (7, 3)] for _ in range(2)]

    def t(tree):
        return [t(v) if isinstance(v, list) else torch.from_numpy(v)
                for v in tree]

    def j(tree):
        return [j(v) if isinstance(v, list) else jnp.asarray(v)
                for v in tree]

    got = th.discriminator_loss(t(scores), t(gen))
    want = jh.discriminator_loss(j(scores), j(gen))
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert float(a) == pytest.approx(float(b), rel=1e-6)
    got, want = th.generator_loss(t(gen)), jh.generator_loss(j(gen))
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
    for a, b in zip(got[1], want[1]):
        assert float(a) == pytest.approx(float(b), rel=1e-6)
    assert float(th.feature_loss(t(maps_r), t(maps_g))) == pytest.approx(
        float(jh.feature_loss(j(maps_r), j(maps_g))), rel=1e-6)


# ---- data ----------------------------------------------------------------------


def _write_wav(path, n_samples, seed):
    rng = np.random.default_rng(seed)
    wavfile.write(str(path), SR, (rng.uniform(-0.5, 0.5, n_samples)
                                  * 32767).astype(np.int16))


@pytest.fixture
def wavs(tmp_path):
    """Four wavs (two shorter than 8192 samples) and their filelist."""
    d = tmp_path / 'wavs'
    d.mkdir()
    lines = []
    for i, n in enumerate((SR, 4000, 12000, 700)):
        _write_wav(d / f'utt{i}.wav', n, seed=i)
        lines.append(f'utt{i}|some text {i}')
    filelist = tmp_path / 'train.txt'
    filelist.write_text('\n'.join(lines) + '\n')
    return str(d), str(filelist)


@pytest.mark.parametrize('mode', ['split', 'fmax_loss', 'fine_tuning'])
def test_vocoder_dataset_matches_jax(mode, wavs, tmp_path):
    wav_dir, filelist = wavs
    files = tvd.vocoder_filelists(filelist, filelist, wav_dir)
    assert files == jvd.vocoder_filelists(filelist, filelist, wav_dir)
    kw = dict(segment_size=8192, seed=5)
    if mode == 'fmax_loss':
        kw['fmax_loss'] = 9000.0
    if mode == 'fine_tuning':
        mel_dir = tmp_path / 'mels'
        mel_dir.mkdir()
        for i, path in enumerate(files[0]):
            audio = tvd.load_wav(path)[0]
            mel = mel_spectrogram_np(audio[None])[0].T       # [M, F]
            np.save(mel_dir / f'utt{i}.npy', mel[None] if i % 2 else mel)
        kw.update(fine_tuning=True, base_mels_path=str(mel_dir))
    port = tvd.VocoderMelDataset(files[0], **kw)
    ref = jvd.VocoderMelDataset(files[0], **kw)
    assert port.audio_files == ref.audio_files
    frames = 8192 // 256
    for _ in range(2):               # second pass: new crop draws
        for i in range(len(port)):
            got, want = port[i], ref[i]
            for k in ('mel', 'audio', 'mel_loss'):
                assert got[k].shape == ((8192,) if k == 'audio'
                                        else (frames, 80))
                np.testing.assert_array_equal(got[k], want[k])
    batch = tvd.VocoderBatchCollate()([port[0], port[1]])
    assert batch['audio'].shape == (2, 8192)
    assert batch['mel'].shape == batch['mel_loss'].shape == (2, frames, 80)


# ---- optimizer and GAN step ----------------------------------------------------


def test_optimizer_matches_optax_across_a_staircase_boundary():
    rng = np.random.default_rng(8)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32)
             for _ in range(5)]
    tx = jtv.make_vocoder_optimizer(2e-4, lr_decay=0.5, steps_per_epoch=2)
    jp, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = ttv.make_vocoder_optimizer([p], 2e-4, lr_decay=0.5,
                                            steps_per_epoch=2)
    lrs = []
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        lrs.append(opt.param_groups[0]['lr'])
        p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-6 * np.abs(p0).max())
    np.testing.assert_allclose(lrs, 2e-4 * np.array([1, 1, .5, .5, .25]),
                               rtol=1e-12)


def _recording(inner):
    """An optax transformation that runs ``inner`` and keeps the last
    gradients in its state."""
    def init(params):
        return inner.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                          params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)

    return optax.GradientTransformation(init, update)


def _gan_batch(seed, batch=2):
    audio = np.random.default_rng(seed).uniform(
        -0.9, 0.9, (batch, SEGMENT)).astype(np.float32)
    mel = mel_spectrogram_np(audio, num_mels=80, sampling_rate=SR, **MEL_KW)
    return {'mel': mel, 'audio': audio, 'mel_loss': mel}


def _port_state(cfg, gen_params, mpd_params, msd_params):
    state = ttv.init_vocoder_state(cfg, 'cpu', steps_per_epoch=10)
    state.generator.load_state_dict(
        hifigan_flax_to_state_dict(gen_params, cfg), strict=True)
    state.mpd.load_state_dict(discriminator_flax_to_state_dict(mpd_params),
                              strict=True)
    state.msd.load_state_dict(discriminator_flax_to_state_dict(msd_params),
                              strict=True)
    return state


def test_gan_step_matches_jax():
    """One step from the same weights and batch: the seven losses within
    1e-4 relative, each discriminator and generator gradient within 1e-3
    of its leaf's largest value, and the updated generator."""
    jcfg = jh.HiFiGANConfig.from_json(TINY)
    cfg = th.HiFiGANConfig.from_json(dict(TINY, **MEL_KW))
    gen_opt = _recording(jtv.make_vocoder_optimizer(2e-4, steps_per_epoch=10))
    disc_opt = _recording(jtv.make_vocoder_optimizer(2e-4,
                                                     steps_per_epoch=10))
    shapes = jax.eval_shape(
        lambda k: jtv.init_vocoder_state(k, jcfg, SEGMENT, gen_opt,
                                         disc_opt), jax.random.PRNGKey(0))
    gen_params = seeded_tree(shapes.gen_params, 11)
    mpd_params = seeded_tree(shapes.mpd_params, 12)
    msd_params = seeded_tree(shapes.msd_params, 13)
    jstate = jtv.init_vocoder_state(jax.random.PRNGKey(0), jcfg, SEGMENT,
                                    gen_opt, disc_opt, gen_params=gen_params)
    jstate = jstate._replace(mpd_params=mpd_params, msd_params=msd_params)
    batch = _gan_batch(14)
    step = jax.jit(jtv.make_vocoder_train_step(jcfg, gen_opt, disc_opt,
                                               **MEL_KW))
    jstate, want = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    state = _port_state(cfg, gen_params, mpd_params, msd_params)
    got = ttv.make_vocoder_train_step(cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == set(ttv.METRICS)
    for k in ttv.METRICS:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), k
    assert state.step == int(jstate.step) == 1

    d_grads = jstate.disc_opt[1]
    for module, tree in ((state.mpd, d_grads['mpd']),
                         (state.msd, d_grads['msd'])):
        want_grads = discriminator_flax_to_state_dict(tree)
        for name, p in module.named_parameters():
            w = want_grads[name].numpy()
            assert np.abs(w).max() > 0, name
            assert _rel_err(p.grad.numpy(), w) < 1e-3, name
    want_grads = hifigan_flax_to_state_dict(jstate.gen_opt[1], cfg)
    for name, p in state.generator.named_parameters():
        assert _rel_err(p.grad.numpy(), want_grads[name].numpy()) < 1e-3, name
    want_gen = hifigan_flax_to_state_dict(jstate.gen_params, cfg)
    for name, p in state.generator.named_parameters():
        w = want_gen[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


def test_gan_step_runs_and_learns():
    """tests/test_vocoder_train.py::test_gan_train_step_runs_and_learns on
    the port: two steps, finite losses, the generator moves, and the
    generator's backward leaves the discriminators' gradients alone: they
    are those of the discriminator loss at the step's own weights."""
    cfg = th.HiFiGANConfig.from_json(dict(TINY, **MEL_KW))
    state = ttv.init_vocoder_state(cfg, 'cpu', steps_per_epoch=10, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _gan_batch(0).items()}
    step = ttv.make_vocoder_train_step(cfg)
    before = next(state.generator.parameters()).detach().clone()
    metrics = step(state, batch)
    generator, mpd, msd = (copy.deepcopy(m) for m in
                           (state.generator, state.mpd, state.msd))
    metrics = step(state, batch)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert state.step == 2
    assert not torch.equal(before, next(state.generator.parameters()))
    assert float(metrics['loss/gen_mel']) > 0
    assert all(p.requires_grad for p in state.mpd.parameters())
    for module in (mpd, msd):
        module.zero_grad()
    with torch.no_grad():
        y_g = generator(batch['mel'])
    for got, module in ((state.mpd, mpd), (state.msd, msd)):
        real, fake, _, _ = module(batch['audio'], y_g)
        th.discriminator_loss(real, fake)[0].backward()
        for (name, p), want in zip(got.named_parameters(),
                                   module.parameters()):
            assert want.grad.abs().max() > 0, name
            torch.testing.assert_close(p.grad, want.grad, rtol=0,
                                       atol=1e-6 * float(want.grad.abs().max()))


def test_vocoder_loader_draws_new_crops_each_epoch(wavs):
    """The CLI's loader caches no item: each epoch crops the wavs longer
    than the segment (three of the four) anew."""
    wav_dir, filelist = wavs
    files = tvd.vocoder_filelists(filelist, filelist, wav_dir)[0]
    loader = vocoder_loader(tvd.VocoderMelDataset(files, segment_size=SEGMENT,
                                                  seed=5), 4, seed=5)
    epochs = [{row.tobytes() for row in batch['audio']}
              for _ in range(2) for batch in loader]
    assert len(epochs) == 2 and len(epochs[0]) == 4
    assert len(epochs[1] - epochs[0]) == 3


# ---- the CLI -------------------------------------------------------------------


def test_train_vocoder_cli_resumes_and_inference_reads_its_checkpoint(
        wavs, tmp_path, capsys):
    wav_dir, filelist = wavs
    config = tmp_path / 'tiny.json'
    config.write_text(json.dumps(dict(TINY, **MEL_KW)))
    log_dir = tmp_path / 'logs'
    args = ['--input-wavs-dir', wav_dir, '--input-training-file', filelist,
            '--log-dir', str(log_dir), '--config', str(config),
            '--batch-size', '2', '--segment-size', str(SEGMENT),
            '--epochs', '1', '--max-steps', '1', '--cpu']
    assert train_vocoder_main(args).step == 1
    resumed = train_vocoder_main(args)
    assert resumed.step == 2
    assert sorted(os.listdir(log_dir / 'ckpt')) == ['step_00000001.pt',
                                                    'step_00000002.pt']
    assert resumed.gen_opt.state_dict()['state'][0]['step'] == 2
    text = (log_dir / 'train.log').read_text()
    assert text.count('epoch 0:') == 2 and 'loss/gen_mel=' in text
    ckpt = log_dir / 'ckpt' / 'step_00000002.pt'
    sd = torch.load(ckpt, map_location='cpu', weights_only=True)
    assert set(sd) == {'step', 'generator', 'mpd', 'msd', 'gen_opt',
                       'disc_opt', 'gen_sched', 'disc_sched'}

    _, params = jax_model_and_params(seed=2)
    acoustic = tmp_path / 'tiny.pt'
    torch.save(flax_params_to_state_dict(params), acoustic)
    texts = tmp_path / 'texts.txt'
    texts.write_text('Hello world.\n')
    inference_main(['-f', str(texts), '-c', str(acoustic), '-o',
                    str(tmp_path / 'out'), '-t', '2', '--cpu', '--vocoder',
                    str(ckpt), '--vocoder-config', str(config), '--set',
                    *TINY_SET, f'data.cmudict_path={CMUDICT}'])
    mel = np.load(tmp_path / 'out' / 'mel_0.npy')
    sr, wav = wavfile.read(tmp_path / 'out' / 'sample_0.wav')
    assert sr == SR and wav.shape == (mel.shape[0] * 16,)
    assert 'RTF' in capsys.readouterr().out


def test_train_vocoder_cli_fine_tunes_from_a_generator(wavs, tmp_path):
    """--init-generator reads a reference checkpoint's weights: after one
    AdamW step (each weight moves by about the learning rate, 2e-4) the
    generator is still the given one, not the seeded draw."""
    wav_dir, filelist = wavs
    cfg = th.HiFiGANConfig.from_json(dict(TINY, **MEL_KW))
    config = tmp_path / 'tiny.json'
    config.write_text(json.dumps(dict(TINY, **MEL_KW)))
    # drawn from a seed of its own (init_vocoder_state draws from 1234),
    # not from whatever state the tests before it left the global
    # generator in: a one-value bias drawn so came within 0.0051 of the
    # seeded draw's
    torch.manual_seed(0)
    init = th.Generator(cfg).state_dict()
    torch.save({'generator': init}, tmp_path / 'g.pt')
    state = train_vocoder_main([
        '--input-wavs-dir', wav_dir, '--input-training-file', filelist,
        '--log-dir', str(tmp_path / 'logs'), '--config', str(config),
        '--batch-size', '2', '--segment-size', str(SEGMENT), '--epochs',
        '1', '--max-steps', '1', '--cpu', '--init-generator',
        str(tmp_path / 'g.pt')])
    seeded = ttv.init_vocoder_state(cfg, 'cpu', 1).generator.state_dict()
    for name, w in state.generator.state_dict().items():
        assert (w - init[name]).abs().max() < 1e-3, name
        assert (seeded[name] - init[name]).abs().max() > 1e-2, name


@pytest.mark.skipif(torch.cuda.is_available(), reason='a GPU is present')
def test_train_vocoder_cli_without_cpu_flag_raises_without_gpu(wavs,
                                                               tmp_path):
    wav_dir, filelist = wavs
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_vocoder_main(['--input-wavs-dir', wav_dir,
                            '--input-training-file', filelist,
                            '--log-dir', str(tmp_path / 'logs')])
    assert not (tmp_path / 'logs').exists()
