"""Checkpoints in and out of the port: the orbax directories that the JAX
package's trainers write, read with tensorstore alone (no orbax, no JAX),
and ``.npz`` param trees written by the port that the JAX package loads
to the same synthesis."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp

from _torch_port import (CMUDICT, TINY_SET, jax_model_and_params,
                         seeded_tree, text_batch, torch_model)
from gradtts_tpu.cli.train_vocoder import _ckpt_payload
from gradtts_tpu.models import synthesize as jax_synthesize
from gradtts_tpu.models.hifigan import Generator as JaxGenerator
from gradtts_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from gradtts_tpu.models.hifigan import (MultiPeriodDiscriminator,
                                        MultiScaleDiscriminator)
from gradtts_tpu.train.checkpoint import save_checkpoint
from gradtts_tpu.train.state import TrainState
from gradtts_tpu.train.vocoder import VocoderTrainState
from gradtts_tpu.utils.io import load_params_npz as jax_load_params_npz
from gradtts_tpu_torch.cli.inference import main as inference_main
from gradtts_tpu_torch.cli.train_vocoder import main as train_vocoder_main
from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from gradtts_tpu_torch.models.tts import synthesize
from gradtts_tpu_torch.utils.convert import (flax_params_to_state_dict,
                                             load_checkpoint,
                                             load_vocoder_checkpoint,
                                             state_dict_to_flax_params)
from gradtts_tpu_torch.utils.io import (load_params_npz,
                                        read_orbax_checkpoint,
                                        save_params_npz)

# a V1 generator at a tiny width, 16 samples a frame
VOCODER = dict(resblock='1', upsample_rates=[4, 4],
               upsample_kernel_sizes=[8, 8], upsample_initial_channel=16,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
               n_fft=64, hop_size=16, win_size=64)


def _assert_trees_equal(got, want):
    """Equal structure (dicts, lists, None) and bit-equal arrays."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    elif want is None:
        assert got is None
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope='module')
def acoustic(tmp_path_factory):
    """(params, checkpoint directory) of a tiny GradTTS saved by the JAX
    trainer's save_checkpoint at steps 3 and 7, with its Adam state and
    PRNG key."""
    _, params = jax_model_and_params(seed=11)
    ckpt_dir = str(tmp_path_factory.mktemp('orbax') / 'ckpt')
    opt_state = optax.adam(1e-4).init(params['params'])
    for step in (3, 7):
        save_checkpoint(ckpt_dir, TrainState(np.int32(step), params,
                                             opt_state), step,
                        key=np.asarray(jax.random.PRNGKey(step)))
    return params, ckpt_dir


def test_reader_matches_orbax(acoustic):
    """The tensorstore reader gives orbax's own untyped restore, leaf for
    leaf: step, params, the Adam state (a list, as orbax gives a tuple
    back) and the key."""
    _, ckpt_dir = acoustic
    step_dir = os.path.join(ckpt_dir, 'step_00000007')
    got = read_orbax_checkpoint(step_dir)
    _assert_trees_equal(got, ocp.PyTreeCheckpointer().restore(step_dir))
    assert int(got['step']) == 7


@pytest.mark.parametrize('which', ['step', 'parent'])
def test_load_checkpoint_reads_an_acoustic_directory(acoustic, which):
    """From the step directory, and from its parent (the latest step)."""
    params, ckpt_dir = acoustic
    path = (os.path.join(ckpt_dir, 'step_00000007') if which == 'step'
            else ckpt_dir)
    assert int(read_orbax_checkpoint(path)['step']) == 7
    _assert_state_dicts_equal(load_checkpoint(path),
                              flax_params_to_state_dict(params))


def _cli_args(tmp_path, checkpoint, out, extra=()):
    texts = tmp_path / 'texts.txt'
    texts.write_text('Hello world.\nThe port reads the JAX checkpoints.\n')
    return ['-f', str(texts), '-c', str(checkpoint), '-o', str(out), '-t',
            '2', '--cpu', '--set', *TINY_SET, f'data.cmudict_path={CMUDICT}',
            *extra]


def test_inference_cli_takes_an_orbax_directory(acoustic, tmp_path):
    """``cli.inference -c DIR`` synthesizes what ``-c x.pt`` of the same
    weights does, bit for bit, with the same seed."""
    params, ckpt_dir = acoustic
    pt = tmp_path / 'tiny.pt'
    torch.save(flax_params_to_state_dict(params), pt)
    for name, ckpt in (('dir', ckpt_dir), ('pt', pt)):
        inference_main(_cli_args(tmp_path, ckpt, tmp_path / name))
    for i in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / 'dir' / f'mel_{i}.npy'),
            np.load(tmp_path / 'pt' / f'mel_{i}.npy'))


@pytest.fixture(scope='module')
def vocoder(tmp_path_factory):
    """(generator params, checkpoint directory) as the JAX vocoder trainer
    saves them (``_ckpt_payload``: params {'gen', 'mpd', 'msd'}), with
    seeded weights at the tiny width."""
    cfg = JaxHiFiGANConfig.from_json(VOCODER)
    gen = seeded_tree(jax.eval_shape(JaxGenerator(cfg).init,
                                     jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8, 80))), 21)
    wav = jnp.zeros((1, 256))
    mpd, msd = (seeded_tree(jax.eval_shape(d().init, jax.random.PRNGKey(0),
                                           wav, wav), 22 + k)
                for k, d in enumerate((MultiPeriodDiscriminator,
                                       MultiScaleDiscriminator)))
    opt = optax.adamw(2e-4)
    state = VocoderTrainState(
        step=np.int32(5), gen_params=gen, mpd_params=mpd, msd_params=msd,
        gen_opt=opt.init(gen['params']),
        disc_opt=opt.init({'mpd': mpd['params'], 'msd': msd['params']}))
    ckpt_dir = str(tmp_path_factory.mktemp('orbax_vocoder') / 'ckpt')
    save_checkpoint(ckpt_dir, _ckpt_payload(state), 5)
    return gen, ckpt_dir


def test_vocoder_directory_matches_jax_generator(vocoder):
    gen, ckpt_dir = vocoder
    cfg = HiFiGANConfig.from_json(VOCODER)
    model = Generator(cfg)
    model.load_state_dict(load_vocoder_checkpoint(ckpt_dir, cfg),
                          strict=True)
    mel = np.random.default_rng(3).standard_normal((1, 24, 80)).astype(
        np.float32) - 4.0
    want = np.asarray(JaxGenerator(JaxHiFiGANConfig.from_json(VOCODER)).apply(
        gen, jnp.asarray(mel)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 24 * 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_inference_cli_takes_a_vocoder_directory(acoustic, vocoder,
                                                 tmp_path):
    params, _ = acoustic
    _, voc_dir = vocoder
    pt = tmp_path / 'tiny.pt'
    torch.save(flax_params_to_state_dict(params), pt)
    config = tmp_path / 'vocoder.json'
    config.write_text(json.dumps(VOCODER))
    inference_main(_cli_args(tmp_path, pt, tmp_path / 'out', [
        '--vocoder', voc_dir, '--vocoder-config', str(config)]))
    for i in range(2):
        mel = np.load(tmp_path / 'out' / f'mel_{i}.npy')
        sr, wav = wavfile.read(tmp_path / 'out' / f'sample_{i}.wav')
        assert sr == 22050 and wav.dtype == np.int16
        assert wav.shape == (mel.shape[0] * 16,) and wav.any()


@pytest.mark.parametrize('kind', ['acoustic', 'vocoder'])
def test_a_directory_of_the_other_trainer_is_refused(acoustic, vocoder,
                                                     kind):
    cfg = HiFiGANConfig.from_json(VOCODER)
    if kind == 'acoustic':
        with pytest.raises(ValueError, match='vocoder checkpoint'):
            load_checkpoint(vocoder[1])
    else:
        with pytest.raises(ValueError, match='not a vocoder checkpoint'):
            load_vocoder_checkpoint(acoustic[1], cfg)


def test_train_vocoder_fine_tunes_from_a_vocoder_directory(vocoder,
                                                           tmp_path):
    """--init-generator DIR: after one AdamW step (each weight moves by
    about the learning rate, 2e-4) the generator is still the directory's,
    not the seeded draw."""
    _, voc_dir = vocoder
    cfg = HiFiGANConfig.from_json(VOCODER)
    config = tmp_path / 'vocoder.json'
    config.write_text(json.dumps(VOCODER))
    wav_dir = tmp_path / 'wavs'
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        wavfile.write(str(wav_dir / f'utt{i}.wav'), 22050, (rng.uniform(
            -0.5, 0.5, 3000) * 32767).astype(np.int16))
    filelist = tmp_path / 'train.txt'
    filelist.write_text('utt0|a\nutt1|b\n')
    state = train_vocoder_main([
        '--input-wavs-dir', str(wav_dir), '--input-training-file',
        str(filelist), '--log-dir', str(tmp_path / 'logs'), '--config',
        str(config), '--batch-size', '2', '--segment-size', '1024',
        '--epochs', '1', '--max-steps', '1', '--cpu', '--init-generator',
        voc_dir])
    init = load_vocoder_checkpoint(voc_dir, cfg)
    seeded = Generator(cfg).state_dict()
    for name, w in state.generator.state_dict().items():
        assert (w - init[name]).abs().max() < 1e-3, name
    assert max(float((seeded[k] - init[k]).abs().max()) for k in init) > 1e-2


def test_reader_without_tensorstore_names_the_npz_route(acoustic,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, 'tensorstore', None)
    with pytest.raises(ImportError, match=r'tensorstore.*\.npz'):
        read_orbax_checkpoint(acoustic[1])


# ---- .npz export ------------------------------------------------------------

SETUPS = {'one speaker': {}, 'speaker ids': dict(n_spks=5, spk_emb_dim=16),
          'speaker vectors': dict(n_spks=-1, spk_emb_dim=24),
          'encoder speaker': dict(n_spks=5, spk_emb_dim=16,
                                  encoder_speaker=True)}


@pytest.mark.parametrize('setup', list(SETUPS))
def test_state_dict_to_flax_params_inverts_the_bridge(setup):
    """Every speaker set-up: the state_dict goes back to the JAX tree bit
    for bit, leaf for leaf, and through .npz files both ways."""
    _, params = jax_model_and_params(seed=12, **SETUPS[setup])
    back = state_dict_to_flax_params(flax_params_to_state_dict(params))
    _assert_trees_equal(back, jax.tree_util.tree_map(np.asarray, params))


def test_npz_export_round_trips_and_jax_synthesizes_it(tmp_path):
    """A port checkpoint exported to .npz: the port reads back the same
    state_dict, and the JAX package's load_params_npz + synthesize gives
    the port's synthesis (tests/test_torch_synthesize.py's bound)."""
    jmodel, params = jax_model_and_params(seed=13)
    model = torch_model(params)
    path = str(tmp_path / 'export.npz')
    save_params_npz(path, state_dict_to_flax_params(model.state_dict()))
    _assert_state_dicts_equal(load_checkpoint(path), model.state_dict())
    _assert_trees_equal(load_params_npz(path), jax_load_params_npz(path))

    x, xl = text_batch(14, (16, 9))
    y_max = 64
    noise = np.random.default_rng(15).standard_normal(
        (2, y_max, 80)).astype(np.float32)
    want = jax_synthesize(jmodel, jax_load_params_npz(path), jnp.asarray(x),
                          jnp.asarray(xl), n_timesteps=10, y_max_length=y_max,
                          key=jax.random.PRNGKey(0), temperature=1.5,
                          noise=jnp.asarray(noise))
    got = synthesize(model, torch.from_numpy(x).long(), torch.from_numpy(xl),
                     n_timesteps=10, y_max_length=y_max, temperature=1.5,
                     noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.y_lengths.numpy(),
                                  np.asarray(want.y_lengths))
    dec = np.asarray(want.decoder_outputs)
    scale = np.abs(dec).max()
    assert np.isfinite(dec).all() and scale > 1.0
    np.testing.assert_allclose(got.decoder_outputs.numpy(), dec, rtol=1e-4,
                               atol=1e-4 * scale)
