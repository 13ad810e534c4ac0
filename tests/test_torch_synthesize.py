"""The whole slice: the port's ``synthesize`` against the JAX package's
``synthesize(noise=)`` on the same seeded weights, text and noise, and the
port's inference CLI on a tiny ``.npz`` and a tiny ``.pt``, with each of
its sampler, speaker and vocoder flags."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from _torch_port import (TINY_SET, jax_model_and_params, seeded_tree,
                         text_batch, torch_model)
from gradtts_tpu.models import synthesize as jax_synthesize
from gradtts_tpu.models.hifigan import Generator as JaxGenerator
from gradtts_tpu.models.hifigan import HiFiGANConfig as JaxHiFiGANConfig
from gradtts_tpu.utils.io import save_params_npz
from gradtts_tpu_torch.cli.inference import main as inference_main
from gradtts_tpu_torch.models.tts import synthesize
from gradtts_tpu_torch.models.hifigan import HiFiGANConfig
from gradtts_tpu_torch.utils.convert import (flax_params_to_state_dict,
                                             hifigan_flax_to_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Y_MAX = 64


@pytest.fixture(scope='module')
def tiny():
    return jax_model_and_params(seed=5)


def test_synthesize_matches_jax(tiny):
    jmodel, params = tiny
    x, xl = text_batch(6, (16, 9))
    noise = np.random.default_rng(7).standard_normal(
        (2, Y_MAX, 80)).astype(np.float32)
    want = jax_synthesize(jmodel, params, jnp.asarray(x), jnp.asarray(xl),
                          n_timesteps=10, y_max_length=Y_MAX,
                          key=jax.random.PRNGKey(0), temperature=1.5,
                          noise=jnp.asarray(noise))
    got = synthesize(torch_model(params), torch.from_numpy(x).long(),
                     torch.from_numpy(xl), n_timesteps=10, y_max_length=Y_MAX,
                     temperature=1.5, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.y_lengths.numpy(),
                                  np.asarray(want.y_lengths))
    np.testing.assert_array_equal(got.attn.numpy(), np.asarray(want.attn))
    np.testing.assert_array_equal(got.y_mask.numpy(), np.asarray(want.y_mask))
    # mu_y copies mu_x entries through a 0/1 path: encoder tolerance
    np.testing.assert_allclose(got.encoder_outputs.numpy(),
                               np.asarray(want.encoder_outputs), rtol=1e-5,
                               atol=1e-5)
    # With random weights the score does not pull x_t towards mu, so the 10
    # Euler steps grow the mel ~100-fold; both sides grow alike and keep the
    # U-Net's ~1e-5 relative agreement, so the bound is relative to the
    # largest value.
    dec = np.asarray(want.decoder_outputs)
    scale = np.abs(dec).max()
    assert np.isfinite(dec).all() and scale > 1.0
    np.testing.assert_allclose(got.decoder_outputs.numpy(), dec, rtol=1e-4,
                               atol=1e-4 * scale)


def _cli_args(tmp_path, checkpoint, extra=()):
    texts = tmp_path / 'texts.txt'
    texts.write_text('Hello world.\nThe port runs on the card.\n')
    cmudict = os.path.join(REPO, 'resources', 'cmu_dictionary')
    return ['-f', str(texts), '-c', str(checkpoint),
            '-o', str(tmp_path / 'out'), '-t', '2', '--cpu',
            '--set', *TINY_SET, f'data.cmudict_path={cmudict}', *extra]


@pytest.mark.parametrize('fmt', ['npz', 'pt'])
def test_cli_writes_finite_mels(tiny, tmp_path, capsys, fmt):
    _, params = tiny
    ckpt = tmp_path / f'tiny.{fmt}'
    if fmt == 'npz':
        save_params_npz(str(ckpt), params)
    else:
        torch.save(flax_params_to_state_dict(params), ckpt)
    inference_main(_cli_args(tmp_path, ckpt))
    assert capsys.readouterr().out.count('RTF') == 2
    for i in range(2):
        mel = np.load(tmp_path / 'out' / f'mel_{i}.npy')
        assert mel.ndim == 2 and mel.shape[1] == 80 and mel.shape[0] > 0
        assert np.isfinite(mel).all()


VOCODER = dict(upsample_initial_channel=32)     # V1 at a tiny width


def _write_vocoder(tmp_path):
    """A JAX-initialised tiny V1 generator saved as a reference checkpoint
    (weight_g / weight_v under 'generator') and its config JSON."""
    jgen = JaxGenerator(JaxHiFiGANConfig.from_json(VOCODER))
    params = seeded_tree(jax.eval_shape(jgen.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8, 80))), 8)
    sd = {}
    for key, w in hifigan_flax_to_state_dict(
            params, HiFiGANConfig.from_json(VOCODER)).items():
        if key.endswith('.weight'):
            base = key[:-len('.weight')]
            sd[base + '.weight_v'] = 2.0 * w
            sd[base + '.weight_g'] = w.pow(2).sum(
                tuple(range(1, w.ndim)), keepdim=True).sqrt()
        else:
            sd[key] = w
    path = tmp_path / 'hifigan.pt'
    torch.save({'generator': sd}, path)
    config = tmp_path / 'hifigan.json'
    config.write_text(json.dumps(VOCODER))
    return ['--vocoder', str(path), '--vocoder-config', str(config)]


@pytest.mark.parametrize('flag', ['--vocoder', '--stoc', '--sampler dpm',
                                  '-s'])
def test_cli_runs_each_ported_flag(tiny, tmp_path, capsys, flag):
    """Each flag of the JAX CLI that the port had refused runs on the CPU
    and writes its output: -s on a tiny tedlium-spk checkpoint (a
    speaker-id preset), --vocoder a waveform from a reference-layout
    HiFi-GAN checkpoint."""
    _, params = tiny
    extra = flag.split()
    if flag == '-s':
        _, params = jax_model_and_params(seed=5, n_spks=675, spk_emb_dim=128)
        extra = ['-s', '3', '--preset', 'tedlium-spk']
    if flag == '--vocoder':
        extra = _write_vocoder(tmp_path)
    ckpt = tmp_path / 'tiny.pt'
    torch.save(flax_params_to_state_dict(params), ckpt)
    inference_main(_cli_args(tmp_path, ckpt, extra))
    assert capsys.readouterr().out.count('RTF') == 2
    for i in range(2):
        mel = np.load(tmp_path / 'out' / f'mel_{i}.npy')
        assert mel.ndim == 2 and mel.shape[1] == 80 and mel.shape[0] > 0
        assert np.isfinite(mel).all()
        wav_path = tmp_path / 'out' / f'sample_{i}.wav'
        assert wav_path.exists() == (flag == '--vocoder')
        if flag == '--vocoder':
            sr, wav = wavfile.read(wav_path)
            assert sr == 22050 and wav.dtype == np.int16
            assert wav.shape == (mel.shape[0] * 256,) and wav.any()


def test_cli_refuses_a_vocoder_directory(tiny, tmp_path):
    """A vocoder directory that holds no orbax checkpoint is refused with
    a message that says so (tests/test_torch_checkpoint.py loads one that
    the JAX vocoder trainer wrote)."""
    _, params = tiny
    ckpt = tmp_path / 'tiny.pt'
    torch.save(flax_params_to_state_dict(params), ckpt)
    (tmp_path / 'orbax_vocoder').mkdir()
    with pytest.raises(ValueError, match='unsupported checkpoint directory'):
        inference_main(_cli_args(tmp_path, ckpt, [
            '--vocoder', str(tmp_path / 'orbax_vocoder')]))


def test_cli_speaker_flag_needs_a_speaker_preset(tmp_path, capsys):
    """-s asserts a multi-speaker preset, as the JAX CLI does; such a
    preset needs -s."""
    for extra in (['-s', '0'], ['--preset', 'tedlium-spk']):
        with pytest.raises(SystemExit) as exit_info:
            inference_main(_cli_args(tmp_path, tmp_path / 'missing.pt',
                                     extra))
        assert exit_info.value.code == 2
    assert 'multispeaker' in capsys.readouterr().err
