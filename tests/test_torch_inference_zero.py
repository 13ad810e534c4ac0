"""``cli.inference_zero --spk-emb``: a zero-speaker model synthesizes in the
voice of a speaker vector, each text's mel equal to the JAX package's
synthesis with the vector and the noise the port drew (at the preset's
buckets with both packages' GroupNorm statistics in f64); wavs and plots;
``-s``, a vector of the wrong width and a preset without speaker vectors
are refused."""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from _torch_port import (CMUDICT, TINY_SET, f64_groupnorm_statistics,
                         jax_model_and_params, torch_model)
from gradtts_tpu.models import synthesize as jax_synthesize
from gradtts_tpu.utils.io import save_params_npz
from gradtts_tpu_torch.cli import inference_zero
from gradtts_tpu_torch.config import (bucket_length, fix_len_compatibility,
                                      get_config)
from gradtts_tpu_torch.models.tts import synthesize
from gradtts_tpu_torch.text import CMUDict, intersperse_blank, text_to_sequence
from gradtts_tpu_torch.text.symbols import symbols

TEXTS = ['Hello world.', 'A voice from a vector, on the card.']
VOCODER = dict(resblock='1', upsample_rates=[4, 4],
               upsample_kernel_sizes=[8, 8], upsample_initial_channel=16,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]])


@pytest.fixture
def tiny_preset(request, monkeypatch):
    """The CLI's presets at the tiny widths (the JAX CLI, like this one,
    has no --set), with the preset's mel buckets or, where the test asks
    for 'one bucket', one 64-frame bucket."""
    tiny = {k: int(v) for k, v in (s.split('=') for s in TINY_SET)}
    if getattr(request, 'param', None) == 'one bucket':
        tiny['data.y_buckets'] = (64,)

    def tiny_config(name):
        return get_config(name, **tiny, **{'data.cmudict_path': CMUDICT})

    monkeypatch.setattr(inference_zero, 'get_config', tiny_config)
    return tiny_config


@pytest.fixture
def inputs(tmp_path):
    texts = tmp_path / 'texts.txt'
    texts.write_text('\n'.join(TEXTS) + '\n')
    jmodel, params = jax_model_and_params(seed=61, n_spks=-1,
                                          spk_emb_dim=192)
    ckpt = tmp_path / 'params.npz'
    save_params_npz(str(ckpt), params)
    vec = np.random.default_rng(62).standard_normal(192).astype(np.float32)
    np.save(tmp_path / 'vec.npy', vec)
    return texts, ckpt, jmodel, params, vec


def _args(tmp_path, texts, ckpt, extra=()):
    return ['-f', str(texts), '-c', str(ckpt), '-o', str(tmp_path / 'out'),
            '-t', '2', '--cpu', *extra]


def _cli_inputs(cfg, cmu, texts, generator):
    """(token ids [1, Tx], their count, frame budget, noise) of each text,
    as the CLI makes them: the budget is the bucket of 10 frames a token,
    the noise drawn text by text from ``generator``."""
    for text in texts:
        ids = intersperse_blank(text_to_sequence(text, dictionary=cmu),
                                len(symbols))
        x = np.zeros((1, bucket_length(len(ids), cfg.data.x_buckets)),
                     np.int32)
        x[0, :len(ids)] = ids
        budget = fix_len_compatibility(bucket_length(10 * len(ids),
                                                     cfg.data.y_buckets))
        yield x, len(ids), budget, torch.randn((1, budget, 80),
                                               generator=generator)


def _jax_mel(jmodel, params, x, n_ids, budget, noise, vec):
    want = jax_synthesize(jmodel, params, jnp.asarray(x),
                          jnp.asarray([n_ids]), n_timesteps=2,
                          y_max_length=budget, key=jax.random.PRNGKey(0),
                          temperature=1.5, spk=jnp.asarray(vec[None]),
                          noise=jnp.asarray(noise.numpy()))
    return np.asarray(want.decoder_outputs[0, :int(want.y_lengths[0])])


@pytest.mark.parametrize('tiny_preset', ['default buckets', 'one bucket'],
                         indirect=True)
def test_spk_emb_synthesizes_as_jax(tiny_preset, inputs, tmp_path, capsys):
    """Each text's mel against the port's own synthesize with the same
    vector, budget and noise, bit for bit, and where the budget is the
    utterance's (one 64-frame bucket) against the JAX package's synthesis
    within 1e-4. With the preset's buckets the budget is mostly padding,
    and there the U-Net's GroupNorm statistics, single-pass f32
    E[x^2] - E[x]^2 over masked zeros and conv biases alike in both
    packages, cancel: the two packages part by up to ~1e-3 of the largest
    value (tools/port_gn_padding.py). The next test holds them there with
    the statistics in f64."""
    texts, ckpt, jmodel, params, vec = inputs
    inference_zero.main(_args(tmp_path, texts, ckpt,
                              ['--spk-emb', str(tmp_path / 'vec.npy')]))
    assert capsys.readouterr().out.count('RTF') == len(TEXTS)
    cfg = tiny_preset('tedlium')
    model = torch_model(params, n_spks=-1, spk_emb_dim=192)
    for i, (x, n_ids, budget, noise) in enumerate(_cli_inputs(
            cfg, CMUDict(CMUDICT), TEXTS, torch.Generator().manual_seed(0))):
        got = np.load(tmp_path / 'out' / f'mel_{i}.npy')
        port = synthesize(model, torch.from_numpy(x).long(),
                          torch.tensor([n_ids]), 2, budget,
                          temperature=1.5, noise=noise,
                          spk=torch.from_numpy(vec[None]))
        np.testing.assert_array_equal(
            got, port.decoder_outputs[0, :int(port.y_lengths[0])].numpy())
        if cfg.data.y_buckets != (64,):
            continue
        ref = _jax_mel(jmodel, params, x, n_ids, budget, noise, vec)
        assert got.shape == ref.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_spk_emb_at_the_preset_buckets_as_jax_with_f64_groupnorm(
        tiny_preset, inputs, tmp_path):
    """The CLI at the preset's buckets, where each budget is several times
    the utterance, against the JAX package's synthesis with the same
    vector, budget and noise, both packages' GroupNorm statistics in
    two-pass f64 (``f64_groupnorm_statistics``): with the cancellation of
    the f32 formula over the padding taken away, the two agree to 1e-5 of
    the largest value."""
    texts, ckpt, jmodel, params, vec = inputs
    cfg = tiny_preset('tedlium')
    with f64_groupnorm_statistics():
        inference_zero.main(_args(tmp_path, texts, ckpt,
                                  ['--spk-emb', str(tmp_path / 'vec.npy')]))
        for i, (x, n_ids, budget, noise) in enumerate(_cli_inputs(
                cfg, CMUDict(CMUDICT), TEXTS,
                torch.Generator().manual_seed(0))):
            got = np.load(tmp_path / 'out' / f'mel_{i}.npy')
            ref = _jax_mel(jmodel, params, x, n_ids, budget, noise, vec)
            assert budget >= 2 * ref.shape[0]
            assert got.shape == ref.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())


def test_spk_emb_writes_wavs_and_plots(tiny_preset, inputs, tmp_path):
    texts, ckpt, _, _, vec = inputs
    np.save(tmp_path / 'row.npy', vec[None])            # [1, D] is taken
    config = tmp_path / 'vocoder.json'
    config.write_text(json.dumps(VOCODER))
    from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    torch.manual_seed(63)
    torch.save({'generator': Generator(HiFiGANConfig.from_json(
        VOCODER)).state_dict()}, tmp_path / 'g.pt')
    inference_zero.main(_args(tmp_path, texts, ckpt, [
        '--spk-emb', str(tmp_path / 'row.npy'), '--vocoder',
        str(tmp_path / 'g.pt'), '--vocoder-config', str(config), '--plots']))
    out = tmp_path / 'out'
    for i in range(len(TEXTS)):
        sr, wav = wavfile.read(out / f'sample_{i}.wav')
        assert sr == 16000 and wav.dtype == np.int16 and wav.any()
        assert (out / f'mel_{i}.png').exists()
        assert (out / f'mu_{i}.png').exists()
        assert not (out / f'mel_{i}.npy').exists()


@pytest.mark.parametrize('case', ['speaker wav', 'both', 'neither',
                                  'wrong width', 'no speaker vectors'])
def test_refusals(case, tiny_preset, inputs, tmp_path, capsys):
    texts, ckpt, _, _, vec = inputs
    np.save(tmp_path / 'short.npy', vec[:64])
    wav = ['-s', str(tmp_path / 'speaker.wav')]
    emb = ['--spk-emb', str(tmp_path / 'vec.npy')]
    extra, message = {
        'speaker wav': (wav, '--spk-emb'),
        'both': (wav + emb, 'exactly one'),
        'neither': ([], 'exactly one'),
        'wrong width': (['--spk-emb', str(tmp_path / 'short.npy')],
                        'embedding dim 64 != config spk_emb_dim 192'),
        'no speaker vectors': (emb + ['--preset', 'ljspeech'],
                               'not zero-speaker')}[case]
    with pytest.raises(SystemExit) as exit_info:
        inference_zero.main(_args(tmp_path, texts, ckpt, extra))
    assert exit_info.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / 'out').exists()
