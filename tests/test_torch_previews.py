"""The trainer's synthesis previews: the held-out items that
``sample_test_batch`` picks (the JAX package's), ``synthesis_preview``
against the JAX package's with its noise, the PNGs ``train`` writes, and
its refusal, before the first step, where matplotlib is missing."""

import sys

import numpy as np
import pytest
import torch

import jax

from _torch_port import (CMUDICT, TINY_SET, jax_model_and_params,
                         torch_model, write_corpus)
from gradtts_tpu.config import get_config as jax_get_config
from gradtts_tpu.data import dataset as jds
from gradtts_tpu.train.loop import synthesis_preview as jax_preview
from gradtts_tpu_torch.cli.train import main as train_main
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.data import dataset as tds
from gradtts_tpu_torch.train.loop import (preview_budget, synthesis_preview,
                                          train)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp('corpus'), n_items=7,
                        speakers=[3, 1, 4, 1, 5, 0, 2])


def _datasets(kind, corpus, tmp_path):
    """The port's and the JAX package's dataset of one class."""
    if kind == 'vectors':
        spk = tmp_path / 'spk.npy'
        np.save(spk, np.random.default_rng(0).standard_normal(
            (7, 24)).astype(np.float32))
        return [m.TextMelZeroSpeakerDataset(corpus, str(spk), CMUDICT,
                                            spk_emb_dim=24)
                for m in (tds, jds)]
    cls = 'TextMelSpeakerDataset' if kind == 'ids' else 'TextMelDataset'
    return [getattr(m, cls)(corpus, CMUDICT, seed=5) for m in (tds, jds)]


@pytest.mark.parametrize('kind', ['plain', 'ids', 'vectors'])
def test_sample_test_batch_picks_the_jax_items(kind, corpus, tmp_path):
    port, ref = _datasets(kind, corpus, tmp_path)
    for seed in (0, 3):
        got, want = (d.sample_test_batch(4, seed) for d in (port, ref))
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def _jax_noise(item, n_feats=80):
    """The noise the JAX preview draws for ``item`` from PRNGKey(0)
    (models/tts.py:196-198)."""
    _, z_key, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    shape = (1, preview_budget(len(item['x'])), n_feats)
    return np.array(jax.random.normal(z_key, shape))


def test_synthesis_preview_matches_jax(corpus):
    """Two items, 10 Euler steps, the JAX noise: the alignment exactly, the
    mels at tests/test_torch_synthesize.py's bound (the steps grow the mel,
    and its error alike)."""
    jmodel, params = jax_model_and_params(seed=41)
    items = tds.TextMelDataset(corpus, CMUDICT, seed=5).sample_test_batch(2)
    want = jax_preview(jax_get_config('ljspeech'), jmodel, params, items,
                       n_timesteps=10)
    model = torch_model(params).train()
    got = synthesis_preview(get_config('ljspeech'), model, items,
                            n_timesteps=10,
                            noise=[_jax_noise(it) for it in items])
    assert model.training                     # put back as it was
    for (enc, dec, attn), (j_enc, j_dec, j_attn) in zip(got, want):
        np.testing.assert_array_equal(attn, j_attn)
        np.testing.assert_allclose(enc, j_enc, rtol=1e-5, atol=1e-5)
        scale = np.abs(j_dec).max()
        assert np.isfinite(j_dec).all() and scale > 1.0
        np.testing.assert_allclose(dec, j_dec, rtol=1e-4, atol=1e-4 * scale)


def test_synthesis_preview_draws_the_same_noise_each_call(corpus):
    """Without ``noise``, each item's draw comes from a generator seeded
    0, so every epoch's preview of an item starts from the same noise."""
    _, params = jax_model_and_params(seed=42)
    items = tds.TextMelDataset(corpus, CMUDICT, seed=5).sample_test_batch(2)
    model = torch_model(params)
    cfg = get_config('ljspeech')
    first, second = (synthesis_preview(cfg, model, items, n_timesteps=2)
                     for _ in range(2))
    noise = [torch.randn((1, preview_budget(len(it['x'])), 80),
                         generator=torch.Generator().manual_seed(0))
             for it in items]
    given = synthesis_preview(cfg, model, items, n_timesteps=2, noise=noise)
    for a, b, c in zip(first, second, given):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def _tiny_train_args(tmp_path, corpus):
    return ['--cpu', '--max-steps', '1', '--log-dir', str(tmp_path / 'logs'),
            '--batch-size', '2', '--set', *TINY_SET,
            f'data.cmudict_path={CMUDICT}',
            f'data.train_filelist_path={corpus}', 'data.x_buckets=(64,)',
            'data.y_buckets=(64,)', 'train.use_bf16_compute=False',
            'train.test_size=2']


def test_train_writes_the_previews(tmp_path):
    corpus = write_corpus(tmp_path, 4)
    assert train_main(_tiny_train_args(tmp_path, corpus)).step == 1
    logs = tmp_path / 'logs'
    for i in range(2):
        for name in ('original', 'generated_enc', 'generated_dec',
                     'alignment'):
            assert (logs / f'{name}_{i}.png').stat().st_size > 1000, name
    assert not (logs / 'original_2.png').exists()


def test_train_refuses_previews_without_matplotlib(tmp_path, monkeypatch):
    """Raised before the first step (no log written, no checkpoint);
    --no-previews trains on such a machine."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    corpus = write_corpus(tmp_path, 4)
    with pytest.raises(RuntimeError, match='matplotlib.*--no-previews'):
        train_main(_tiny_train_args(tmp_path, corpus))
    assert not (tmp_path / 'logs' / 'train.log').exists()
    assert not (tmp_path / 'logs' / 'ckpt').exists()
    res = train_main(_tiny_train_args(tmp_path, corpus) + ['--no-previews'])
    assert res.step == 1
    assert not list((tmp_path / 'logs').glob('*.png'))


def test_in_process_train_refuses_too(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    overrides = {k: int(v) for k, v in (s.split('=') for s in TINY_SET)}
    cfg = get_config('ljspeech', **overrides, **{
        'data.cmudict_path': CMUDICT, 'train.batch_size': 2,
        'data.train_filelist_path': write_corpus(tmp_path, 4),
        'data.x_buckets': (64,), 'data.y_buckets': (64,)})
    with pytest.raises(RuntimeError, match='matplotlib'):
        train(cfg, max_steps=1, log_dir=str(tmp_path / 'logs'),
              device='cpu')
    res = train(cfg, max_steps=1, log_dir=str(tmp_path / 'logs'),
                device='cpu', synthesis_every_epoch=False)
    assert res.step == 1
