"""``cli.generate``: every utterance of the split is synthesized, the tail
batch padded to the batch size (after tests/test_generate_cli.py), each
batch held against the JAX package's synthesis of the batch that the JAX
CLI makes (its loader, tail padding and frame budget) with the port's
noise, at one 64-frame bucket and, with both packages' GroupNorm
statistics in f64, at the preset's buckets; wavs, plots and speaker
vectors on the tedlium preset; and ``--mesh-data`` 2 refused in one
process (the two-process run is in ``test_torch_distributed.py``)."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from _torch_port import (CMUDICT, TINY_SET, f64_groupnorm_statistics,
                         jax_model_and_params, write_corpus)
from gradtts_tpu.config import get_config as jax_get_config
from gradtts_tpu.data import dataset as jds
from gradtts_tpu.models import synthesize as jax_synthesize
from gradtts_tpu.utils.io import save_params_npz
from gradtts_tpu_torch.cli.generate import frame_budget, main, pad_batch

N_ITEMS, BATCH = 19, 8        # two full batches and a tail of 3
VOCODER = dict(resblock='1', upsample_rates=[4, 4],
               upsample_kernel_sizes=[8, 8], upsample_initial_channel=16,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]])


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    """A 19-utterance test filelist and a tiny .npz checkpoint."""
    tmp = tmp_path_factory.mktemp('gen')
    filelist = write_corpus(tmp, N_ITEMS)
    jmodel, params = jax_model_and_params(seed=51)
    ckpt = str(tmp / 'params.npz')
    save_params_npz(ckpt, params)
    return filelist, ckpt, jmodel, params


def _overrides(filelist, buckets=True):
    return [*TINY_SET, f'data.cmudict_path={CMUDICT}',
            f'data.test_filelist_path={filelist}',
            *(['data.x_buckets=(64,)', 'data.y_buckets=(64,)'] if buckets
              else [])]


def _outputs(out_dir, ext):
    return {int(b): sorted(f for f in os.listdir(os.path.join(out_dir, b))
                           if f.endswith(ext))
            for b in os.listdir(out_dir)}


def _jax_cli_batches(filelist, batch_size, **buckets):
    """The batches of the JAX CLI (gradtts_tpu/cli/generate.py:91-163):
    its loader, the tail padded with copies of its last row, and its frame
    budget, twice the y bucket, at least 64, rounded up to 4. Yields (the
    loader's batch, the padded batch, its real rows, its budget)."""
    cfg = jax_get_config('ljspeech', **{
        'data.cmudict_path': CMUDICT, 'data.test_filelist_path': filelist,
        **{f'data.{k}': v for k, v in buckets.items()}})
    loader = jds.DataLoader(jds.dataset_from_config(cfg, 'test'), batch_size,
                            jds.BatchCollate(x_buckets=cfg.data.x_buckets,
                                             y_buckets=cfg.data.y_buckets),
                            shuffle=True, seed=0, drop_last=False)
    for raw in loader:
        batch, n_real = raw, raw['x'].shape[0]
        if n_real < batch_size:
            pad = batch_size - n_real
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)],
                                       axis=0) for k, v in raw.items()}
        y_budget = max(int(2 * batch['y'].shape[1]), 64)
        y_budget += (-y_budget) % 4
        yield raw, batch, n_real, y_budget


def _hold_to_jax(out, filelist, jmodel, params, batch_size, atol,
                 **buckets):
    """Each written mel against the JAX package's synthesis of the JAX
    CLI's batch with the noise the port drew for it (``atol`` of the
    batch's largest value), after the port's padding and budget are held
    to the JAX CLI's. Returns the budgets."""
    files = _outputs(out, '.npy')
    generator = torch.Generator().manual_seed(0)
    budgets = []
    for i, (raw, batch, n_real, budget) in enumerate(
            _jax_cli_batches(filelist, batch_size, **buckets)):
        port_batch, port_real = pad_batch(raw, batch_size)
        assert port_real == n_real == len(files[i])
        assert port_batch.keys() == batch.keys()
        for k in batch:
            np.testing.assert_array_equal(port_batch[k], batch[k])
        assert frame_budget(port_batch) == budget
        budgets.append(budget)
        noise = torch.randn((batch_size, budget, 80), generator=generator)
        want = jax_synthesize(jmodel, params, jnp.asarray(batch['x']),
                              jnp.asarray(batch['x_lengths']), n_timesteps=2,
                              y_max_length=budget, key=jax.random.PRNGKey(0),
                              temperature=1.5,
                              noise=jnp.asarray(noise.numpy()))
        for j in range(n_real):
            got = np.load(out / str(i) / f'{j}.npy')
            ref = np.asarray(want.decoder_outputs[j, :int(want.y_lengths[j])])
            assert got.shape == ref.shape and np.isfinite(got).all()
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got, ref, rtol=atol,
                                       atol=atol * scale)
    return budgets


def test_generate_covers_whole_split_as_jax_synthesizes_it(split, tmp_path,
                                                           capsys):
    """19 items at batch 8: batches of 8, 8 and a padded tail of 3, every
    item written. Each batch equals the JAX package's synthesis of the
    JAX CLI's batch (same order, same padding and budget) with the noise
    the port drew for it."""
    filelist, ckpt, jmodel, params = split
    out = tmp_path / 'out'
    main(['-o', str(out), '-c', ckpt, '-t', '2', '--preset', 'ljspeech',
          '--batch-size', str(BATCH), '--cpu', '--set',
          *_overrides(filelist)])
    files = _outputs(out, '.npy')
    assert {b: len(f) for b, f in files.items()} == {0: 8, 1: 8, 2: 3}
    assert capsys.readouterr().out.count('audio-s/s') == 3
    _hold_to_jax(out, filelist, jmodel, params, BATCH, 1e-4,
                 x_buckets=(64,), y_buckets=(64,))


def test_generate_at_the_preset_buckets_as_jax_with_f64_groupnorm(
        split, tmp_path):
    """The preset's buckets, where a batch's budget (twice its mel bucket,
    at least 256 frames) is mostly padding: 5 items at batch 4, a padded
    tail of 1. With both packages' GroupNorm statistics in two-pass f64
    (``f64_groupnorm_statistics``; their single-pass f32 formula cancels
    over the padding, ~1e-3 of the largest value apart), every mel agrees
    with the JAX package's to 1e-5 of its batch's largest value."""
    _, ckpt, jmodel, params = split
    filelist = write_corpus(tmp_path, 5)
    out = tmp_path / 'out'
    with f64_groupnorm_statistics():
        main(['-o', str(out), '-c', ckpt, '-t', '2', '--preset', 'ljspeech',
              '--batch-size', '4', '--cpu', '--set',
              *_overrides(filelist, buckets=False)])
        assert {b: len(f) for b, f in _outputs(out, '.npy').items()} == {
            0: 4, 1: 1}
        budgets = _hold_to_jax(out, filelist, jmodel, params, 4, 1e-5)
    assert min(budgets) >= 256


def test_generate_tedlium_writes_wavs_and_plots(tmp_path):
    """The default preset (speaker vectors, 16 kHz) with a vocoder and
    --plots: a wav and two plots an utterance, 5 items at batch 4."""
    filelist = write_corpus(tmp_path, 5, sr=16000)
    spk = tmp_path / 'spk.npy'
    np.save(spk, np.random.default_rng(52).standard_normal(
        (5, 192)).astype(np.float32))
    _, params = jax_model_and_params(seed=53, n_spks=-1, spk_emb_dim=192)
    ckpt = tmp_path / 'params.npz'
    save_params_npz(str(ckpt), params)
    vocoder_cfg = tmp_path / 'vocoder.json'
    vocoder_cfg.write_text(json.dumps(VOCODER))
    from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    torch.manual_seed(54)
    torch.save({'generator': Generator(HiFiGANConfig.from_json(
        VOCODER)).state_dict()}, tmp_path / 'g.pt')
    out = tmp_path / 'out'
    main(['-o', str(out), '-c', str(ckpt), '-t', '2', '--batch-size', '4',
          '--vocoder', str(tmp_path / 'g.pt'), '--vocoder-config',
          str(vocoder_cfg), '--plots', '--cpu', '--set',
          *_overrides(filelist), f'data.test_spk_path={spk}'])
    wavs = _outputs(out, '.wav')
    assert {b: len(f) for b, f in wavs.items()} == {0: 4, 1: 1}
    assert not any(_outputs(out, '.npy').values())
    for b, names in wavs.items():
        for name in names:
            sr, wav = wavfile.read(out / str(b) / name)
            assert sr == 16000 and wav.dtype == np.int16 and wav.size > 0
            stem = name[:-len('.wav')]
            for suffix in ('_gen.png', '_ref.png'):
                assert (out / str(b) / (stem + suffix)).exists()


def test_generate_refuses_mesh_data(split, tmp_path, capsys):
    """--mesh-data 2 in one process: data-parallel synthesis needs two
    processes, launched by torchrun."""
    filelist, ckpt, _, _ = split
    with pytest.raises(SystemExit) as exit_info:
        main(['-o', str(tmp_path / 'out'), '-c', ckpt, '--preset',
              'ljspeech', '--mesh-data', '2', '--cpu', '--set',
              *_overrides(filelist)])
    assert exit_info.value.code == 2
    assert 'torchrun --nproc-per-node 2' in capsys.readouterr().err
    assert not (tmp_path / 'out').exists()
