"""Data-parallel training and synthesis of the port in two processes over
gloo on the CPU (tests/torch_dist_worker.py, started as torchrun starts
them): a W=2 train step against JAX's step on a 2-device data mesh, and
against the port's one-process step on the global batch with dropout on;
the ranks' parameters bit-equal after a step of every preset set-up and of
remat; the adaptive likelihood integrator on the two ranks' rows against
one process; ``cli.train`` on two ranks with a resume; and
``cli.generate --mesh-data 2`` against ``--mesh-data 1``. The batch puts
the long rows on rank 0 and the short ones on rank 1, so that only the
global batch's normalizers give the global losses (after
tests/test_train_parallel.py and tests/test_distributed_2proc.py)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (CMUDICT, TINY, TINY_SET, jax_model_and_params,
                         ragged_batch, text_batch, torch_model, write_corpus)
from test_torch_train import OUT_SIZE, _jax_draws
from gradtts_tpu.models.tts import compute_loss as jax_compute_loss
from gradtts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gradtts_tpu.parallel.mesh import replicated as jax_replicated
from gradtts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from gradtts_tpu.train.state import _subtree_clip
from gradtts_tpu.utils.io import save_params_npz
from gradtts_tpu_torch.cli.generate import main as generate_main
from gradtts_tpu_torch.models.tts import compute_loss
from gradtts_tpu_torch.nbest.scoring import score_batch
from gradtts_tpu_torch.train.loop import batch_to
from gradtts_tpu_torch.train.state import make_optimizer, train_step
from gradtts_tpu_torch.utils.convert import flax_params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_dist_worker.py')
SEED = 5
TOL = 1e-5          # losses (relative) and parameters (absolute)
# Adam's first update is lr * g / (|g| + eps), eps 1e-8: where |g| nears
# eps a gradient difference d moves it by up to lr * d / eps, so two f32
# steps whose gradients part by rounding (another sum order) part there by
# up to lr. The parameters are held where both gradients exceed 1e3 * eps;
# the gradients everywhere: test_torch_train.py's bound, 2e-4 of each
# tensor's largest value, plus f32 rounding (1e-6) of the model's largest
# gradient for the sums whose terms are far larger than their result (the
# ReZero gains; the encoder's key biases, whose exact gradient is zero).
ADAM_FLAT = 1e-5
GRAD_TOL, GRAD_FLOOR = 2e-4, 1e-6
TINY_CFG = {'encoder.n_enc_channels': 32, 'encoder.filter_channels': 64,
            'encoder.filter_channels_dp': 16, 'encoder.n_enc_layers': 2,
            'decoder.dec_dim': 16}
# (name, preset, overrides, remat): every speaker set-up, and remat
SETUPS = [('ljspeech', 'ljspeech', {}, False),
          ('tedlium-spk', 'tedlium-spk', {}, False),
          ('tedlium', 'tedlium', {}, False),
          ('libri-tts', 'libri-tts', {'encoder_speaker': True}, False),
          ('remat', 'ljspeech', {}, True)]
# the adaptive integrator's tolerances on the two ranks (42 evaluations
# of the tiny model), and its scores' bound: the ranks' U-Net rows part
# from one process's in the last bits, and the steps carry that on
# (test_torch_likelihood.py's bound for ~60 evaluations)
ADAPTIVE_TOL, ADAPTIVE_RTOL = 1e-1, 1e-3


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch(scenario, spec, tmp, timeout, ranks=2):
    """Runs the worker's ``scenario`` in ``ranks`` processes; returns their
    outputs. Each must exit 0 within ``timeout`` seconds."""
    path = tmp / f'{scenario}.json'
    path.write_text(json.dumps(spec))
    env = {**os.environ, 'MASTER_ADDR': '127.0.0.1',
           'MASTER_PORT': str(_free_port()), 'WORLD_SIZE': str(ranks),
           'OMP_NUM_THREADS': '1',
           'PYTHONPATH': os.pathsep.join([REPO, os.environ.get(
               'PYTHONPATH', '')])}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(path)],
        env={**env, 'RANK': str(r), 'LOCAL_RANK': str(r)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ranks)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} exited {p.returncode}:\n' \
                                  f'{out[-4000:]}'
    return outs


@pytest.fixture(scope='module')
def stepped(tmp_path_factory):
    """The worker's ``steps`` on two ranks; (tmp dir, JAX model, params,
    global batch, the JAX key)."""
    tmp = tmp_path_factory.mktemp('dp_steps')
    jmodel, params = jax_model_and_params(seed=62)
    torch.save(flax_params_to_state_dict(params), tmp / 'sd.pt')
    batch = ragged_batch(61)
    np.savez(tmp / 'batch.npz', **batch)
    key = jax.random.PRNGKey(63)
    offset, t, z = _jax_draws(key, batch['y_lengths'])
    np.savez(tmp / 'draws.npz', offset=offset, t=t, z=z)
    np.savez(tmp / 'score_batch.npz', **score_inputs())
    launch('steps', {'hp': TINY, 'out_size': OUT_SIZE, 'seed': SEED,
                     'out': str(tmp), 'state_dict': str(tmp / 'sd.pt'),
                     'batch': str(tmp / 'batch.npz'),
                     'draws': str(tmp / 'draws.npz'),
                     'setups': [[n, p, {**TINY_CFG, **o}, r]
                                for n, p, o, r in SETUPS],
                     'score': {'batch': str(tmp / 'score_batch.npz'),
                               'runs': {'adaptive': {
                                   'n_euler': 0, 'rtol': ADAPTIVE_TOL,
                                   'atol': ADAPTIVE_TOL, 'seed': SEED}}}},
           tmp, 300)
    return tmp, jmodel, params, batch, key


def score_inputs():
    """test_torch_likelihood.py's scoring batch: 2 texts, 32 frames of
    log-mel-like values, the second row 24 long."""
    x, x_lengths = text_batch(6, lengths=(16, 11))
    y = np.random.default_rng(7).standard_normal((2, 32, 80)).astype(
        np.float32) - 2.0
    y[1, 24:] = 0.0
    return {'x': x, 'x_lengths': x_lengths, 'y': y,
            'y_lengths': np.array([32, 24], np.int32)}


def assert_score_rows(got, want, rows, rtol, with_z=True):
    """A rank's ``score_batch`` result (a dict of its fields) against the
    rows ``rows`` of one process's on the global batch: the same ``nfe``
    and ``converged``; score, prior_logp and delta_logp within ``rtol``,
    and ``with_z`` z within ``rtol`` of the global batch's largest |z|."""
    assert (got['nfe'], got['converged']) == (int(want.nfe),
                                              bool(want.converged))
    for name in ('score', 'prior_logp', 'delta_logp'):
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(getattr(want, name))[rows],
                                   rtol=rtol, err_msg=name)
    if not with_z:
        return
    z = np.asarray(want.z)
    np.testing.assert_allclose(np.asarray(got['z']), z[rows], rtol=0,
                               atol=rtol * np.abs(z).max(), err_msg='z')


def _ranks(tmp, name):
    return [torch.load(tmp / f'{name}_{r}.pt', weights_only=True)
            for r in range(2)]


def _jax_dp_step(jmodel, params, batch, key):
    """JAX's clipped Adam step (train/state.py) on a 2-device data mesh,
    dropout off: (metrics, the updated params)."""
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    tx = optax.adam(1e-4)
    inner = params['params']

    def step(inner, opt_state, b):
        def loss_fn(p):
            res = jax_compute_loss(jmodel, {'params': p}, key, b['x'],
                                   b['x_lengths'], b['y'], b['y_lengths'],
                                   out_size=OUT_SIZE, train=False)
            return res.dur_loss + res.prior_loss + res.diff_loss, res
        (total, res), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            inner)
        grads, _ = _subtree_clip(grads, 1.0)
        updates, opt_state = tx.update(grads, opt_state, inner)
        return optax.apply_updates(inner, updates), grads, {
            'loss/total': total, 'loss/duration': res.dur_loss,
            'loss/prior': res.prior_loss, 'loss/diffusion': res.diff_loss}

    with mesh:
        inner = jax.device_put(inner, jax_replicated(mesh))
        new, grads, metrics = jax.jit(step)(inner, tx.init(inner),
                                            jax_shard_batch(mesh, batch))
    return ({k: float(v) for k, v in metrics.items()},
            *(flax_params_to_state_dict(jax.device_get({'params': t}))
              for t in (new, grads)))


def assert_step_close(rank, params, grads):
    """A rank's clipped gradients and parameters after the step against
    ``grads`` and ``params``: each gradient within GRAD_TOL of its
    tensor's largest value and GRAD_FLOOR of the model's, each parameter
    within TOL where both gradients are at least ADAM_FLAT."""
    largest = max(float(g.abs().max()) for g in grads.values())
    for name, w in params.items():
        got, g = rank['params'][name], grads.get(name)
        if g is None:
            torch.testing.assert_close(got, w, rtol=0, atol=TOL, msg=name)
            continue
        h = rank['grads'][name]
        bound = GRAD_TOL * float(g.abs().max()) + GRAD_FLOOR * largest
        assert float((h - g).abs().max()) <= bound, name
        steady = (g.abs() >= ADAM_FLAT) & (h.abs() >= ADAM_FLAT)
        torch.testing.assert_close(got[steady], w[steady], rtol=0, atol=TOL,
                                   msg=name)


def test_dp_step_matches_jax_data_mesh(stepped):
    """W=2, dropout off, JAX's draws fed to the port: the losses within
    1e-5 of JAX's step over the global batch on make_mesh(data=2), and the
    clipped gradients and the parameters after the step
    (:func:`assert_step_close`). The mean of the ranks' own means would
    miss the losses' bound: the ranks' lengths differ."""
    tmp, jmodel, params, batch, key = stepped
    want_metrics, want, want_grads = _jax_dp_step(jmodel, params, batch, key)
    for rank in _ranks(tmp, 'jax'):
        for k, v in want_metrics.items():
            np.testing.assert_allclose(rank['metrics'][k], v, rtol=TOL,
                                       err_msg=k)
        assert_step_close(rank, want, want_grads)
    # each rank's own mean (its own token and frame counts), averaged
    model = torch_model(params)
    offset, t, z = map(np.array, _jax_draws(key, batch['y_lengths']))
    own = []
    for rows in (slice(0, 2), slice(2, 4)):
        b = batch_to({k: v[rows] for k, v in batch.items()}, 'cpu')
        with torch.no_grad():
            res = compute_loss(model, b['x'], b['x_lengths'], b['y'],
                               b['y_lengths'], out_size=OUT_SIZE,
                               offset=torch.from_numpy(offset[rows]).long(),
                               t=torch.from_numpy(t[rows]),
                               z=torch.from_numpy(z[rows]))
        own.append(float(res.dur_loss + res.prior_loss + res.diff_loss))
    per_rank = np.mean(own)
    assert abs(per_rank - want_metrics['loss/total']) > 100 * TOL * abs(
        want_metrics['loss/total'])


def test_dp_step_with_dropout_equals_one_process(stepped):
    """W=2 with dropout on and the draws from one seeded generator: every
    rank draws the crop, t, z and the dropout masks at the global batch's
    shape and keeps its rows, so the step equals the port's one-process
    step on the global batch, masks included."""
    tmp, _, params, batch, _ = stepped
    model = torch_model(params).train()
    optimizer = make_optimizer(model.parameters())
    want = train_step(model, optimizer, batch_to(batch, 'cpu'), OUT_SIZE,
                      1.0, torch.Generator().manual_seed(SEED))
    off_model = torch_model(params)                     # eval(): no dropout
    off = train_step(off_model, make_optimizer(off_model.parameters()),
                     batch_to(batch, 'cpu'), OUT_SIZE, 1.0,
                     torch.Generator().manual_seed(SEED))
    # dropout was on: without it the same draws give another loss
    assert abs(float(off['loss/total']) - float(want['loss/total'])) > 1e-3
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    for rank in _ranks(tmp, 'dropout'):
        for k, v in want.items():
            np.testing.assert_allclose(rank['metrics'][k], float(v),
                                       rtol=TOL, err_msg=k)
        assert_step_close(rank, model.state_dict(), grads)


@pytest.mark.parametrize('setup', [s[0] for s in SETUPS])
def test_ranks_hold_bit_equal_parameters(stepped, setup):
    """After one DDP step of each preset set-up (and of remat) both ranks
    hold the same parameters bit for bit and report the same metrics;
    every parameter that needs a grad got one (so DDP runs without
    find_unused_parameters)."""
    a, b = _ranks(stepped[0], setup)
    assert a['missing'] == [] and b['missing'] == []
    assert a['metrics'] == b['metrics']
    assert all(np.isfinite(v) for v in a['metrics'].values())
    assert a['params'].keys() == b['params'].keys()
    for name, p in a['params'].items():
        assert torch.equal(p, b['params'][name]), name


def test_adaptive_score_on_two_data_ranks_takes_one_process_steps(
        stepped):
    """The adaptive Dormand-Prince ``score_batch`` on two data ranks, one
    row each (the long one and the short one), the probe drawn at the
    global shape from one seeded generator (``RowShard``): both ranks take
    the one-process attempts (``nfe``) and ``converged``, their error norm
    summed over the 'data' group, and score their rows as one process
    scores the batch within ADAPTIVE_RTOL. As in test_torch_likelihood.py's
    adaptive test, z is not held: the error estimate x5 - x4 cancels, so
    the rows' last-bit differences part the two runs' step sizes by ~1e-4
    relative, which moves z by up to ~5e-3 of its largest value."""
    tmp, _, params, _, _ = stepped
    b = batch_to(score_inputs(), 'cpu')
    want = score_batch(torch_model(params), b['x'], b['x_lengths'], b['y'],
                       b['y_lengths'], n_euler=0, rtol=ADAPTIVE_TOL,
                       atol=ADAPTIVE_TOL,
                       generator=torch.Generator().manual_seed(SEED))
    assert want.converged
    for r in range(2):
        got = torch.load(tmp / f'score_{r}.pt', weights_only=True)
        assert got['coord'] == [r, 0]
        assert_score_rows(got['adaptive'], want, slice(r, r + 1),
                          ADAPTIVE_RTOL, with_z=False)


def test_train_cli_on_two_ranks_resumes(tmp_path):
    """``cli.train --mesh-data 2`` on two ranks: two steps (equal metrics
    on both ranks), one checkpoint written once, then a resumed run from
    step 2 to 3; the ranks' parameters bit-equal."""
    filelist = write_corpus(tmp_path, n_items=8)
    log_dir = tmp_path / 'logs'
    argv = ['--cpu', '--mesh-data', '2', '--batch-size', '4',
            '--log-dir', str(log_dir), '--no-previews', '--set', *TINY_SET,
            f'data.cmudict_path={CMUDICT}',
            f'data.train_filelist_path={filelist}', 'data.x_buckets=(64,)',
            'data.y_buckets=(64,)', 'train.use_bf16_compute=False']
    outs = launch('train_cli', {'argv': argv, 'out': str(tmp_path)},
                  tmp_path, 300)
    a, b = (torch.load(tmp_path / f'train_cli_{r}.pt', weights_only=False)
            for r in range(2))
    assert [r['step'] for r in a['runs']] == [2, 3]
    assert a['runs'] == b['runs']
    assert all(np.isfinite(v) for r in a['runs']
               for v in r['metrics'].values())
    for name, p in a['params'].items():
        assert torch.equal(p, b['params'][name]), name
    assert sorted(os.listdir(log_dir / 'ckpt')) == [
        'step_00000002.pt', 'step_00000003.pt']
    assert all('resumed from step 2' in out for out in outs)
    assert all('distributed: process' in out for out in outs)
    log = (log_dir / 'train.log').read_text().splitlines()
    assert len(log) == 2 and all(ln.startswith('epoch 0:') for ln in log)


def test_generate_mesh_data_2_writes_the_one_process_files(tmp_path):
    """``cli.generate --mesh-data 2`` on two ranks (4 rows each, a tail of
    3 rows on rank 0 alone) writes the files of ``--mesh-data 1``, each mel
    within 1e-5 of its largest value."""
    filelist = write_corpus(tmp_path, 11)
    _, params = jax_model_and_params(seed=64)
    ckpt = str(tmp_path / 'params.npz')
    save_params_npz(ckpt, params)
    common = ['-c', ckpt, '--preset', 'ljspeech', '-t', '2', '--cpu',
              '--batch-size', '8', '--set', *TINY_SET,
              f'data.cmudict_path={CMUDICT}',
              f'data.test_filelist_path={filelist}', 'data.x_buckets=(64,)',
              'data.y_buckets=(64,)']
    one, two = tmp_path / 'one', tmp_path / 'two'
    generate_main(['-o', str(one), *common])
    launch('generate', {'argv': ['-o', str(two), '--mesh-data', '2',
                                 *common]}, tmp_path, 240)
    names = {b: sorted(os.listdir(one / b)) for b in os.listdir(one)}
    assert names == {'0': [f'{j}.npy' for j in range(8)],
                     '1': [f'{j}.npy' for j in range(3)]}
    assert names == {b: sorted(os.listdir(two / b)) for b in os.listdir(two)}
    for b, files in names.items():
        for f in files:
            want, got = (np.load(d / b / f) for d in (one, two))
            assert got.shape == want.shape, (b, f)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
