"""Tensor parallelism of the port over the mesh's 'model' axis, on the CPU:
the split rule against the JAX package's ``param_pspec`` leaf for leaf;
the three collectives of ``parallel.tensor`` on two gloo ranks; the plain
GroupNorm+Mish of a channel block; a train step on 2 ranks (data 1 x
model 2) and on 4 (data 2 x model 2) against JAX's step on the same mesh
and against the port's one-process step; likelihood scoring on the same
ranks (forward mode through the split layers) against the port's one
process and JAX's ``score_batch`` on its mesh; and ``cli.train
--mesh-model 2`` with checkpoints that move between two ranks and one
process. The ranks run tests/torch_dist_worker.py, as in
tests/test_torch_distributed.py, whose bounds these tests keep."""

import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (CMUDICT, TINY, TINY_SET, jax_model_and_params,
                         ragged_batch, torch_model, write_corpus)
from test_torch_distributed import (ADAM_FLAT, GRAD_FLOOR, GRAD_TOL, SEED,
                                    TOL, assert_score_rows,
                                    assert_step_close, launch)
from test_torch_likelihood import _jax_probe
from test_torch_train import OUT_SIZE, _jax_draws
from gradtts_tpu import get_config as jax_get_config
from gradtts_tpu.models import GradTTS as JaxGradTTS
from gradtts_tpu.models.tts import compute_loss as jax_compute_loss
from gradtts_tpu.nbest.scoring import score_batch as jax_score_batch
from gradtts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gradtts_tpu.parallel.mesh import param_pspec, param_shardings
from gradtts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from gradtts_tpu.train.state import _subtree_clip
from gradtts_tpu_torch.cli.train import main as train_main
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.tts import GradTTS
from gradtts_tpu_torch.nbest.scoring import score_batch
from gradtts_tpu_torch.ops.groupnorm_mish import groupnorm_mish_plain
from gradtts_tpu_torch.parallel.mesh import split_dim
from gradtts_tpu_torch.train.loop import batch_to
from gradtts_tpu_torch.train.state import make_optimizer, train_step
from gradtts_tpu_torch.utils.convert import (flax_params_to_state_dict,
                                             flax_path, gather_state_dict,
                                             shard_state_dict)

# every preset set-up of test_torch_distributed.py
PRESETS = [('ljspeech', {}), ('tedlium-spk', {}), ('tedlium', {}),
           ('libri-tts', {'encoder_speaker': True})]
MODEL = 2                   # the 'model' axis of the step tests
SCORE_STEPS = 2             # Euler steps of the scoring tests, as
                            # __graft_entry__.py:165 scores on its mesh


# ---- (a) the split rule -----------------------------------------------------

@pytest.fixture(scope='module')
def jax_trees():
    """{preset: its JAX param tree's leaf shapes at full width}, each
    leaf keyed by its path of names, the path itself for param_pspec."""
    cache = {}

    def tree(preset, overrides):
        if preset not in cache:
            cfg = jax_get_config(preset, **overrides)
            model = JaxGradTTS.from_config(cfg)
            spk = (jnp.zeros((1,), jnp.int32) if cfg.n_spks > 1 else
                   jnp.zeros((1, cfg.spk_emb_dim)) if cfg.n_spks == -1
                   else None)
            shapes = jax.eval_shape(
                model.init, jax.random.PRNGKey(0), jnp.ones((1, 8),
                                                            jnp.int32),
                jnp.array([8]), jnp.zeros((1, 16, cfg.data.n_feats)),
                jnp.array([16]), spk)['params']
            leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
            cache[preset] = {tuple(k.key for k in path): (path, leaf)
                             for path, leaf in leaves}
        return cache[preset]
    return tree


@pytest.mark.parametrize('size', [1, 2, 4])
@pytest.mark.parametrize('preset,overrides', PRESETS,
                         ids=[p for p, _ in PRESETS])
def test_split_rule_equals_param_pspec(jax_trees, preset, overrides, size):
    """``split_dim`` splits exactly the leaves that ``param_pspec`` shards
    over 'model' (names through the weight bridge), torch's dim 0 being
    the kernel's last axis; at full ljspeech width and M=2, 91 tensors and
    8,202,968 parameter elements a rank."""
    leaves = jax_trees(preset, overrides)
    with torch.device('meta'):
        model = GradTTS.from_config(get_config(preset, **overrides))
    named = dict(model.named_parameters())
    assert len(named) == len(leaves)
    split, elements = 0, 0
    for name, p in named.items():
        path, _ = flax_path(name)
        jax_path, leaf = leaves[path]
        spec = param_pspec(jax_path, leaf, size)
        dim = split_dim(name, p.shape, size)
        assert (dim is not None) == ('model' in tuple(spec)), name
        if dim is not None:
            assert tuple(spec)[-1] == 'model' and dim == 0, name
            assert p.shape[0] == leaf.shape[-1], name
            split += 1
        elements += p.numel() // (size if dim is not None else 1)
    if size == 1:
        assert split == 0
    if (preset, size) == ('ljspeech', 2):
        assert (split, elements) == (91, 8_202_968)


def test_state_dict_blocks_round_trip():
    """``shard_state_dict`` of JAX params gives each rank its blocks of the
    split tensors (the rest whole), and ``gather_state_dict`` of the
    blocks is the full state dict, bit for bit."""
    _, params = jax_model_and_params(seed=70)
    sd = flax_params_to_state_dict(params)
    blocks = [shard_state_dict(sd, j, MODEL) for j in range(MODEL)]
    n_split = 0
    for name, w in sd.items():
        if split_dim(name, w.shape, MODEL) is None:
            assert all(b[name] is w for b in blocks)
        else:
            n_split += 1
            n = w.shape[0] // MODEL
            for j, b in enumerate(blocks):
                assert torch.equal(b[name], w[j * n:(j + 1) * n]), name
    assert n_split > 0
    whole = gather_state_dict(blocks)
    assert whole.keys() == sd.keys()
    assert all(torch.equal(whole[k], v) for k, v in sd.items())


# ---- (c) K1's plain version on a channel block ------------------------------

@pytest.mark.parametrize('channels,size', [(16, 2), (64, 2), (128, 2),
                                           (64, 4)])
def test_groupnorm_mish_of_a_block_is_the_block_of_the_whole(channels, size):
    """GroupNorm statistics are per group: the plain GroupNorm+Mish of
    channel block j with groups / M groups equals block j of the whole's,
    within f32 rounding of the sums."""
    rng = np.random.default_rng(channels + size)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, channels),
                                             np.float32) * 2 + 0.5)
    mask = (torch.arange(7)[None, None, :, None]
            < torch.tensor([7, 4])[:, None, None, None]).float()
    gamma, beta = (torch.from_numpy(rng.standard_normal(channels,
                                                        np.float32))
                   for _ in range(2))
    whole = groupnorm_mish_plain(x, mask, gamma, beta, 8)
    n = channels // size
    for j in range(size):
        c = slice(j * n, (j + 1) * n)
        got = groupnorm_mish_plain(x[..., c].contiguous(), mask, gamma[c],
                                   beta[c], 8 // size)
        torch.testing.assert_close(got, whole[..., c], rtol=0, atol=1e-6)


# ---- (b), (d) the Functions and the train step on gloo ranks ----------------

@pytest.fixture(scope='module')
def start(tmp_path_factory):
    """The tiny model's weights, the global batch of 4, JAX's draws and
    the Hutchinson probe that JAX's ``score_batch`` draws from ``key``."""
    tmp = tmp_path_factory.mktemp('tp')
    jmodel, params = jax_model_and_params(seed=72)
    torch.save(flax_params_to_state_dict(params), tmp / 'sd.pt')
    batch = ragged_batch(73)
    np.savez(tmp / 'batch.npz', **batch)
    key = jax.random.PRNGKey(74)
    offset, t, z = _jax_draws(key, batch['y_lengths'])
    np.savez(tmp / 'draws.npz', offset=offset, t=t, z=z)
    np.save(tmp / 'probe.npy', _jax_probe(key, batch['y'].shape))
    return tmp, jmodel, params, batch, key


@pytest.fixture(scope='module')
def stepped(start, tmp_path_factory):
    """The worker's ``tp_steps`` on a (data, 2) mesh for data 1 and 2 (the
    Functions in the first), each scoring the batch with JAX's probe and
    with one drawn from a generator seeded SEED: {data: (data, tmp dir,
    the start)}."""
    src, out = start[0], {}
    for data in (1, 2):
        tmp = tmp_path_factory.mktemp(f'tp_data{data}')
        launch('tp_steps', {'hp': TINY, 'out_size': OUT_SIZE, 'seed': SEED,
                            'out': str(tmp),
                            'state_dict': str(src / 'sd.pt'),
                            'batch': str(src / 'batch.npz'),
                            'draws': str(src / 'draws.npz'), 'data': data,
                            'model': MODEL, 'functions': data == 1,
                            'score': {'batch': str(src / 'batch.npz'),
                                      'runs': {
                                          'probe': {
                                              'n_euler': SCORE_STEPS,
                                              'probe': str(src
                                                           / 'probe.npy')},
                                          'generator': {
                                              'n_euler': SCORE_STEPS,
                                              'seed': SEED}}}},
               tmp, 300, ranks=data * MODEL)
        out[data] = (data, tmp, start)
    return out


def _ranks(data, tmp, name):
    return [torch.load(tmp / f'{name}_{r}.pt', weights_only=True)
            for r in range(data * MODEL)]


def _whole(ranks):
    """The params and grads of the first data row's ranks, gathered, with
    its metrics: the dict that ``assert_step_close`` reads."""
    row = sorted((r for r in ranks if r['coord'][0] == 0),
                 key=lambda r: r['coord'][1])
    return {'metrics': row[0]['metrics'],
            'params': gather_state_dict([r['params'] for r in row]),
            'grads': gather_state_dict([r['grads'] for r in row])}


def test_functions_match_one_process(stepped):
    """``copy_to_model``: the value its input, the gradient the sum of the
    ranks' upstream gradients; ``gather_from_model``: the whole tensor
    from the ranks' channel blocks (channels-last), the gradient this
    rank's block; ``scatter_to_model``: this rank's block, the gradient
    the ranks' upstream blocks concatenated. Exact, as one process
    computes them."""
    _, tmp, _ = stepped[1]
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((2, 8, 3, 5), np.float32))
    ups = torch.from_numpy(rng.standard_normal((MODEL, 2, 8, 3, 5),
                                               np.float32))
    for j in range(MODEL):
        got = torch.load(tmp / f'functions_{j}.pt', weights_only=True)
        c = slice(4 * j, 4 * j + 4)
        want = {'copy': (x, ups.sum(0)),
                'gather': (x, ups[0][:, c]),
                'scatter': (x[:, c], torch.cat([ups[i][:, 4 * i:4 * i + 4]
                                                for i in range(MODEL)], 1))}
        for name, (value, grad) in want.items():
            assert torch.equal(got[name]['value'], value), name
            assert torch.equal(got[name]['grad'], grad), name


def test_functions_forward_mode_match_one_process(stepped):
    """``torch.func.jvp`` through the three Functions on two ranks: the
    tangent of ``copy_to_model`` is its input's, of ``gather_from_model``
    the ranks' tangent blocks concatenated, of ``scatter_to_model`` this
    rank's block of its input's; a gather whose input carries no tangent
    runs inside a jvp. Exact, as the unsplit ops' tangents."""
    _, tmp, _ = stepped[1]
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((2, 8, 3, 5), np.float32))
    rng.standard_normal((MODEL, 2, 8, 3, 5), np.float32)    # the upstreams
    dx = torch.from_numpy(rng.standard_normal((2, 8, 3, 5), np.float32))
    for j in range(MODEL):
        got = torch.load(tmp / f'functions_{j}.pt', weights_only=True)
        c = slice(4 * j, 4 * j + 4)
        want = {'copy': dx, 'gather': dx, 'scatter': dx[:, c]}
        for name, tangent in want.items():
            assert torch.equal(got[name]['tangent'], tangent), name
        assert torch.equal(got['gather_no_tangent']['value'], x * x)
        assert torch.equal(got['gather_no_tangent']['tangent'], dx * x)


def _score_ranks(data, tmp):
    """Each rank's saved scoring runs, with the rows of the global batch
    of 4 that its 'data' coordinate holds."""
    ranks = [torch.load(tmp / f'score_{r}.pt', weights_only=True)
             for r in range(data * MODEL)]
    n = 4 // data
    return [(r, slice(r['coord'][0] * n, (r['coord'][0] + 1) * n))
            for r in ranks]


@pytest.fixture(scope='module')
def one_score(start):
    """The port's one-process ``score_batch`` on the global batch, whole
    model: with JAX's probe, and with one drawn from a generator seeded
    SEED."""
    tmp, _, params, batch, _ = start
    model = torch_model(params)
    b = batch_to(batch, 'cpu')
    args = [b[k] for k in ('x', 'x_lengths', 'y', 'y_lengths')]
    return {'probe': score_batch(
                model, *args, n_euler=SCORE_STEPS,
                epsilon=torch.from_numpy(np.load(tmp / 'probe.npy'))),
            'generator': score_batch(
                model, *args, n_euler=SCORE_STEPS,
                generator=torch.Generator().manual_seed(SEED))}


@pytest.mark.parametrize('data', [1, 2])
def test_tp_score_equals_one_process(stepped, one_score, data):
    """Euler ``score_batch`` with the model split over 'model' (forward
    mode through the split layers) and the rows over 'data': every rank's
    scores are its rows of the port's one-process scores within 1e-5
    relative (f32), with the given probe and with the probe drawn at the
    global shape from one generator; the ranks that share rows agree bit
    for bit."""
    _, tmp, _ = stepped[data]
    ranks = _score_ranks(data, tmp)
    for run, want in one_score.items():
        for got, rows in ranks:
            assert_score_rows(got[run], want, rows, TOL)
            same = [g for g, _ in ranks if g['coord'][0] == got['coord'][0]]
            assert all(torch.equal(g[run]['score'], got[run]['score'])
                       and torch.equal(g[run]['z'], got[run]['z'])
                       for g in same), run


def test_tp_score_matches_jax_mesh(stepped):
    """The four ranks (data 2 x model 2) against JAX's ``score_batch`` on
    make_mesh(2, 2), its parameters placed by ``param_shardings`` and the
    batch by ``shard_batch``, jitted as __graft_entry__.py:156-172 calls
    it, the probe drawn from the same key: every rank's rows within
    test_torch_likelihood.py's 1e-5."""
    _, tmp, (_, jmodel, params, batch, key) = stepped[2]
    mesh = jax_make_mesh(data=2, model=MODEL,
                         devices=jax.devices()[:2 * MODEL])

    def like_fn(params, key, x, x_lengths, y, y_lengths):
        return jax_score_batch(jmodel, params, key, x, x_lengths, y,
                               y_lengths, n_euler=SCORE_STEPS)

    with mesh:
        placed = jax.device_put(params, param_shardings(mesh, params))
        assert any('model' in tuple(leaf.sharding.spec)
                   for leaf in jax.tree_util.tree_leaves(placed))
        sharded = jax_shard_batch(mesh, batch)
        want = jax.jit(like_fn)(placed, key, sharded['x'],
                                sharded['x_lengths'], sharded['y'],
                                sharded['y_lengths'])
    for got, rows in _score_ranks(2, tmp):
        assert_score_rows(got['probe'], want, rows, TOL)


def _jax_mesh_step(jmodel, params, batch, key, data):
    """JAX's clipped Adam step (train/state.py) on make_mesh(data, 2) with
    the params and the Adam state placed by ``param_shardings``, dropout
    off: (losses, the updated params, the clipped grads)."""
    mesh = jax_make_mesh(data=data, model=MODEL,
                         devices=jax.devices()[:data * MODEL])
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
        inner = jax.device_put(inner, param_shardings(mesh, inner))
        opt_state = tx.init(inner)
        opt_state = jax.device_put(opt_state,
                                   param_shardings(mesh, opt_state))
        sharded = [leaf for leaf in jax.tree_util.tree_leaves(inner)
                   if 'model' in tuple(leaf.sharding.spec)]
        assert sharded, 'JAX split no parameter'
        new, grads, metrics = jax.jit(step)(inner, opt_state,
                                            jax_shard_batch(mesh, batch))
    return ({k: float(v) for k, v in metrics.items()},
            *(flax_params_to_state_dict(jax.device_get({'params': t}))
              for t in (new, grads)))


@pytest.mark.parametrize('data', [1, 2])
def test_tp_step_matches_jax_mesh(stepped, data):
    """Dropout off, JAX's draws fed to the port: every rank's losses within
    1e-5 of JAX's step on make_mesh(data, 2) with param_shardings, and the
    ranks' blocks gathered, the clipped gradients and the parameters after
    the step (``assert_step_close``)."""
    _, tmp, (_, jmodel, params, batch, key) = stepped[data]
    want_metrics, want, want_grads = _jax_mesh_step(jmodel, params, batch,
                                                    key, data)
    ranks = _ranks(data, tmp, 'jax')
    for rank in ranks:
        for k, v in want_metrics.items():
            np.testing.assert_allclose(rank['metrics'][k], v, rtol=TOL,
                                       err_msg=k)
    assert_step_close(_whole(ranks), want, want_grads)


@pytest.mark.parametrize('data', [1, 2])
def test_tp_step_with_dropout_equals_one_process(stepped, data):
    """Dropout on, the draws from one seeded generator: the masks are drawn
    at the global shape on whole tensors, so every rank's metrics (the
    clip's two norms too) are the port's one-process step's on the global
    batch within 1e-5, and the gathered gradients and parameters within
    ``assert_step_close``'s bounds."""
    _, tmp, (_, _, params, batch, _) = stepped[data]
    model = torch_model(params).train()
    optimizer = make_optimizer(model.parameters())
    want = train_step(model, optimizer, batch_to(batch, 'cpu'), OUT_SIZE,
                      1.0, torch.Generator().manual_seed(SEED))
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    ranks = _ranks(data, tmp, 'dropout')
    for rank in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(rank['metrics'][k], float(v),
                                       rtol=TOL, err_msg=k)
    assert_step_close(_whole(ranks), model.state_dict(), grads)


@pytest.mark.parametrize('data', [1, 2])
@pytest.mark.parametrize('name', ['jax', 'dropout'])
def test_ranks_hold_only_their_blocks(stepped, name, data):
    """Each rank holds block j (its 'model' coordinate) of every split
    tensor and the rest whole: the shapes of ``shard_state_dict``; the
    replicated parameters bit-equal on every rank, a block bit-equal on
    the ranks that share j; the metrics equal on every rank; every
    parameter that needs a grad got one."""
    _, tmp, (_, _, params, _, _) = stepped[data]
    full = flax_params_to_state_dict(params)
    ranks = _ranks(data, tmp, name)
    assert sorted(tuple(r['coord']) for r in ranks) == [
        (i, j) for i in range(data) for j in range(MODEL)]
    for rank in ranks:
        assert rank['missing'] == []
        assert rank['metrics'] == ranks[0]['metrics']
        blocks = shard_state_dict(full, rank['coord'][1], MODEL)
        assert {k: v.shape for k, v in rank['params'].items()} == {
            k: v.shape for k, v in blocks.items()}
        for k, v in rank['params'].items():
            same = [r for r in ranks if split_dim(k, full[k].shape, MODEL)
                    is None or r['coord'][1] == rank['coord'][1]]
            assert all(torch.equal(v, r['params'][k]) for r in same), k


# ---- (e) the training CLI ---------------------------------------------------

def _ckpt(log_dir, step):
    return torch.load(log_dir / 'ckpt' / f'step_{step:08d}.pt',
                      weights_only=True)


def _held(got, want):
    """A checkpoint against another after the same steps: the
    parameters within TOL where both Adam second moments show a
    gradient of at least ADAM_FLAT (sqrt(v / (1 - 0.999^n)) is |g| after
    one step, the RMS over n), the first moments within the gradients'
    bound; the step and the generator equal."""
    assert got['step'] == want['step']
    assert torch.equal(got['generator'], want['generator'])
    n = want['step']
    state = {i: (want['optimizer']['state'][i], got['optimizer']['state'][i])
             for i in want['optimizer']['state']}
    names = list(want['model'])
    scale = max(float(w['exp_avg'].abs().max()) for w, _ in state.values())
    for i, (w, g) in state.items():
        name = names[i]
        assert g['exp_avg'].shape == w['exp_avg'].shape, name
        bound = (GRAD_TOL * float(w['exp_avg'].abs().max())
                 + GRAD_FLOOR * scale)
        assert float((g['exp_avg'] - w['exp_avg']).abs().max()) <= bound, \
            name
        rms = [(s['exp_avg_sq'] / (1 - 0.999 ** n)).sqrt() for s in (w, g)]
        steady = (rms[0] >= ADAM_FLAT) & (rms[1] >= ADAM_FLAT)
        torch.testing.assert_close(got['model'][name][steady],
                                   want['model'][name][steady], rtol=0,
                                   atol=TOL, msg=name)
    for name, w in want['model'].items():
        assert got['model'][name].shape == w.shape, name


def test_train_cli_mesh_model_2_checkpoints_move_both_ways(tmp_path):
    """``cli.train --cpu --mesh-model 2`` on two ranks, one step: its
    checkpoint, in the one-process layout, holds a one-process run's
    step within the step tests' bounds. A one-process run resumes from
    it, and two ranks resume from a one-process checkpoint: both hold the
    one-process run's second step."""
    filelist = write_corpus(tmp_path, n_items=4)
    common = ['--cpu', '--batch-size', '4', '--max-steps', '1',
              '--no-previews', '--set', *TINY_SET,
              f'data.cmudict_path={CMUDICT}',
              f'data.train_filelist_path={filelist}', 'data.x_buckets=(64,)',
              'data.y_buckets=(64,)', 'train.use_bf16_compute=False']
    one, tp, mixed, back = (tmp_path / d for d in
                            ('one', 'tp', 'mixed', 'back'))
    for _ in range(2):                   # steps 1 and 2, with a resume
        train_main(['--log-dir', str(one), *common])
    os.makedirs(mixed / 'ckpt')
    shutil.copy(one / 'ckpt' / 'step_00000001.pt', mixed / 'ckpt')
    tp_args = ['--mesh-model', '2', *common]
    outs = launch('cli_runs', {'runs': [['--log-dir', str(tp), *tp_args],
                                        ['--log-dir', str(mixed),
                                         *tp_args]]}, tmp_path, 300)
    assert all('tensor parallel: block' in out for out in outs)
    assert all('resumed from step 1' in out for out in outs)
    os.makedirs(back / 'ckpt')
    shutil.copy(tp / 'ckpt' / 'step_00000001.pt', back / 'ckpt')
    train_main(['--log-dir', str(back), *common])
    _held(_ckpt(tp, 1), _ckpt(one, 1))
    _held(_ckpt(mixed, 2), _ckpt(one, 2))
    _held(_ckpt(back, 2), _ckpt(one, 2))
