"""The port's mesh (``parallel/mesh.py``) against the JAX package's, in one
process: ``make_mesh``'s shapes and refusals against JAX ``make_mesh`` on
the virtual CPU devices, ``shard_batch``'s rows against the rows that JAX's
``batch_sharding`` places on each device (ranks played by a fake process
group), ``initialize_distributed`` without torchrun's environment, the
draws of a rank at the global batch's shape, the losses normalized by the
global batch's counts, and the trainer's mesh settings."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax

from _torch_port import jax_model_and_params, ragged_batch, torch_model
from test_torch_train import OUT_SIZE, _jax_draws
from gradtts_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from gradtts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.layers import RowShard, draw, dropout
from gradtts_tpu_torch.models.tts import compute_loss, loss_counts
from gradtts_tpu_torch.parallel import mesh as tmesh
from gradtts_tpu_torch.train import loop
from gradtts_tpu_torch.train.loop import batch_to, check_ported


def _fake_group(rank, ranks):
    """This process as rank ``rank`` of ``ranks`` (collectives do nothing);
    the caller destroys it."""
    dist.init_process_group('fake', store=FakeStore(), rank=rank,
                            world_size=ranks)


# (devices, data, model): shapes, then the two refusals of each package
MESHES = [(1, -1, 1), (2, -1, 1), (8, -1, 1), (8, -1, 2), (8, 4, 2),
          (4, 1, 4), (8, 2, 4), (6, -1, 3), (8, -1, 3), (8, 3, 2),
          (4, 2, 0), (2, 4, 1)]


@pytest.mark.parametrize('n,data,model', MESHES)
def test_make_mesh_matches_jax(n, data, model):
    try:
        want = jax_make_mesh(data, model,
                             devices=jax.devices()[:n]).devices.shape
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(data, model, devices=range(n), device_type='cpu')
        assert str(got.value) == str(e)
        return
    _fake_group(0, n)
    try:
        mesh = tmesh.make_mesh(data, model, device_type='cpu')
        assert mesh.shape == want
        assert mesh.mesh_dim_names == ('data', 'model')
        assert mesh.mesh.tolist() == np.arange(n).reshape(want).tolist()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('ranks', [2, 4, 8])
def test_shard_batch_gives_rank_r_the_rows_of_device_r(ranks):
    """Rank r's rows of a global batch are those that JAX's
    ``batch_sharding`` (``P('data')``) places on device r of
    ``make_mesh(data=W)``; with ``per_host`` they are the batch given."""
    rng = np.random.default_rng(ranks)
    batch = {'x': rng.integers(0, 9, (8, 5)), 'y': rng.standard_normal(
        (8, 3, 2)).astype(np.float32), 'n': np.int32(7)}
    jmesh = jax_make_mesh(ranks, 1, devices=jax.devices()[:ranks])
    placed = {k: jax.device_put(v, jax_batch_sharding(jmesh)(v))
              for k, v in batch.items() if np.ndim(v)}
    for r in range(ranks):
        _fake_group(r, ranks)
        try:
            mesh = tmesh.make_mesh(device_type='cpu')
            got = tmesh.shard_batch(mesh, batch)
            local = tmesh.shard_batch(mesh, batch, per_host=True)
        finally:
            dist.destroy_process_group()
        device = jmesh.devices[r, 0]
        for k, arr in placed.items():
            want = next(np.asarray(s.data) for s in arr.addressable_shards
                        if s.device == device)
            np.testing.assert_array_equal(got[k].numpy(), want)
            np.testing.assert_array_equal(local[k].numpy(), batch[k])
        assert int(got['n']) == 7


def test_initialize_distributed_without_torchrun_is_one_process(
        monkeypatch):
    for name in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
                 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.initialize_distributed(device='cpu') is False
    assert not dist.is_initialized()
    assert tmesh.world() == (0, 1)
    tmesh.multihost_barrier('one process')          # a no-op


def test_initialize_distributed_takes_no_other_gpu(monkeypatch):
    """A rank whose LOCAL_RANK names no CUDA device raises before it
    joins; it never falls back to another device."""
    monkeypatch.setenv('LOCAL_RANK', '1')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='cuda:1'):
        tmesh.initialize_distributed(num_processes=2, process_id=1)
    assert not dist.is_initialized()


def test_row_shard_draws_the_rows_of_the_global_draw():
    """Each sampler of the training step, drawn by rank r of W at its local
    shape from a generator in the same state, is rows [r*b, (r+1)*b) of the
    draw at the global shape; so are the dropout masks."""
    samplers = [torch.rand, torch.randn,
                lambda shape, **kw: torch.randint(0, 1 << 30, shape, **kw)]
    x = torch.ones(8, 6, 5)
    for sample in samplers:
        want = sample((8, 6, 5), generator=torch.Generator().manual_seed(3))
        for r in range(4):
            got = draw(sample, (2, 6, 5),
                       RowShard(torch.Generator().manual_seed(3), r, 4))
            assert torch.equal(got, want[2 * r:2 * r + 2])
    want = dropout(x, 0.5, True, torch.Generator().manual_seed(4))
    got = [dropout(x[:4], 0.5, True,
                   RowShard(torch.Generator().manual_seed(4), r, 2))
           for r in range(2)]
    assert torch.equal(torch.cat(got), want)


def test_parts_over_the_global_counts_sum_to_the_global_losses():
    """Each half of a batch whose halves differ in length, normalized by
    the whole batch's ``loss_counts``, gives the half's share: the two
    shares sum to the whole batch's losses, where the mean of the halves'
    own losses does not."""
    _, params = jax_model_and_params(seed=65)
    model = torch_model(params)
    glob = batch_to(ragged_batch(66), 'cpu')
    offset, t, z = (torch.from_numpy(np.array(a)) for a in _jax_draws(
        jax.random.PRNGKey(67), glob['y_lengths'].numpy()))

    def losses(rows, counts=None):
        b = {k: v[rows] for k, v in glob.items()}
        with torch.no_grad():
            res = compute_loss(model, b['x'], b['x_lengths'], b['y'],
                               b['y_lengths'], out_size=OUT_SIZE,
                               offset=offset[rows].long(), t=t[rows],
                               z=z[rows], counts=counts)
        return torch.stack([res.dur_loss, res.prior_loss, res.diff_loss])

    whole = losses(slice(0, 4))
    counts = loss_counts(glob['x_lengths'], glob['y_lengths'], 64, OUT_SIZE)
    assert counts.tolist() == [41.0, 108.0]   # 16+14+6+5; 32+32+20+24
    parts = losses(slice(0, 2), counts) + losses(slice(2, 4), counts)
    torch.testing.assert_close(parts, whole, rtol=1e-6, atol=0)
    own = (losses(slice(0, 2)) + losses(slice(2, 4))) / 2
    assert float((own - whole).abs().max()) > 1e-2 * float(whole.abs().max())


@pytest.mark.parametrize('ranks,mesh_data,mesh_model,refused', [
    (1, -1, 1, None), (1, 1, 1, None), (4, 4, 1, None), (4, -1, 1, None),
    (1, 2, 1, 'torchrun --nproc-per-node 2'),
    (4, 2, 1, 'torchrun --nproc-per-node 2'),
    (4, 1, 1, 'torchrun --nproc-per-node 1'),
    (4, 4, 2, 'mesh_model=2'), (4, 2, 2, None), (2, -1, 2, None)])
def test_trainer_takes_the_process_count_as_its_data_axis(
        monkeypatch, ranks, mesh_data, mesh_model, refused):
    monkeypatch.setattr(loop, 'world', lambda: (0, ranks))
    cfg = get_config('ljspeech', **{'train.mesh_data': mesh_data,
                                    'train.mesh_model': mesh_model})
    if refused is None:
        check_ported(cfg)
    else:
        with pytest.raises(ValueError, match=refused):
            check_ported(cfg)
