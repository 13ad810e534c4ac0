"""The ('data', 'model') mesh as ``torch.distributed`` process groups.

Counterpart of gradtts_tpu/parallel/mesh.py (``initialize_distributed``
:19, ``multihost_barrier`` :54, ``make_mesh`` :82, ``batch_sharding`` :96,
``shard_batch`` :106, ``param_pspec`` :140, ``param_shardings`` :154,
``replicated`` :162). Where the JAX package runs one
program over a mesh of devices, the port runs one process a GPU, launched
by ``torchrun``: the processes join one process group, the mesh is a
``DeviceMesh`` over their ranks, and data-parallel training wraps the
model in ``DistributedDataParallel`` over the 'data' axis. Rank r takes
the r-th contiguous block of every global batch, the block that
``P('data')`` places on device r. The tensor-parallel rules
(``param_pspec``, ``param_shardings``) are :func:`split_dim`
and :func:`shard_model`: on a 'model' axis of M ranks each rank holds
block j (its 'model' coordinate) of every weight the rule splits, and the
split layers run the collectives of ``parallel.tensor``.
"""

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from gradtts_tpu_torch.parallel.tensor import ModelSplit, block
from gradtts_tpu_torch.utils.convert import flax_path

AXES = ('data', 'model')
# a gloo group beside an NCCL default group, for monitored_barrier, keyed
# by the default group it serves
_BARRIER_GROUPS = {}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, backend: Optional[str] = None
                           ) -> bool:
    """Joins this process to the process group of a multi-process run:
    ``torch.distributed.init_process_group`` with the coordinator
    ``host:port``, the process count and this process's rank from the
    arguments or, where they are None, from torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. Returns False, with no
    process group, in a process that was given no process count (a plain
    single-process run), True otherwise; a second call returns True.

    ``device`` is this process's device: ``cuda`` (the default) becomes
    ``cuda:LOCAL_RANK`` and is made the current device, and a
    ``RuntimeError`` names a ``LOCAL_RANK`` with no such device (no other
    device is taken in its place); ``cuda:i`` is taken as given; ``cpu``
    runs on the CPU. ``backend`` defaults to NCCL on a GPU and gloo on the
    CPU; gloo carries CUDA tensors too (broadcast and all_reduce), which
    is how two processes share one GPU, where NCCL refuses. NCCL runs get
    a gloo group beside the default one, for :func:`multihost_barrier`."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None and 'WORLD_SIZE' in env:
        num_processes = int(env['WORLD_SIZE'])
    if num_processes is None:
        return False
    if process_id is None:
        process_id = int(env.get('RANK', 0))
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    device = torch.device(device or 'cuda')
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda', int(env.get('LOCAL_RANK', 0)))
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f'process {process_id} wants {device}, but this machine has '
                f'{torch.cuda.device_count()} CUDA device(s): launch at most '
                'one process a GPU (torchrun --nproc-per-node)')
        torch.cuda.set_device(device)
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    dist.init_process_group(backend,
                            init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id)
    if backend != 'gloo':
        _BARRIER_GROUPS[dist.group.WORLD] = dist.new_group(backend='gloo')
    return True


def world() -> tuple:
    """(this process's rank, the number of processes): (0, 1) without a
    process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def multihost_barrier(name: str, timeout_s: int = 1200) -> None:
    """Blocks until every process reaches this barrier; raises a
    ``RuntimeError`` that names it when a process has not arrived after
    ``timeout_s`` seconds (``monitored_barrier``, over gloo: the default
    group, or the gloo group that :func:`initialize_distributed` made
    beside an NCCL one). A no-op in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    group = None
    if dist.get_backend() != 'gloo':
        group = _BARRIER_GROUPS.get(dist.group.WORLD)
        if group is None:
            raise RuntimeError(f'barrier {name!r}: the process group has no '
                               'gloo group for barriers; join it with '
                               'initialize_distributed')
    try:
        dist.monitored_barrier(group, datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f'barrier {name!r} failed after up to '
                           f'{timeout_s} s: {e}') from e


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence[int]] = None,
              device_type: str = 'cuda') -> DeviceMesh:
    """A ('data', 'model') ``DeviceMesh`` over the ranks ``devices`` (every
    rank of the process group by default), rank ``devices[i * model + j]``
    at (i, j). ``data == -1`` takes all the ranks that the model axis
    leaves. Raises ``ValueError`` as the JAX package does when ``model``
    does not divide the rank count or ``data * model`` is not it."""
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    n = len(ranks)
    if model < 1 or n % model:
        raise ValueError(f'model axis {model} must divide device count {n}')
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f'mesh {data}x{model} != {n} devices')
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=AXES)


def batch_sharding(mesh: DeviceMesh):
    """A function of a batch array [B, ...] to this rank's rows of it: the
    contiguous block ``[r * B / W, (r + 1) * B / W)`` of the rank's
    coordinate r on the W-wide 'data' axis (``P('data')``); a 0-d value
    whole."""
    index, count = mesh.get_local_rank('data'), mesh.size(0)

    def shard(x):
        if np.ndim(x) == 0:
            return x
        b = x.shape[0]
        if b % count:
            raise ValueError(f'batch {b} is not divisible by the data axis '
                             f'{count}')
        return x[index * b // count:(index + 1) * b // count]
    return shard


def shard_batch(mesh: DeviceMesh, batch: dict, per_host: bool = False
                ) -> dict:
    """A batch dict as tensors on this rank's device (its current CUDA
    device on a 'cuda' mesh). With ``per_host`` the loader has already
    given this rank its rows (``DataLoader(shard=(rank, world))``) and they
    move as they are; otherwise ``batch`` is the global batch and the rank
    keeps its block (:func:`batch_sharding`)."""
    shard = (lambda x: x) if per_host else batch_sharding(mesh)
    device = (torch.device('cuda', torch.cuda.current_device())
              if mesh.device_type == 'cuda' else torch.device('cpu'))
    return {k: torch.as_tensor(shard(v)).to(device) for k, v in
            batch.items()}


def replicated(mesh: DeviceMesh, module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with rank 0's parameters and buffers on every rank of the
    'data' axis (a broadcast; ``DistributedDataParallel`` does the same
    when it wraps a model for training); returns ``module``."""
    group = mesh.get_group('data')
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t, src, group=group)
    return module


# --- parameter sharding rules (tensor parallelism) ------------------------

# The JAX package's hints (gradtts_tpu/parallel/mesh.py:135): substrings of
# a parameter's path in its param tree whose kernels are split over the
# 'model' axis, along their output channels.
_TP_HINTS = ('ffn_layers', 'conv_q', 'conv_k', 'conv_v', 'conv_o',
             'to_qkv', 'to_out', 'block1', 'block2', 'res_conv',
             'mlp_dense', 'spk_mlp', 'mlp_0', 'mlp_2')


def split_dim(name: str, shape, model_size: int) -> Optional[int]:
    """The torch dim over which a ``model_size``-wide 'model' axis splits the
    GradTTS parameter ``name`` (a ``state_dict`` key) of ``shape``, or None
    where every rank holds it whole: ``param_pspec`` (:140) on the same
    parameter. A kernel of rank 2 or more whose path in the JAX param tree
    (``utils.convert.flax_path``) holds a hint is split over its output
    channels where they divide by ``model_size``: flax's last axis,
    torch's dim 0 of the Conv1d, Conv2d and Linear weights that the hints
    name."""
    if model_size <= 1:
        return None
    path, _ = flax_path(name)
    if (len(shape) >= 2 and path[-1] == 'kernel'
            and any(h in '/'.join(path) for h in _TP_HINTS)
            and shape[0] % model_size == 0):
        return 0
    return None


def shard_model(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Splits ``model`` (a full GradTTS, the same on every rank) over the
    mesh's 'model' axis, in place: each parameter that :func:`split_dim`
    splits becomes this rank's contiguous block j of M along its split
    dim (j its 'model' coordinate), and its module records the split
    (``model_split``, a ``parallel.tensor.ModelSplit``) that its forward
    reads. Shard before ``DistributedDataParallel`` and the optimizer
    see the parameters. A one-wide axis leaves ``model`` as it is.
    Returns ``model``."""
    size = mesh.size(AXES.index('model'))
    if size == 1:
        return model
    at = ModelSplit(mesh.get_group('model'), mesh.get_local_rank('model'),
                    size, 0)
    for name, p in list(model.named_parameters()):
        dim = split_dim(name, p.shape, size)
        if dim is None:
            continue
        owner, _, leaf = name.rpartition('.')
        module = model.get_submodule(owner)
        module.model_split = at._replace(dim=dim)
        setattr(module, leaf, nn.Parameter(
            block(p.detach(), at, dim).clone(),
            requires_grad=p.requires_grad))
    return model
