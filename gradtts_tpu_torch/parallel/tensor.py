"""Tensor parallelism over the mesh's 'model' axis: what a split layer
records of its split, the three collectives of a split layer as autograd
Functions, and the full parameters and Adam state of a split model.

The JAX package shards a kernel's output channels over 'model'
(``param_shardings``, gradtts_tpu/parallel/mesh.py:154) and XLA inserts the
collectives. The port inserts them itself, over the 'model' group of a
``DeviceMesh`` (``parallel.mesh.shard_model`` splits the weights):

- :func:`copy_to_model`: the identity; its backward is the all_reduce sum
  of the ranks' input gradients, since a rank's W_j^T dy_j is one part of
  the whole input's gradient.
- :func:`gather_from_model`: the ranks' blocks concatenated along a dim;
  its backward is this rank's block of the gradient, with no collective.
- :func:`scatter_to_model`: this rank's block of a replicated tensor (a
  bias or a GroupNorm affine that the rank uses in part); its backward
  gathers the gradient.

Each also has a forward-mode rule, for ``torch.func.jvp`` (the Hutchinson
divergence of likelihood scoring on a split model): the tangent of a copy
is its input's, of a gather the ranks' tangent blocks gathered (one more
collective, after the forward's, in the same order on every rank), of a
scatter this rank's block of it. The rules take the tangents from under
the transform's wrapper (``ops._build.raw``), as the collectives need
tensors with storage.

A gather is an all_reduce sum of a zero-filled full-size buffer that holds
the rank's block: exact in every dtype (x + 0 = x), and carried by NCCL
and by gloo's CUDA path alike, whose CUDA collectives are broadcast and
all_reduce only. It moves twice the bytes of an all_gather.
"""

from typing import NamedTuple

import torch
import torch.distributed as dist

from gradtts_tpu_torch.ops import _build


class ModelSplit(NamedTuple):
    """A split weight's place on the 'model' axis: this rank holds block
    ``index`` of ``size`` contiguous blocks along the weight's ``dim``, and
    the axis's ranks form ``group``."""
    group: object          # torch.distributed.ProcessGroup
    index: int
    size: int
    dim: int


def block(x: torch.Tensor, split: ModelSplit, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // split.size
    return x.narrow(dim, split.index * n, n)


def gather(x: torch.Tensor, split: ModelSplit, dim: int) -> torch.Tensor:
    """The ranks' blocks ``x`` concatenated along ``dim``, on every rank:
    an all_reduce of a zero-filled buffer (channels-last where ``x`` is)
    that holds ``x`` at this rank's place. Not differentiable: see
    :func:`gather_from_model`."""
    shape = list(x.shape)
    shape[dim] *= split.size
    fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    full = torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=fmt).zero_()
    block(full, split, dim).copy_(x)
    dist.all_reduce(full, group=split.group)
    return full


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(x, split):
        # a view, not ``x`` itself: torch.func's transforms take no Function
        # that returns an input as it is (no copy is made)
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.split = inputs[1]

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx, group=ctx.split.group)
        return dx, None

    @staticmethod
    def jvp(ctx, dx, _):
        # the forward returns a view, so forward mode wants a view of dx
        dx = _build.raw(dx)
        return dx.view_as(dx)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, split, dim):
        return gather(x, split, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.split, ctx.dim = inputs

    @staticmethod
    def backward(ctx, dy):
        return block(dy, ctx.split, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, dx, *_):
        return gather(_build.raw(dx), ctx.split, ctx.dim)


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(x, split, dim):
        return block(x, split, dim).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.split, ctx.dim = inputs

    @staticmethod
    def backward(ctx, dy):
        return gather(dy.contiguous(), ctx.split, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, dx, *_):
        return block(_build.raw(dx), ctx.split, ctx.dim).clone()


def copy_to_model(x: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    """``x``, the replicated input of a split layer; its gradient is the sum
    over the 'model' ranks of theirs."""
    return _CopyToModel.apply(x, split)


def gather_from_model(x: torch.Tensor, split: ModelSplit,
                      dim: int) -> torch.Tensor:
    """The 'model' ranks' blocks ``x`` concatenated along ``dim``; the
    gradient of ``x`` is this rank's block of the whole's."""
    return _GatherFromModel.apply(x, split, dim)


def scatter_to_model(x: torch.Tensor, split: ModelSplit,
                     dim: int) -> torch.Tensor:
    """This rank's block of the replicated ``x`` along ``dim``; the
    gradient of ``x`` is the 'model' ranks' block gradients gathered."""
    return _ScatterToModel.apply(x, split, dim)


def split_parameters(module: torch.nn.Module) -> dict:
    """{id(weight): its ModelSplit} of every split weight under ``module``
    (empty where nothing is split)."""
    return {id(m.weight): m.model_split for m in module.modules()
            if getattr(m, 'model_split', None) is not None}


def share_replicated_grads(model: torch.nn.Module) -> None:
    """Gives every 'model' rank the first rank's gradients of the
    parameters that the ranks hold whole (one broadcast of them all,
    flattened). The ranks compute those gradients from the same inputs,
    but a GPU's convolution backward may sum in another order on each
    (cuDNN's algorithms are not all deterministic); without this the
    replicated parameters, and with them the ranks' forwards, would part
    a little more at every step. A no-op where nothing is split."""
    splits = split_parameters(model)
    if not splits:
        return
    group = next(iter(splits.values())).group
    grads = [p.grad for p in model.parameters()
             if p.grad is not None and id(p) not in splits]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.broadcast(flat, dist.get_global_rank(group, 0), group=group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def full_state_dict(model: torch.nn.Module) -> dict:
    """``model.state_dict()`` with each split weight gathered to full size:
    every 'model' rank must call it (collectives)."""
    sd = model.state_dict()
    for name, m in model.named_modules():
        split = getattr(m, 'model_split', None)
        if split is not None:
            key = f'{name}.weight'
            sd[key] = gather(sd[key].detach(), split, split.dim)
    return sd


def _map_moments(state_dict: dict, optimizer, model, fn) -> dict:
    """A copy of the Adam ``state_dict`` of ``optimizer`` (over ``model``'s
    parameters) with each split weight's moments ``fn(moment, split)``;
    the live state is not touched."""
    splits = split_parameters(model)
    if not splits:
        return state_dict
    params = [p for g in optimizer.param_groups for p in g['params']]
    out = {**state_dict, 'state': dict(state_dict['state'])}
    for i, state in out['state'].items():
        split = splits.get(id(params[int(i)]))
        if split is not None:
            out['state'][i] = {**state, **{
                k: fn(state[k], split) for k in ('exp_avg', 'exp_avg_sq')}}
    return out


def full_optimizer_state(optimizer, model) -> dict:
    """``optimizer.state_dict()`` with the moments of each split weight
    gathered to full size, the one-process layout: every 'model' rank must
    call it (collectives)."""
    return _map_moments(optimizer.state_dict(), optimizer, model,
                        lambda v, s: gather(v, s, s.dim))


def optimizer_state_blocks(state_dict: dict, optimizer, model) -> dict:
    """A one-process Adam ``state_dict`` (of a full model's parameters, in
    the same order) with the moments of each of ``model``'s split weights
    cut to this rank's block, for ``optimizer.load_state_dict``."""
    return _map_moments(state_dict, optimizer, model,
                        lambda v, s: block(v, s, s.dim).clone())
