"""Shared building blocks (counterpart of gradtts_tpu/models/layers.py).

bf16 compute works as in the JAX package, whose parameters stay f32 (flax
``param_dtype``) and are cast at use: the models keep every parameter in
f32, cast the activations to their compute dtype where the JAX modules do,
and the convolutions below use their f32 weights in the dtype of their
input (:class:`CastAtUse`). Norms compute in f32, and dropout draws its keep mask
from an explicit generator.

Tensor parallelism (``parallel.mesh.shard_model``): a Linear or
convolution whose weight is split over the mesh's 'model' axis carries a
``model_split`` record. :func:`output_block` computes its output-channel
block from the whole input, and :func:`split_apply` gathers the blocks;
a layer with no record runs as it always does.
"""

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from gradtts_tpu_torch.parallel.tensor import (copy_to_model,
                                               gather_from_model,
                                               scatter_to_model)


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation, x * tanh(softplus(x))."""
    return x * torch.tanh(nn.functional.softplus(x))


class RowShard(NamedTuple):
    """The random generator of a data-parallel step, the same on every
    rank, and this rank's block of the global batch: row block ``index``
    of ``count``. :func:`draw` makes each draw at the global batch's shape
    and keeps the rank's rows, so ``count`` ranks draw together what one
    process draws for the whole batch, as the JAX package's replicated key
    draws at the global shape under its mesh."""
    generator: torch.Generator
    index: int
    count: int


def draw(sample, shape, generator, **kwargs) -> torch.Tensor:
    """``sample(shape, generator=generator, **kwargs)`` for a sampler such
    as ``torch.rand``, whose dim 0 is the batch; where ``generator`` is a
    :class:`RowShard`, this rank's rows of the draw at the global shape."""
    if not isinstance(generator, RowShard):
        return sample(shape, generator=generator, **kwargs)
    b = shape[0]
    full = sample((b * generator.count, *shape[1:]),
                  generator=generator.generator, **kwargs)
    return full[generator.index * b:(generator.index + 1) * b]


def dropout(x: torch.Tensor, p: float, training: bool,
            generator) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics (``_dropout``, text_encoder.py:303):
    keep each element with probability 1 - p and scale it by 1 / (1 - p).
    The identity unless ``training``; the keep mask is drawn from
    ``generator`` (a ``torch.Generator`` or a :class:`RowShard`), which
    training must pass."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        raise ValueError('dropout in training mode draws from an explicit '
                         'torch.Generator; pass generator=')
    keep = draw(torch.rand, x.shape, generator, device=x.device) < 1 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class CastAtUse:
    """Mixin of the convolutions: each f32 parameter is used in the dtype
    of the input. Where autograd needs no grad through the cast (no grad
    mode, or a parameter that needs none), the cast copy is kept and reused
    until the parameter changes in place, moves or is replaced, so
    synthesis casts each weight once rather than at every call;
    :meth:`kept` keeps any other such copy (a Block's tap-major weight)."""

    def cast(self, name: str, dtype: torch.dtype):
        p = getattr(self, name)
        if p is None or p.dtype == dtype:
            return p
        if torch.is_grad_enabled() and p.requires_grad:
            return p.to(dtype)
        return self.kept(name, p, lambda q: q.to(dtype), dtype)

    def kept(self, slot: str, p: torch.Tensor, make, *key):
        """``make(p.detach())``, kept in ``slot`` and reused until ``p``
        changes in place, moves or is replaced, or ``key`` changes."""
        key = (*key, p.device, p.data_ptr(), p._version)
        kept = self.__dict__.setdefault('_casts', {})
        hit = kept.get(slot)
        if hit is None or hit[0] != key:
            hit = kept[slot] = (key, make(p.detach()))
        return hit[1]


class Conv1d(CastAtUse, nn.Conv1d):
    """``nn.Conv1d`` that computes in the dtype of its input."""

    def forward(self, x):
        return self._conv_forward(x, self.cast('weight', x.dtype),
                                  self.cast('bias', x.dtype))


class Conv2d(CastAtUse, nn.Conv2d):
    """``nn.Conv2d`` that computes in the dtype of its input."""

    def forward(self, x):
        return self._conv_forward(x, self.cast('weight', x.dtype),
                                  self.cast('bias', x.dtype))


class ConvTranspose2d(CastAtUse, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no ``output_size``) that computes in the
    dtype of its input."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.cast('weight', x.dtype),
                                  self.cast('bias', x.dtype), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T] with biased variance, eps
    1e-4, statistics in f32 (reference layout: parameters ``gamma``/``beta``)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.gamma.view(1, -1, 1) + self.beta.view(1, -1, 1)
        return y.to(x.dtype)


def output_block(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The output-channel block of a split Linear or convolution (``layer``
    with a ``model_split``) from the whole input ``x``: this rank's weight
    block and its block of the replicated bias, added inside the layer's
    call as the whole layer adds it (one rounding in a bf16 conv). The
    input's gradient is summed over the 'model' ranks."""
    split = layer.model_split
    x = copy_to_model(x, split)
    b = (None if layer.bias is None
         else scatter_to_model(layer.bias, split, 0))
    if isinstance(layer, nn.Linear):
        return F.linear(x, layer.weight, b)
    return layer._conv_forward(x, layer.cast('weight', x.dtype),
                               None if b is None else b.to(x.dtype))


def split_apply(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` for a Linear or a convolution of this module, whose
    output channels (dim 1) may be split over the 'model' axis: there the
    blocks of :func:`output_block` gathered over the axis."""
    split = getattr(layer, 'model_split', None)
    if split is None:
        return layer(x)
    return gather_from_model(output_block(layer, x), split, 1)
