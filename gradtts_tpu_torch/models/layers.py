"""Shared building blocks (counterpart of gradtts_tpu/models/layers.py).

bf16 compute works as in the JAX package, whose parameters stay f32 (flax
``param_dtype``) and are cast at use: the models keep every parameter in
f32, cast the activations to their compute dtype where the JAX modules do,
and the convolutions below use their f32 weights in the dtype of their
input (:class:`CastAtUse`). Norms compute in f32, and dropout draws its keep mask
from an explicit generator.
"""

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F


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
    synthesis casts each weight once rather than at every call."""

    def cast(self, name: str, dtype: torch.dtype):
        p = getattr(self, name)
        if p is None or p.dtype == dtype:
            return p
        if torch.is_grad_enabled() and p.requires_grad:
            return p.to(dtype)
        key = (dtype, p.device, p.data_ptr(), p._version)
        kept = self.__dict__.setdefault('_casts', {})
        hit = kept.get(name)
        if hit is None or hit[0] != key:
            hit = kept[name] = (key, p.detach().to(dtype))
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
