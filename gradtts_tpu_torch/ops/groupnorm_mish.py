"""Masked GroupNorm + Mish (kernel K1 of the port).

Counterpart of gradtts_tpu/ops/pallas/groupnorm_mish.py: ``_gn_mish_kernel``
(:48) and the jnp twin ``_reference`` (:133) that the JAX package runs by
default. The CUDA kernel is ``csrc/groupnorm_mish.cu``; its source says what
bounds it on the H100 and how it is laid out.

Semantics (reference diffusion.py:49-58): GroupNorm(groups, eps) over all
(F, T) positions of a batch item, masked zeros included, then the affine,
Mish, and the time mask. Statistics are single-pass f32 E[x^2] - E[x]^2 with
the variance clamped at 0, as ``_reference`` computes them.
"""

import torch

from gradtts_tpu_torch.ops import _build
from gradtts_tpu_torch.utils.profiling import span

_THREADS = 256             # csrc/groupnorm_mish.cu: THREADS
_TARGET_BLOCKS = 4 * 132   # four blocks per SM of an H100
_CHANNELS = (16, 32, 64, 128, 256)


def mish_f32(y: torch.Tensor) -> torch.Tensor:
    """Mish with the stable softplus log1p(exp(-|y|)) + max(y, 0)."""
    return y * torch.tanh(torch.log1p(torch.exp(-y.abs())) + y.clamp_min(0))


def mish_one_exp(y: torch.Tensor) -> torch.Tensor:
    """Mish as the CUDA kernel computes it, with one exponential: with
    e = exp(y) and n = e (e + 2), tanh(softplus(y)) = n / (n + 2), and
    mish(y) = y for y > 20, where n + 2 rounds to n in f32. Used by no
    path: the CPU tests hold it to :func:`mish_f32` and the JAX package's
    Mish, which the plain version keeps."""
    e = torch.exp(y.clamp_max(20.0))
    n = e * (e + 2)
    return torch.where(y > 20, y, y * (n / (n + 2)))


def groupnorm_mish_plain(x, mask, gamma, beta, groups: int = 8,
                         eps: float = 1e-5):
    """Plain PyTorch version. x [B, F, T, C]; mask [B, 1, T, 1];
    gamma, beta [C]. Returns x's dtype."""
    B, F, T, C = x.shape
    x32 = x.float().reshape(B, F * T, groups, C // groups)
    n = F * T * (C // groups)
    mean = x32.sum(dim=(1, 3), keepdim=True) / n
    var = ((x32 * x32).sum(dim=(1, 3), keepdim=True) / n
           - mean * mean).clamp_min(0.0)
    scale = torch.rsqrt(var + eps) * gamma.float().reshape(1, 1, groups, -1)
    shift = beta.float().reshape(1, 1, groups, -1) - mean * scale
    y = (x32 * scale + shift).reshape(B, F, T, C)
    return (mish_f32(y) * mask.float()).to(x.dtype)


def fits(channels: int, groups: int) -> bool:
    """Whether the kernel takes ``channels`` channels in ``groups`` groups."""
    return channels in _CHANNELS and 0 < groups <= 128 \
        and channels % groups == 0


def _check(x, mask, gamma, beta, groups):
    if x.dim() != 4:
        raise ValueError(f'groupnorm_mish: x must be [B, F, T, C], got {tuple(x.shape)}')
    B, F, T, C = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f'groupnorm_mish: unsupported dtype {x.dtype}')
    if not fits(C, groups):
        raise ValueError(f'groupnorm_mish: C={C}, groups={groups} not supported')
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError('groupnorm_mish: x must be contiguous and 16-byte aligned')
    if tuple(mask.shape) != (B, 1, T, 1) or mask.dtype != x.dtype \
            or not mask.is_contiguous():
        raise ValueError('groupnorm_mish: mask must be a contiguous [B, 1, T, 1] '
                         'tensor in x\'s dtype')
    for name, p in (('gamma', gamma), ('beta', beta)):
        if tuple(p.shape) != (C,) or p.dtype != torch.float32 \
                or not p.is_contiguous():
            raise ValueError(f'groupnorm_mish: {name} must be contiguous f32 [C]')
    for t in (mask, gamma, beta):
        if t.device != x.device:
            raise ValueError('groupnorm_mish: all inputs must be on one device')


def _tiling(x):
    """(chunk, tiles): rows per block of both passes and blocks per batch
    item, enough blocks to fill the card at batch B."""
    B, F, T, C = x.shape
    N = F * T
    rows_in_flight = _THREADS // (C * x.element_size() // 16)
    tiles = max(1, min(-(-_TARGET_BLOCKS // B), -(-N // rows_in_flight)))
    chunk = -(-N // tiles)
    return chunk, -(-N // chunk)


def _stats_pass(x, groups, chunk, tiles):
    """Pass 1 on a CUDA tensor: per-tile f32 group sums [B, tiles, 2,
    groups]."""
    B, F, T, C = x.shape
    part = torch.empty((B, tiles, 2, groups), dtype=torch.float32,
                       device=x.device)
    lib = _build.load('groupnorm_mish')
    _build.check(lib, lib.gtt_gn_stats(
        x.data_ptr(), part.data_ptr(), B, F * T, C, chunk, tiles, groups,
        _build.DTYPE_CODES[x.dtype], _build.stream_of(x)), 'gtt_gn_stats')
    return part


def _apply_pass(x, mask, part, gamma, beta, groups, eps, chunk, tiles):
    """Pass 2 on CUDA tensors: the output from pass 1's partial sums."""
    B, F, T, C = x.shape
    out = torch.empty_like(x)
    lib = _build.load('groupnorm_mish')
    _build.check(lib, lib.gtt_gn_apply(
        x.data_ptr(), mask.data_ptr(), part.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), out.data_ptr(), B, F * T, T, C, chunk, tiles,
        groups, eps, _build.DTYPE_CODES[x.dtype], _build.stream_of(x)),
        'gtt_gn_apply')
    return out


def _launch(x, mask, gamma, beta, groups, eps):
    """The kernel's two passes on CUDA tensors, counted as one launch."""
    _check(x, mask, gamma, beta, groups)
    chunk, tiles = _tiling(x)
    part = _stats_pass(x, groups, chunk, tiles)
    out = _apply_pass(x, mask, part, gamma, beta, groups, eps, chunk, tiles)
    groupnorm_mish.launches += 1
    return out


def _forward(x, mask, gamma, beta, groups, eps):
    if x.device.type == 'cpu':
        return groupnorm_mish_plain(x, mask, gamma, beta, groups, eps)
    return _launch(x, mask, gamma, beta, groups, eps)


class GroupNormMishFn(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU ones.
    Backward: recomputes :func:`groupnorm_mish_plain` and differentiates it,
    as the JAX package's ``_bwd`` (:209-215) recomputes ``_reference``.
    Forward mode (``jvp``): the same recompute, differentiated in forward
    mode, as ``jax.jvp`` differentiates the jnp twin the JAX package runs
    in its likelihood engine. The mask gets no grad and no tangent."""

    @staticmethod
    def forward(x, mask, gamma, beta, groups, eps):
        return _forward(x, mask, gamma, beta, groups, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, mask, gamma, beta, groups, eps = inputs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, mask, gamma, beta)
        ctx.save_for_forward(x, mask, gamma, beta)
        ctx.groups, ctx.eps = groups, eps

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return (None,) * 6
        x, mask, gamma, beta = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (x, gamma, beta)]
        with torch.enable_grad():
            y = groupnorm_mish_plain(inputs[0], mask, inputs[1], inputs[2],
                                     ctx.groups, ctx.eps)
            dx, dgamma, dbeta = torch.autograd.grad(y, inputs, dy)
        return dx, None, dgamma, dbeta, None, None

    @staticmethod
    def jvp(ctx, dx, _dmask, dgamma, dbeta, *_):
        x, mask, gamma, beta = map(_build.raw, ctx.saved_tensors)
        primals = {'x': x, 'gamma': gamma, 'beta': beta}
        tangents = {k: _build.raw(t) for k, t in
                    (('x', dx), ('gamma', dgamma), ('beta', dbeta))
                    if t is not None}
        if not tangents:
            return None

        def plain(*moving):
            args = {**primals, **dict(zip(tangents, moving))}
            return groupnorm_mish_plain(args['x'], mask, args['gamma'],
                                        args['beta'], ctx.groups, ctx.eps)

        with span('gradtts.unet.k1_tangent'):
            return torch.func.jvp(plain, tuple(primals[k] for k in tangents),
                                  tuple(tangents.values()))[1]


def groupnorm_mish(x, mask, gamma, beta, groups: int = 8, eps: float = 1e-5):
    """x [B, F, T, C] contiguous; mask [B, 1, T, 1] in x's dtype; gamma,
    beta [C] f32. CPU tensors take :func:`groupnorm_mish_plain`; CUDA
    tensors launch the kernel (two passes) or raise. Differentiable in x,
    gamma and beta in both modes, through :class:`GroupNormMishFn` where a
    grad or a forward-mode tangent may be asked for."""
    if _build.needs_function((x, gamma, beta)):
        return GroupNormMishFn.apply(x, mask, gamma, beta, groups, eps)
    return _forward(x, mask, gamma, beta, groups, eps)


groupnorm_mish.launches = 0
