"""The score U-Net's Block convolution in f32: 3x3, stride 1, padding 1.

It replaces no TPU kernel: the JAX package leaves this convolution to
``lax.conv`` (gradtts_tpu/models/diffusion.py ``Block`` :251). On the card
cuDNN computes it in full f32 (TF32 off) by FFT algorithms that cost a
forward-mode U-Net evaluation ~100,000 launches; the CUDA kernel
``csrc/conv3x3.cu`` is one launch a convolution, primal or tangent. Its
source says what bounds it on the H100 and how it is laid out.

Semantics: ``conv2d(x * mask, weight, bias, padding=1)`` on channels-last
[B, C, F, T] activations with the time mask [B, 1, 1, T] (that of every
``Block``). :func:`use_kernel` is the dispatch rule of ``Block``: the
kernel for a CUDA f32 input when the caller asked for full-f32
convolutions (``torch.backends.cudnn.allow_tf32`` False) and the kernel
takes the widths; everywhere else cuDNN, as before.
"""

import torch
from torch.nn import functional as F

from gradtts_tpu_torch.ops import _build

CL = torch.channels_last
_BN = 64          # csrc/conv3x3.cu: BN, output channels a block
_KC = 8           # csrc/conv3x3.cu: KC, input channels a pipeline stage
_SMALL_CIN = (2, 3)   # csrc/conv3x3.cu: the direct kernel's C_in


def conv3x3_plain(x, mask, weight, bias=None):
    """Plain PyTorch version: x [B, C_in, F, T], mask [B, 1, 1, T], weight
    [C_out, C_in, 3, 3], bias [C_out] or None; channels-last [B, C_out, F,
    T] out."""
    return F.conv2d(x * mask, weight, bias, padding=1).contiguous(
        memory_format=CL)


def fits(c_in: int, c_out: int) -> bool:
    """Whether the kernel takes ``c_in`` input and ``c_out`` output
    channels: C_in 2 or 3 (the U-Net's input) or a multiple of 8, C_out a
    multiple of 64."""
    return (c_in in _SMALL_CIN or (c_in > 0 and c_in % _KC == 0)) \
        and c_out > 0 and c_out % _BN == 0


def use_kernel(x, c_in: int, c_out: int) -> bool:
    """Whether a Block's convolution of ``x`` takes the kernel: a CUDA f32
    input, full f32 asked for (cuDNN's TF32 off: with it on, cuDNN's TF32
    kernels are faster than any FMA kernel) and widths it takes. bf16, TF32
    and the CPU keep cuDNN's or oneDNN's call."""
    return (x.device.type == 'cuda' and x.dtype == torch.float32
            and not torch.backends.cudnn.allow_tf32 and fits(c_in, c_out))


def tap_major(weight):
    """[C_out, C_in, 3, 3] -> the kernel's [3, 3, C_in, C_out], contiguous
    (no grad: the kernel's copy of the weight)."""
    return weight.detach().permute(2, 3, 1, 0).contiguous()


def _check(x, mask, taps, bias):
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f'conv3x3: x must be f32 [B, C, F, T], got '
                         f'{x.dtype} {tuple(x.shape)}')
    B, C, _, T = x.shape
    if tuple(taps.shape[:3]) != (3, 3, C) or taps.dtype != torch.float32 \
            or not taps.is_contiguous():
        raise ValueError('conv3x3: taps must be contiguous f32 [3, 3, C_in, '
                         'C_out] (tap_major)')
    if not fits(C, taps.shape[3]):
        raise ValueError(f'conv3x3: C_in={C}, C_out={taps.shape[3]} not '
                         'supported')
    if tuple(mask.shape) != (B, 1, 1, T) or mask.dtype != torch.float32:
        raise ValueError('conv3x3: mask must be f32 [B, 1, 1, T]')
    if bias is not None and (tuple(bias.shape) != (taps.shape[3],)
                             or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError('conv3x3: bias must be contiguous f32 [C_out]')
    for t in (mask, taps, bias):
        if t is not None and t.device != x.device:
            raise ValueError('conv3x3: all inputs must be on one device')


def _launch(x, mask, taps, bias):
    """The kernel on CUDA tensors: channels-last [B, C_out, F, T] out."""
    _check(x, mask, taps, bias)
    x = x.contiguous(memory_format=CL)
    mask = mask.contiguous()
    B, C, Fq, T = x.shape
    c_out = taps.shape[3]
    y = torch.empty((B, c_out, Fq, T), dtype=x.dtype, device=x.device,
                    memory_format=CL)
    lib = _build.load('conv3x3')
    _build.check(lib, lib.gtt_conv3x3(
        x.data_ptr(), mask.data_ptr(), taps.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), B, Fq, T,
        C, c_out, _build.stream_of(x)), 'gtt_conv3x3')
    conv3x3.launches += 1
    return y


def _forward(x, mask, weight, bias, taps):
    if x.device.type == 'cpu':
        return conv3x3_plain(x, mask, weight, bias)
    return _launch(x, mask, taps, bias)


class Conv3x3Fn(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU ones.
    Forward mode (``jvp``): the convolution is linear in x, so the tangent
    is the same convolution of dx with no bias: the kernel again, with the
    same weight and mask (no path of the port gives the weights a tangent;
    one is refused). Backward: recomputes :func:`conv3x3_plain` and
    differentiates it, as K1's does. ``taps`` is the weight in the kernel's
    layout (:func:`tap_major`), no input of its own; the mask gets no grad
    and no tangent."""

    @staticmethod
    def forward(x, mask, weight, bias, taps):
        return _forward(x, mask, weight, bias, taps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, mask, weight, bias, taps = inputs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, mask, weight, bias)
        ctx.save_for_forward(mask, weight, taps)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return (None,) * 5
        x, mask, weight, bias = ctx.saved_tensors
        wanted = [i for i in (0, 2, 3) if ctx.needs_input_grad[i]]
        args = [x, mask, weight, bias]
        for i in wanted:
            args[i] = args[i].detach().requires_grad_()
        with torch.enable_grad():
            y = conv3x3_plain(*args)
            grads = torch.autograd.grad(y, [args[i] for i in wanted], dy)
        out = [None] * 5
        for i, g in zip(wanted, grads):
            out[i] = g
        return tuple(out)

    @staticmethod
    def jvp(ctx, dx, _dmask, dweight, dbias, _dtaps):
        if dweight is not None or dbias is not None:
            raise NotImplementedError('conv3x3: a tangent of the weight or '
                                      'the bias')
        if dx is None:
            return None
        # the rule runs on the values under torch.func's wrappers, with the
        # transforms' dispatch off, so that the kernel can read them and
        # its output is allocated as a plain tensor (as K6/K7's rule)
        with torch._C._DisableFuncTorch():
            mask, weight, taps = map(_build.raw, ctx.saved_tensors)
            return _forward(_build.raw(dx), mask, weight, None, taps)


def conv3x3(x, mask, weight, bias=None, taps=None):
    """x [B, C_in, F, T] f32 (channels-last, or made so); mask [B, 1, 1,
    T] in x's dtype; weight [C_out, C_in, 3, 3]; bias [C_out] or None;
    ``taps`` the weight in the kernel's layout, :func:`tap_major` of it
    where None (a caller keeps it between calls). CPU tensors take
    :func:`conv3x3_plain`; CUDA tensors launch the kernel or raise.
    Differentiable in x, weight and bias in both modes, through
    :class:`Conv3x3Fn` where a grad or a tangent may be asked for."""
    if taps is None:
        taps = tap_major(weight)
    if _build.needs_function([t for t in (x, weight, bias) if t is not None]):
        return Conv3x3Fn.apply(x, mask, weight, bias, taps)
    return _forward(x, mask, weight, bias, taps)


conv3x3.launches = 0
