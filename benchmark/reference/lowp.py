"""The precision a reference layer computes in.

Every matrix product of the reference (convolutions, linear layers, the
attention products) takes its operands through :func:`operand`. In f32 it
returns them as they are; the control of the output check sets
``LowPrecision.fmt`` to ``'fp8'``, which rounds each operand to float8 e4m3
under a per-tensor scale (its largest magnitude maps to 448, e4m3's
largest), with the product still accumulated in f32: the arithmetic of an
fp8 matmul. The rounding passes gradients through unchanged (straight
through), so a training step runs in it too. TF32, the control of the f32
cells, is the backends' own switch and needs nothing here.
"""

import torch

E4M3_MAX = 448.0


class LowPrecision:
    """Holder of the operand format of one reference model: None (f32) or
    'fp8'. Layers share one instance."""

    def __init__(self, fmt=None):
        if fmt not in (None, 'fp8'):
            raise ValueError(f'unknown operand format {fmt!r}')
        self.fmt = fmt


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def operand(lp: LowPrecision, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the product of ``lp``'s format reads it."""
    if lp is None or lp.fmt is None:
        return x
    return _fp8(x)
