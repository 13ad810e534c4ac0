"""The CUDA kernels (K1-K5, MAS) against their plain versions on an NVIDIA
GPU; skipped without one. JAX-free, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gradtts_tpu_torch.ops import groupnorm_mish as tgn
from gradtts_tpu_torch.ops import linear_attention as tla


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_groupnorm_mish_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 40, 96, 64)), dtype=dtype,
                     device=cuda)
    mask = torch.ones((2, 1, 96, 1), dtype=dtype, device=cuda)
    mask[1, :, 70:] = 0
    gamma = torch.tensor(rng.standard_normal(64), dtype=torch.float32,
                         device=cuda)
    beta = torch.tensor(rng.standard_normal(64), dtype=torch.float32,
                        device=cuda)
    got = tgn.groupnorm_mish(x * mask, mask, gamma, beta)
    torch.cuda.synchronize()
    want = tgn.groupnorm_mish_plain(x * mask, mask, gamma, beta)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_linear_attention_kernels_match_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    C = 128

    def t(shape, scale=1.0, dt=torch.float32):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dt,
                            device=cuda)

    args = (t((2, 40, 96, C), dt=dtype), t((C, 128), 0.1), t((C, 128), 0.1),
            t((C, 128), 0.1), t((128, C), 0.1), t((C,), 0.1),
            torch.tensor([0.7], device=cuda))
    got = tla.linear_attention_rezero(*args)
    torch.cuda.synchronize()
    want = tla.linear_attention_rezero_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_linear_attention_backward_kernels_match_plain(cuda, dtype):
    # K4 + K5 under autograd against the plain sweeps, at a ragged row count
    # (40 * 43 rows); f32 weights under a bf16 x, as in the U-Net
    rng = np.random.default_rng(2)
    C = 64

    def t(shape, scale=1.0, dt=torch.float32):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dt,
                            device=cuda)

    args = (t((4, 40, 43, C), dt=dtype), t((C, 128), 0.1), t((C, 128), 0.1),
            t((C, 128), 0.1), t((128, C), 0.1), t((C,), 0.1),
            torch.tensor([0.7], device=cuda))
    dy = t((4, 40, 43, C), dt=dtype)
    grads = []
    for fn in (tla.linear_attention_rezero, tla.linear_attention_rezero_plain):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        fn(*leaves).backward(dy)
        grads.append([a.grad.float() for a in leaves])
    torch.cuda.synchronize()
    # each grad within tol of its largest value: batch-wide f32 sums in
    # other orders, and in bf16 the rare rounding of an intermediate that
    # lands on the other side of a boundary
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


@pytest.mark.cuda
def test_maximum_path_kernel_equals_plain(cuda):
    from gradtts_tpu_torch.ops import mas
    rng = np.random.default_rng(3)
    # Tx above the kernel's 512 threads, ragged lengths
    B, tx, ty = 3, 600, 1400
    t_x, t_y = [600, 300, 17], [1400, 900, 40]
    mask = torch.zeros((B, tx, ty), device=cuda)
    for i in range(B):
        mask[i, :t_x[i], :t_y[i]] = 1.0
    value = torch.tensor(rng.standard_normal((B, tx, ty)) * 30.0 - 100.0,
                         dtype=torch.float32, device=cuda)
    got = mas.maximum_path(value, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, mas.maximum_path_plain(value, mask))
