"""The CUDA kernels against their plain versions on an NVIDIA GPU; skipped
without one. JAX-free, so it also runs where JAX is not installed:

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
