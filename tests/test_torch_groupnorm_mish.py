"""K1: the port's plain GroupNorm+Mish against the JAX package's jnp twin
``_reference`` and its Pallas kernel run in interpret mode, and the CPU
wrapper's dispatch to the plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gradtts_tpu.ops.pallas import groupnorm_mish as jgn
from gradtts_tpu_torch.ops import groupnorm_mish as tgn


def _inputs(seed, B, F, T, C, tail):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, F, T, C)) * 2.0 + 0.5).astype(np.float32)
    mask = np.ones((B, 1, T, 1), np.float32)
    mask[-1, :, T - tail:] = 0.0                     # zero tail
    x *= mask                                        # as after conv(x * mask)
    gamma = rng.standard_normal(C).astype(np.float32)
    beta = rng.standard_normal(C).astype(np.float32)
    return x, mask, gamma, beta


def _torch(x, mask, gamma, beta, dtype):
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(mask).to(dtype),
            torch.from_numpy(gamma), torch.from_numpy(beta))


# f32: both sides sum in f32 in different orders over n = F*T*C/8 values;
# 1e-5 covers that. bf16: the inputs are the same bf16 values and the math
# f32 on both sides, so the outputs differ by at most one bf16 rounding
# (2^-8 relative) where an f32 difference straddles a rounding boundary.
_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=2 ** -8, atol=2 ** -8)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 8, 24, 16), (2, 4, 12, 32)])
def test_plain_matches_jnp_reference(shape, dtype):
    x, mask, gamma, beta = _inputs(0, *shape, tail=5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jgn._reference(jnp.asarray(x, jdt), jnp.asarray(mask, jdt),
                          jnp.asarray(gamma), jnp.asarray(beta), 8, 1e-5)
    got = tgn.groupnorm_mish_plain(*_torch(x, mask, gamma, beta, dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_TOL[dtype])


@pytest.mark.parametrize('shape', [(2, 8, 24, 16), (1, 4, 16, 32)])
def test_plain_matches_pallas_interpret(shape):
    # the Pallas kernel does not clamp the variance (:69); at these inputs
    # the variance is far from 0, so the clamp changes nothing
    x, mask, gamma, beta = _inputs(1, *shape, tail=3)
    want = jgn._forward(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(gamma),
                        jnp.asarray(beta), 8, 1e-5, interpret=True)
    got = tgn.groupnorm_mish_plain(*_torch(x, mask, gamma, beta,
                                           torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    x, mask, gamma, beta = _inputs(2, 2, 4, 8, 16, tail=2)
    args = _torch(x, mask, gamma, beta, torch.float32)
    before = tgn.groupnorm_mish.launches
    out = tgn.groupnorm_mish(*args)
    assert tgn.groupnorm_mish.launches == before
    torch.testing.assert_close(out, tgn.groupnorm_mish_plain(*args),
                               rtol=0, atol=0)
    # masked frames are exactly zero
    assert out[-1, :, -2:].abs().max().item() == 0.0


def _bad_inputs(case):
    x, mask, gamma, beta = _torch(*_inputs(3, 2, 4, 8, 16, tail=2),
                                  torch.float32)
    if case == 'not contiguous':
        x = x.transpose(1, 2)
    elif case == 'float16':
        x, mask = x.half(), mask.half()
    elif case == 'C not supported':
        x = torch.zeros(2, 4, 8, 24)
    elif case == 'mask dtype':
        mask = mask.double()
    elif case == 'gamma shape':
        gamma = gamma[:8]
    elif case == 'requires grad':
        x.requires_grad_(True)
    return x, mask, gamma, beta


@pytest.mark.parametrize('case,error', [
    ('not contiguous', ValueError), ('float16', TypeError),
    ('C not supported', ValueError), ('mask dtype', ValueError),
    ('gamma shape', ValueError), ('requires grad', None)])
def test_kernel_input_check_refuses(case, error):
    # the checks run before every CUDA launch; they take any device. A
    # tensor that needs a grad is taken: GroupNormMishFn does the backward
    if error is None:
        tgn._check(*_bad_inputs(case), groups=8)
        return
    with pytest.raises(error):
        tgn._check(*_bad_inputs(case), groups=8)


def test_kernel_input_check_accepts_the_u_net_inputs():
    tgn._check(*_bad_inputs('none'), groups=8)


@pytest.mark.parametrize('shape', [(2, 8, 24, 16), (2, 4, 12, 32)])
def test_grads_match_jax_vjp_of_reference(shape):
    # autograd through GroupNormMishFn (the backward recomputes the plain
    # version) against jax.vjp of _reference, for x, gamma and beta; f32
    # on both sides, sums over F*T*C/8 values in other orders: 1e-5 of
    # the largest grad
    x, mask, gamma, beta = _inputs(4, *shape, tail=5)
    dy = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, g, b: jgn._reference(a, jnp.asarray(mask), g,
                                                    b, 8, 1e-5),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(dy))
    args = [t.requires_grad_() if i != 1 else t for i, t in
            enumerate(_torch(x, mask, gamma, beta, torch.float32))]
    tgn.groupnorm_mish(*args).backward(torch.from_numpy(dy))
    for w, t in zip(want, (args[0], args[2], args[3])):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert args[1].grad is None


@pytest.fixture
def one_thread():
    # one intra-op thread: the grid is elementwise, and torch's CPU exp
    # must not depend on how the grid is cut into chunks
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mish_grid():
    # -1e4..1e4 in steps of 0.1 (0 and +-20 included), the region around
    # the kernel's v > 20 switch, and the exponential's overflow (v > 88.7)
    # and underflow (v < -87.3, outputs below the normal range)
    g = np.concatenate([np.linspace(-1e4, 1e4, 200001),
                        np.linspace(-110.0, 30.0, 140001),
                        [0.0, 20.0, -20.0, 88.7, 88.8, 1e4, -1e4],
                        np.nextafter(np.float32(20), np.float32([0, 40]))])
    return g.astype(np.float32)


def test_one_exponential_mish_matches_softplus_mish(one_thread):
    # csrc/groupnorm_mish.cu computes Mish as v n / (n + 2), n = e (e + 2),
    # e = exp(v); its CPU mirror against the plain version's softplus form
    # and the JAX package's _mish_f32: within 1e-6 relative in f32 where
    # exp(v) is a normal f32 (v > -87); below that the intermediates are
    # subnormal (or flushed to zero, as JAX sets the CPU to do), and both
    # forms must only stay under |v| exp(v) <= 87 exp(-87) < 2e-36
    y = _mish_grid()
    got = tgn.mish_one_exp(torch.from_numpy(y))
    normal = torch.from_numpy(y > -87.0)
    for want in (tgn.mish_f32(torch.from_numpy(y)),
                 torch.from_numpy(np.asarray(jgn._mish_f32(jnp.asarray(y))))):
        d = (got - want).abs()[normal]
        w = want.abs()[normal]
        assert bool((d <= 1e-6 * w).all()), float((d / w).max())
        assert float(want[~normal].abs().max()) < 2e-36
    assert float(got[~normal].abs().max()) < 2e-36
    assert bool(torch.isfinite(got).all())
    assert float(got[y == 0].abs().max()) == 0.0
    big = torch.from_numpy(y > 20)
    assert torch.equal(got[big], torch.from_numpy(y)[big])


def test_one_exponential_mish_rounds_to_bf16_as_softplus_mish(one_thread):
    # in bf16 the two forms round to the same value, except where the f32
    # values lie within their 1e-6 of a rounding midpoint: there the two
    # roundings are neighbours and the midpoint lies between the f32 values
    y = _mish_grid()
    a = tgn.mish_one_exp(torch.from_numpy(y))
    b = tgn.mish_f32(torch.from_numpy(y))
    ab, bb = a.bfloat16(), b.bfloat16()
    diff = ab != bb
    lo = torch.minimum(ab.float(), bb.float())[diff]
    hi = torch.maximum(ab.float(), bb.float())[diff]
    assert bool((torch.nextafter(lo.bfloat16(), hi.bfloat16()) == hi.bfloat16())
                .all())
    mid = (lo.double() + hi.double()) / 2
    fa, fb = a[diff].double(), b[diff].double()
    assert bool((((fa - mid) * (fb - mid)) <= 0).all())
    assert int(diff.sum()) <= 1e-3 * len(y)
