"""K4 + K5: the backward of the port's linear attention (the plain versions
of both sweeps and the host algebra between them, under autograd) against
``jax.vjp`` of the JAX package's ``fused_linear_attention_rezero`` (Pallas
in interpret mode, i.e. ``_backward_pallas``) and of its jnp twin
``_reference``; and the two sweeps' outputs against the Pallas sweeps'
outputs on the same inputs. Cases of tests/test_pallas.py:105-140."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gradtts_tpu.ops.pallas import linear_attention as jla
from gradtts_tpu_torch.ops import linear_attention as tla

NAMES = ('x', 'w_q', 'w_k', 'w_v', 'w_out', 'b_out', 'g')


def _inputs(seed, B, F, T, C, H):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in [(C, H)] * 3 + [(H, C)]]
    b_out = (rng.standard_normal(C) * 0.1).astype(np.float32)
    g = np.array([0.7], np.float32)
    dy = rng.standard_normal((B, F, T, C)).astype(np.float32)
    return [x, *ws, b_out, g], dy


def _jax_grads(fn, args, dy, dtype=jnp.float32):
    jargs = [jnp.asarray(args[0], dtype)] + [jnp.asarray(a) for a in args[1:]]
    _, vjp = jax.vjp(fn, *jargs)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dy, dtype))]


def _port_grads(args, dy, dim_head, chunk, dtype=torch.float32):
    targs = [torch.from_numpy(args[0]).to(dtype).requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in args[1:]]
    out = tla.linear_attention_rezero(*targs, dim_head=dim_head, chunk=chunk)
    out.backward(torch.from_numpy(dy).to(dtype))
    return [t.grad.float().numpy() for t in targs]


def _assert_close(got, want, frac):
    """Each grad within ``frac`` of its largest value."""
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=frac * np.abs(b).max(), err_msg=name)


# (B, F, T, C, H, dim_head, rows per Pallas backward tile): one tile; and
# several tiles with a ragged tail (9 * 5 = 45 rows in tiles of 16)
CASES = [dict(shape=(1, 4, 12, 16, 32), dim_head=8, tile=None),
         dict(shape=(2, 5, 9, 32, 32), dim_head=8, tile=16),
         dict(shape=(2, 4, 12, 16, 128), dim_head=32, tile=16)]


def _set_tile(monkeypatch, case):
    if case['tile'] is not None:
        C = case['shape'][3]
        monkeypatch.setattr(jla, '_BWD_TILE_LIMIT_BYTES',
                            case['tile'] * 2 * C * 4)


# f32 on both sides; the sums over the F*T rows (and for dWq, dWk, dWv over
# the batch too) run in other orders and, with several splits, through the
# exp(m_s - m) merge: 1e-5 of each grad's largest value
F32_FRAC = 1e-5


@pytest.mark.parametrize('n_splits', [1, 3])
@pytest.mark.parametrize('case', range(len(CASES)))
def test_grads_match_pallas_and_reference_vjp(monkeypatch, case, n_splits):
    case = CASES[case]
    _set_tile(monkeypatch, case)
    B, F, T, C, H = case['shape']
    dh = case['dim_head']
    args, dy = _inputs(case['dim_head'] + n_splits, B, F, T, C, H)
    got = _port_grads(args, dy, dh, -(-F * T // n_splits))
    pallas = _jax_grads(
        lambda *a: jla.fused_linear_attention_rezero(*a, dh), args, dy)
    ref = _jax_grads(lambda *a: jla._reference(*a, dim_head=dh), args, dy)
    _assert_close(got, pallas, F32_FRAC)
    _assert_close(got, ref, F32_FRAC)


def _capture_pallas_calls(monkeypatch):
    """Records the outputs of every pallas_call the JAX package runs."""
    outputs = []
    real = jla.pl.pallas_call

    def recording(*a, **kw):
        fn = real(*a, **kw)

        def run(*args):
            out = fn(*args)
            outputs.append(out)
            return out
        return run

    monkeypatch.setattr(jla.pl, 'pallas_call', recording)
    return outputs


@pytest.mark.parametrize('case', [1, 2])
def test_sweeps_match_pallas_sweeps(monkeypatch, case):
    case = CASES[case]
    _set_tile(monkeypatch, case)
    B, F, T, C, H = case['shape']
    dh = case['dim_head']
    args, dy = _inputs(11, B, F, T, C, H)
    x, w_q, w_k, w_v, w_out, b_out, g = map(jnp.asarray, args)
    _, ctx, den, m = jla._forward(x, w_q, w_k, w_v, w_out, b_out,
                                  jnp.float32(0.7), dh, 1, interpret=True)
    outputs = _capture_pallas_calls(monkeypatch)
    jla._backward_pallas(x, w_q, w_k, w_v, w_out, b_out, jnp.float32(0.7),
                         ctx, den, m, jnp.asarray(dy), dh, 1, interpret=True)
    assert len(outputs) == 2, 'the Pallas backward did not run'
    (da, dwq, db, dgv), (dx, dwk, dwv) = ([np.asarray(o) for o in out]
                                          for out in outputs)

    # the sweeps' inputs, built by the port's host algebra
    t = {k: torch.from_numpy(v) for k, v in zip(NAMES, args)}
    xr = t['x'].reshape(B, F * T, C)
    dyr = torch.from_numpy(dy).reshape(B, F * T, C)
    ctx_t, den_t = torch.from_numpy(np.array(ctx)), torch.from_numpy(
        np.array(den)).reshape(B, H)
    bd = tla.head_blockdiag(H, dh, 'cpu')
    ctx2n = ctx_t * bd / den_t[:, :, None]
    a_pre = ctx2n @ t['w_out']
    a_full_t = (a_pre * 0.7).transpose(1, 2).contiguous()
    got1 = tla.attention_bwd_sweep1_plain(xr, dyr, t['w_q'], a_full_t, a_pre,
                                          t['b_out'])
    for name, a, b in zip(('dA', 'dWq', 'db', 'dg'), got1,
                          (da, dwq, db[0], dgv[0])):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=F32_FRAC * np.abs(b).max(),
                                   err_msg=name)
    da_t = got1[0]
    dctx2n = torch.einsum('bdc,ec->bde', da_t, t['w_out']) * 0.7
    dctx = dctx2n * bd / den_t[:, :, None]
    dden = -(dctx2n * ctx_t * bd).sum(dim=2) / (den_t * den_t)
    got2 = tla.attention_bwd_sweep2_plain(
        xr, dyr, t['w_q'], t['w_k'], t['w_v'],
        torch.from_numpy(np.array(m)).reshape(B, H), a_full_t, dctx, dden,
        dh)
    for name, a, b in zip(('dx', 'dWk', 'dWv'), got2,
                          (dx.reshape(B, F * T, C), dwk, dwv)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=F32_FRAC * np.abs(b).max(),
                                   err_msg=name)


def test_bf16_grads_match_pallas_vjp(monkeypatch):
    # bf16 x with f32 weights, both packages rounding q, dq, dk, dv and v
    # to bf16 at the same points; the JAX package's bf16 tolerance for the
    # attention (tests/test_pallas.py: 2e-2) of each grad's largest value
    case = CASES[1]
    _set_tile(monkeypatch, case)
    B, F, T, C, H = case['shape']
    args, dy = _inputs(12, B, F, T, C, H)
    got = _port_grads(args, dy, 8, 16, torch.bfloat16)
    want = _jax_grads(lambda *a: jla.fused_linear_attention_rezero(*a, 8),
                      args, dy, jnp.bfloat16)
    _assert_close(got, want, 2e-2)


def test_wrapper_takes_plain_sweeps_on_cpu():
    args, dy = _inputs(13, 2, 4, 8, 16, 128)
    before = (tla.attention_bwd_sweep1.launches,
              tla.attention_bwd_sweep2.launches)
    got = _port_grads(args, dy, 32, None)
    assert (tla.attention_bwd_sweep1.launches,
            tla.attention_bwd_sweep2.launches) == before
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tla.linear_attention_rezero_plain(*targs, dim_head=32).backward(
        torch.from_numpy(dy))
    for a, t in zip(got, targs):
        np.testing.assert_array_equal(a, t.grad.numpy())


@pytest.mark.parametrize('B,N,C', [(16, 13760, 64), (16, 3440, 128),
                                   (16, 860, 256), (16, 860, 128),
                                   (16, 3440, 64), (1, 1001, 64),
                                   (8, 100, 256), (2, 64, 16)])
def test_bwd2_split_chunks_tile_the_rows_in_one_wave(B, N, C):
    # K5's bf16 splits: whole 64-row tiles (dx) and 128-row tiles (dW);
    # each grid fits the card at its blocks an SM (one wave); the splits
    # cover N with no empty split; a dx split spans two tiles where N
    # allows
    chunk, chunk_w = tla.bwd2_split_chunks(B, N, C)
    assert chunk % 64 == 0 and chunk_w % 128 == 0
    S, S_w = -(-N // chunk), -(-N // chunk_w)
    assert (S - 1) * chunk < N and (S_w - 1) * chunk_w < N
    assert B * S <= (2 if C <= 64 else 1) * 132 or S == 1
    assert B * S_w * 4 <= (2 if C < 256 else 1) * 132 or S_w == 1
    if N >= 2 * 64 * S:
        assert chunk >= 128


def _sweep1_inputs(seed, B, N, C, H):
    """K4's inputs as the backward hands them over, f32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((B, N, C), 1.0), ((B, N, C), 1.0), ((C, H), 0.3), ((B, C, H), 0.1),
        ((B, H, C), 0.1), ((C,), 0.1))]
    return [torch.from_numpy(a) for a in t]


@pytest.mark.parametrize('C', [16, 64])
def test_sweep1_dgv_reassociated_and_q_split_match_pallas(C):
    # The bf16 K4 kernel forms dgv without the o = round(q) A_pre product:
    # summed over the rows, dy * o reassociates to sum_h A_pre[h, c]
    # (round(q)^T dy)[h, c], plus b_out db; and it keeps q f32 for dA as
    # bf16 hi + lo parts, dA = hi^T dy + lo^T dy. Both routes, in f32, at
    # a ragged N (5 * 9 = 45 rows in Pallas tiles of 16), against the plain
    # sweep and the dgv and dA of _bwd_sweep1_kernel in interpret mode.
    B, F, T, H = 2, 5, 9, 128
    N = F * T
    # the bf16 route's inputs (f32 values rounded to bf16), where q is
    # rounded before o; every product in f32
    *ins, b_out = _sweep1_inputs(20 + C, B, N, C, H)
    x, dy, w_q, a_full_t, a_pre = (t.to(torch.bfloat16) for t in ins)
    call = jla.pl.pallas_call(
        functools.partial(jla._bwd_sweep1_kernel, n_total=N, n_tile=16),
        grid=(B, -(-N // 16)),
        in_specs=[jla.pl.BlockSpec((1, 16, C), lambda b, t: (b, t, 0))] * 2
        + [jla.pl.BlockSpec((C, H), lambda b, t: (0, 0)),
           jla.pl.BlockSpec((1, C, H), lambda b, t: (b, 0, 0)),
           jla.pl.BlockSpec((1, H, C), lambda b, t: (b, 0, 0)),
           jla.pl.BlockSpec((1, C), lambda b, t: (0, 0))],
        out_specs=[jla.pl.BlockSpec((1, H, C), lambda b, t: (b, 0, 0)),
                   jla.pl.BlockSpec((C, H), lambda b, t: (0, 0)),
                   jla.pl.BlockSpec((1, C), lambda b, t: (0, 0)),
                   jla.pl.BlockSpec((1, C), lambda b, t: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((B, H, C), jnp.float32),
                   jax.ShapeDtypeStruct((C, H), jnp.float32),
                   jax.ShapeDtypeStruct((1, C), jnp.float32),
                   jax.ShapeDtypeStruct((1, C), jnp.float32)],
        scratch_shapes=[jla.pltpu.VMEM((H, C), jnp.float32),
                        jla.pltpu.VMEM((C, H), jnp.float32),
                        jla.pltpu.VMEM((1, C), jnp.float32),
                        jla.pltpu.VMEM((1, C), jnp.float32)],
        interpret=True)
    da_p, _, _, dgv_p = (np.asarray(o) for o in call(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
          for t in (x, dy, w_q, a_full_t, a_pre)),
        jnp.asarray(b_out.numpy())[None]))

    da, _, db, dgv = tla.attention_bwd_sweep1_plain(x, dy, w_q, a_full_t,
                                                    a_pre, b_out)
    x, dy, w_q, a_pre = (t.float() for t in (x, dy, w_q, a_pre))
    q = x @ w_q                                       # f32, as the kernel's
    hi = q.to(torch.bfloat16).float()
    lo = (q - hi).to(torch.bfloat16).float()
    da_hi = hi.transpose(1, 2) @ dy                   # [B, H, C]
    dgv_re = (a_pre * da_hi).sum(dim=(0, 1)) + b_out * db
    da_split = da_hi + lo.transpose(1, 2) @ dy
    # f32 sums in other orders: 1e-5 of the largest value; the split drops
    # ~2^-17 of each q
    for name, got, want in (('dgv', dgv_re, dgv), ('dgv', dgv_re, dgv_p[0]),
                            ('dA', da_split, da), ('dA', da_split, da_p)):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                   atol=F32_FRAC * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize('B,N,C', [(16, 13760, 64), (16, 3440, 128),
                                   (16, 860, 256), (16, 860, 128),
                                   (16, 3440, 64), (1, 1001, 64),
                                   (8, 100, 256), (2, 64, 16)])
def test_bwd1_split_chunks_tile_the_rows_in_one_wave(B, N, C):
    # K4's bf16 splits: whole tiles (128 rows at C <= 64, else 64); the
    # grid of (S, B, 4 heads) fits the card at its blocks an SM (one
    # wave); the splits cover N with no empty split
    chunk = tla.bwd1_split_chunks(B, N, C)
    assert chunk % (128 if C <= 64 else 64) == 0
    S = -(-N // chunk)
    assert (S - 1) * chunk < N <= S * chunk
    assert B * S * 4 <= (2 if C <= 128 else 1) * 132 or S == 1
