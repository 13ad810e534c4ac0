"""K6 + K7: the forward-mode tangent of the port's linear attention (the
plain versions of both sweeps, the split merge and the tangent fold, under
``torch.func.jvp``) against ``jax.jvp`` of the JAX package's
``fused_linear_attention_rezero_jvp`` (Pallas in interpret mode, i.e.
``_jvp_pallas``) and of its jnp twin ``_reference``; the two sweeps'
outputs against the Pallas sweeps' outputs on the same inputs; and the
forward-mode rule of the GroupNorm+Mish Function against ``jax.jvp`` of the
JAX ``_reference``. Cases of tests/test_pallas.py:205-275."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gradtts_tpu.ops.pallas import groupnorm_mish as jgn
from gradtts_tpu.ops.pallas import linear_attention as jla
from gradtts_tpu_torch.ops import groupnorm_mish as tgn
from gradtts_tpu_torch.ops import linear_attention as tla


def _inputs(seed, B, F, T, C, H):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in [(C, H)] * 3 + [(H, C)]]
    b_out = (rng.standard_normal(C) * 0.1).astype(np.float32)
    g = np.array([0.7], np.float32)
    return [x, *ws, b_out, g]


def _tangents(seed, args):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(a.shape) * (1.0 if i == 0 else 0.1))
            .astype(np.float32) for i, a in enumerate(args)]


# (B, F, T, C, H, dim_head, rows per Pallas jvp tile): one tile; several
# tiles with a ragged tail (6 * 9 = 54 rows in tiles of 48); the U-Net's
# H 128 / dim_head 32 with a ragged tail (5 * 9 = 45 rows in tiles of 16)
CASES = [dict(shape=(2, 4, 12, 16, 32), dim_head=8, tile=None),
         dict(shape=(1, 6, 9, 16, 32), dim_head=8, tile=48),
         dict(shape=(2, 5, 9, 32, 128), dim_head=32, tile=16)]


def _set_tile(monkeypatch, case):
    if case['tile'] is not None:     # _pick_n_tile reads 2C f32 per row
        C = case['shape'][3]
        monkeypatch.setattr(jla, '_TILE_LIMIT_BYTES',
                            case['tile'] * 2 * C * 4)


# f32 on both sides; the sums over the F*T rows run in other orders and,
# with several splits, through the exp(m_s - m) merge: each output within
# 1e-5 of its largest value
F32_FRAC = 1e-5


def _close(got, want, frac, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=what)


def _port_jvp(args, tans, dim_head, chunk, x_only, dtype=torch.float32):
    prim = [torch.from_numpy(args[0]).to(dtype)] + [
        torch.from_numpy(a) for a in args[1:]]
    tan = [torch.from_numpy(tans[0]).to(dtype)] + [
        torch.from_numpy(t) for t in tans[1:]]

    def fn(*a):
        return tla.linear_attention_rezero(*a, dim_head=dim_head, chunk=chunk)

    if x_only:
        return torch.func.jvp(lambda x: fn(x, *prim[1:]), (prim[0],),
                              (tan[0],))
    return torch.func.jvp(fn, tuple(prim), tuple(tan))


def _jax_jvp(fn, args, tans, x_only, dtype=jnp.float32):
    prim = [jnp.asarray(args[0], dtype)] + [jnp.asarray(a) for a in args[1:]]
    tan = [jnp.asarray(tans[0], dtype)] + [jnp.asarray(t) for t in tans[1:]]
    if x_only:
        return jax.jvp(lambda x: fn(x, *prim[1:]), (prim[0],), (tan[0],))
    return jax.jvp(fn, tuple(prim), tuple(tan))


@pytest.mark.parametrize('x_only', [False, True])
@pytest.mark.parametrize('n_splits', [1, 3])
@pytest.mark.parametrize('case', range(len(CASES)))
def test_jvp_matches_pallas_and_reference_jvp(monkeypatch, case, n_splits,
                                              x_only):
    case = CASES[case]
    _set_tile(monkeypatch, case)
    B, F, T, C, H = case['shape']
    dh = case['dim_head']
    args = _inputs(dh + n_splits, B, F, T, C, H)
    tans = _tangents(dh + 7, args)
    y, dy = _port_jvp(args, tans, dh, -(-F * T // n_splits), x_only)
    for fn in (lambda *a: jla.fused_linear_attention_rezero_jvp(*a, dh),
               lambda *a: jla._reference(*a, dim_head=dh)):
        y_j, dy_j = _jax_jvp(fn, args, tans, x_only)
        _close(y.numpy(), y_j, F32_FRAC, 'y')
        _close(dy.numpy(), dy_j, F32_FRAC, 'dy')


class _LaunchRecorder:
    """Stands in for the kernels' library: records the (B, N, C, chunk, S)
    that each C entry point is launched with (its arguments before dtype
    and stream) and reports success."""

    def __init__(self):
        self.launches = []

    def __getattr__(self, name):
        def launch(*args):
            self.launches.append((name, args[-7:-2]))
            return 0
        return launch


@pytest.mark.parametrize('x_only', [False, True])
def test_default_splits_are_whole_tiles_and_match_pallas_jvp(monkeypatch,
                                                             x_only):
    # ragged N (5 * 45 = 225 rows) at the U-Net's H 128, dim_head 32, under
    # the default chunk. (a) The CUDA wrappers hand K6 and K7 whole 64-row
    # splits: their launch arguments, recorded on the meta device (a
    # non-CPU tensor that takes the kernels' route without data). (b) The
    # tangent on the CPU matches jax.jvp of the Pallas jvp (interpret mode).
    B, F, T, C, H = 2, 5, 45, 32, 128
    N = F * T
    args = _inputs(61, B, F, T, C, H)
    tans = _tangents(62, args)
    lib = _LaunchRecorder()
    monkeypatch.setattr(tla._build, 'load', lambda name: lib)
    monkeypatch.setattr(tla._build, 'stream_of', lambda t: 0)
    prim = [torch.from_numpy(a).to('meta') for a in args]
    tan = [torch.from_numpy(t).to('meta') for t in tans]
    with torch.no_grad():
        if x_only:
            out = torch.func.jvp(
                lambda x: tla.linear_attention_rezero(x, *prim[1:]),
                (prim[0],), (tan[0],))
        else:
            out = torch.func.jvp(tla.linear_attention_rezero, tuple(prim),
                                 tuple(tan))
    assert all(o.shape == (B, F, T, C) for o in out)
    jvp = {name: a for name, a in lib.launches if 'jvp' in name}
    assert set(jvp) == {'gtt_la_jvp_stats', 'gtt_la_jvp_apply'}
    for name, (b, n, c, chunk, splits) in jvp.items():
        assert (b, n, c) == (B, N, C), name
        assert chunk % tla._TC_ROWS == 0 and chunk < N, name
        assert splits == -(-N // chunk), name

    monkeypatch.undo()
    y, dy = _port_jvp(args, tans, 32, None, x_only)
    y_j, dy_j = _jax_jvp(
        lambda *a: jla.fused_linear_attention_rezero_jvp(*a, 32), args, tans,
        x_only)
    _close(y.numpy(), y_j, F32_FRAC, 'y')
    _close(dy.numpy(), dy_j, F32_FRAC, 'dy')


def test_bf16_jvp_matches_pallas_jvp(monkeypatch):
    # bf16 x and tangent with f32 weights, both packages rounding q, dq, A,
    # dA, y and dy to bf16 at the same points; the JAX package's bf16
    # tolerance for the attention (tests/test_pallas.py: 2e-2) of each
    # output's largest value
    case = CASES[2]
    _set_tile(monkeypatch, case)
    B, F, T, C, H = case['shape']
    args = _inputs(21, B, F, T, C, H)
    tans = _tangents(22, args)
    y, dy = _port_jvp(args, tans, 32, 16, False, torch.bfloat16)
    y_j, dy_j = _jax_jvp(
        lambda *a: jla.fused_linear_attention_rezero_jvp(*a, 32), args,
        tans, False, jnp.bfloat16)
    assert y.dtype == dy.dtype == torch.bfloat16
    _close(y.float().numpy(), y_j, 2e-2, 'y')
    _close(dy.float().numpy(), dy_j, 2e-2, 'dy')


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


def _blocks(full, dim_head):
    """[B, H, H] -> its head-diagonal blocks [B, H / dh, dh, dh]."""
    B, H, _ = full.shape
    nh = H // dim_head
    r = full.reshape(B, nh, dim_head, nh, dim_head)
    return np.stack([r[:, h, :, h, :] for h in range(nh)], axis=1)


@pytest.mark.parametrize('weight_tangents', [True, False])
@pytest.mark.parametrize('case', [1, 2])
def test_sweeps_match_pallas_jvp_sweeps(monkeypatch, case, weight_tangents):
    case = CASES[case]
    _set_tile(monkeypatch, case)
    B, F, T, C, H = case['shape']
    dh = case['dim_head']
    args = _inputs(31, B, F, T, C, H)
    tans = _tangents(32, args)
    if not weight_tangents:           # the Hutchinson probe: dx only
        tans = [tans[0]] + [np.zeros_like(t) for t in tans[1:]]
    x, w_q, w_k, w_v, w_out, b_out, g = map(jnp.asarray, args)
    dx, dwq, dwk, dwv, dwo, dbo, dg = map(jnp.asarray, tans)
    outputs = _capture_pallas_calls(monkeypatch)
    jla._jvp_pallas(x, dx, w_q, dwq, w_k, dwk, w_v, dwv, w_out, dwo, b_out,
                    dbo, jnp.float32(0.7), dg.reshape(()), dh, 1,
                    interpret=True)
    assert len(outputs) == 2, 'the Pallas jvp sweeps did not run'
    (ctx, den, m, dctx, dden), (y, dy) = ([np.asarray(o) for o in out]
                                          for out in outputs)

    t = [torch.from_numpy(a) for a in args]
    tt = [torch.from_numpy(a) for a in tans]
    xr, dxr = t[0].reshape(B, F * T, C), tt[0].reshape(B, F * T, C)
    dw = (tt[2], tt[3]) if weight_tangents else (None, None)
    # one split is the Pallas sweep itself; three go through the merge
    for chunk in (F * T, -(-F * T // 3)):
        got = tla.attention_jvp_stats_plain(xr, dxr, t[2], t[3], *dw, chunk,
                                            dh)
        m_t, ctx_t, den_t, dctx_t, dden_t = got
        if chunk == F * T:
            _close(m_t[:, 0], m.reshape(B, H), F32_FRAC, 'm')
        merged = tla.merge_jvp_stats(*got)
        for name, a, b in zip(('ctx', 'den', 'dctx', 'dden'), merged,
                              (_blocks(ctx, dh), den.reshape(B, H),
                               _blocks(dctx, dh), dden.reshape(B, H))):
            _close(a.numpy(), b, F32_FRAC, f'{name} ({chunk}-row splits)')

    # K7's inputs, folded by the port from the Pallas statistics
    blk = [torch.from_numpy(np.ascontiguousarray(v)) for v in (
        _blocks(ctx, dh), den.reshape(B, H), _blocks(dctx, dh),
        dden.reshape(B, H))]
    a, da, bias, dbias = tla.fold_context_jvp(
        *blk, t[4], t[5], t[6], *(tt[4:] if weight_tangents
                                  else (None, None, None)))
    got_y, got_dy = tla.attention_jvp_apply_plain(
        xr, dxr, t[1], tt[1] if weight_tangents else None, a, da, bias,
        dbias)
    _close(got_y.numpy(), y.reshape(B, F * T, C), F32_FRAC, 'y')
    _close(got_dy.numpy(), dy.reshape(B, F * T, C), F32_FRAC, 'dy')


@pytest.mark.parametrize('mode', ['torch.func', 'forward_ad'])
def test_function_jvp_runs_the_sweeps_under_no_grad(monkeypatch, mode):
    # the Hutchinson pattern: no autograd, weights that need no grad, a
    # tangent on x only. requires_grad shows nothing, so the entry point
    # must see the tangent itself; the Function's rule must run the sweeps
    # on plain tensors (no torch.func wrapper, whose data a kernel could not
    # read) and take the variants without weight tangents
    calls = []
    for name in ('attention_jvp_stats_plain', 'attention_jvp_apply_plain'):
        real = getattr(tla, name)

        def counting(*a, _real=real, _name=name):
            a[0].data_ptr(), a[1].data_ptr()        # raise if wrapped
            weight_tangents = a[4:6] if 'stats' in _name else a[3:4]
            calls.append((_name, all(w is None for w in weight_tangents)))
            return _real(*a)
        monkeypatch.setattr(tla, name, counting)
    args = [torch.from_numpy(a) for a in _inputs(41, 2, 4, 8, 32, 128)]
    dx = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tla.linear_attention_rezero(*args)     # no tangent: no jvp sweeps
        assert calls == []
        if mode == 'torch.func':
            y, dy = torch.func.jvp(
                lambda x: tla.linear_attention_rezero(x, *args[1:]),
                (args[0],), (dx,))
        else:
            import torch.autograd.forward_ad as fwad
            with fwad.dual_level():
                out = fwad.unpack_dual(tla.linear_attention_rezero(
                    fwad.make_dual(args[0], dx), *args[1:]))
                y, dy = out.primal, out.tangent
    assert calls == [('attention_jvp_stats_plain', True),
                     ('attention_jvp_apply_plain', True)]
    want_y, want_dy = torch.func.jvp(
        lambda x: tla.linear_attention_rezero_plain(x, *args[1:]),
        (args[0],), (dx,))
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(dy, want_dy, rtol=0, atol=0)


def test_groupnorm_mish_jvp_matches_jax_reference(monkeypatch):
    rng = np.random.default_rng(51)
    B, F, T, C = 2, 6, 10, 32
    x = rng.standard_normal((B, F, T, C)).astype(np.float32) * 2 + 0.5
    mask = np.ones((B, 1, T, 1), np.float32)
    mask[1, :, 7:] = 0
    gamma, beta = (rng.standard_normal(C).astype(np.float32)
                   for _ in range(2))
    dx, dgamma, dbeta = (rng.standard_normal(a.shape).astype(np.float32)
                         for a in (x, gamma, beta))
    seen = []
    monkeypatch.setattr(tgn.GroupNormMishFn, 'jvp', staticmethod(
        lambda ctx, *t, _real=tgn.GroupNormMishFn.jvp: seen.append(1)
        or _real(ctx, *t)))
    tm = torch.from_numpy(mask)
    for n_moving in (1, 3):           # x only (Hutchinson), and all three
        prim = [torch.from_numpy(a) for a in (x, gamma, beta)][:n_moving]
        tan = [torch.from_numpy(a) for a in (dx, dgamma, dbeta)][:n_moving]
        rest = [torch.from_numpy(a) for a in (x, gamma, beta)][n_moving:]
        with torch.no_grad():
            y, dy = torch.func.jvp(
                lambda *p: tgn.groupnorm_mish(p[0], tm, *(list(p[1:]) + rest)),
                tuple(prim), tuple(tan))
        jrest = [jnp.asarray(a) for a in (x, gamma, beta)][n_moving:]
        y_j, dy_j = jax.jvp(
            lambda *p: jgn._reference(p[0], jnp.asarray(mask),
                                      *(list(p[1:]) + jrest), 8, 1e-5),
            tuple(jnp.asarray(a) for a in (x, gamma, beta)[:n_moving]),
            tuple(jnp.asarray(a) for a in (dx, dgamma, dbeta)[:n_moving]))
        # f32 statistics over F*T*C/8 values in other orders: 1e-5 of the
        # largest value
        _close(y.numpy(), y_j, F32_FRAC, 'y')
        _close(dy.numpy(), dy_j, F32_FRAC, 'dy')
    assert len(seen) == 2, 'the Function\'s jvp rule did not run'
