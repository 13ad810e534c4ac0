"""K2 + K3: the port's plain linear attention against the JAX package's
jnp twin ``_reference`` and the intermediate statistics of its Pallas
kernels run in interpret mode, with the cases of tests/test_pallas.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gradtts_tpu.ops.pallas import linear_attention as jla
from gradtts_tpu_torch.ops import linear_attention as tla


def _inputs(seed, B=2, F=8, T=24, C=32, H=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, T, C)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in [(C, H)] * 3 + [(H, C)]]
    b_out = (rng.standard_normal(C) * 0.1).astype(np.float32)
    g = np.array([0.7], np.float32)
    return [x, *ws, b_out, g]


def _chunk(n_rows, n_splits):
    return -(-n_rows // n_splits)


def _diag_blocks(full, dim_head):
    """[..., H, H] -> its head-diagonal blocks [..., H / dim_head,
    dim_head, dim_head]."""
    n = full.shape[-1] // dim_head
    return np.stack([full[..., h * dim_head:(h + 1) * dim_head,
                          h * dim_head:(h + 1) * dim_head]
                     for h in range(n)], axis=-3)


# f32 on both sides; sums over up to F*T rows in different orders (and, for
# n_splits > 1, merged through exp(m_s - m)) differ by a few f32 ulps of the
# largest terms: 1e-5 relative and absolute.
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('n_splits', [1, 3])
@pytest.mark.parametrize('case', [
    dict(B=2, F=8, T=24, C=32, H=64, dim_head=16),    # test_pallas parity
    dict(B=1, F=5, T=9, C=32, H=32, dim_head=8),      # ragged tail
    dict(B=2, F=4, T=12, C=16, H=128, dim_head=32),   # the U-Net's heads
])
def test_plain_matches_jnp_reference(case, n_splits):
    case = dict(case)
    dim_head = case.pop('dim_head')
    args = _inputs(0, **case)
    want = jla._reference(*map(jnp.asarray, args), dim_head=dim_head)
    n = case['F'] * case['T']
    got = tla.linear_attention_rezero_plain(
        *map(torch.from_numpy, args), dim_head=dim_head,
        chunk=_chunk(n, n_splits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize('n_splits', [1, 3])
def test_merged_stats_match_pallas_interpret(monkeypatch, n_splits):
    # several Pallas tiles with a ragged tail: 8 rows per tile over 45 rows
    monkeypatch.setattr(jla, '_TILE_LIMIT_BYTES', 8 * 32 * 4)
    x, w_q, w_k, w_v, w_out, b_out, g = _inputs(1, B=2, F=5, T=9, C=32, H=32)
    out, ctx, den, m = jla._forward(
        *map(jnp.asarray, (x, w_q, w_k, w_v, w_out, b_out)),
        jnp.float32(0.7), 8, 1, interpret=True)
    xr = torch.from_numpy(x).reshape(2, 45, 32)
    tm, tctx, tden = tla.merge_stats(*tla.attention_stats_plain(
        xr, torch.from_numpy(w_k), torch.from_numpy(w_v),
        _chunk(45, n_splits), dim_head=8))
    np.testing.assert_allclose(tm.numpy(), np.asarray(m)[:, 0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tden.numpy(), np.asarray(den)[:, 0],
                               **F32_TOL)
    # the port keeps the head-diagonal blocks of the Pallas kernel's [H, H]
    assert tctx.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(tctx.numpy(), _diag_blocks(np.asarray(ctx), 8),
                               **F32_TOL)
    got = tla.linear_attention_rezero_plain(
        *map(torch.from_numpy, (x, w_q, w_k, w_v, w_out, b_out, g)),
        dim_head=8, chunk=_chunk(45, n_splits))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **F32_TOL)


def test_per_head_block_diagonal():
    # a change of v in head 0's columns may move only head 0's context rows
    x, w_q, w_k, w_v, w_out, b_out, g = _inputs(2, B=1, F=4, T=6, C=16,
                                                 H=32)
    w_v2 = w_v.copy()
    w_v2[:, :8] += 1.0                                      # head 0 of 4
    ctxs = []
    for wv in (w_v, w_v2):
        m, ctx, den = tla.merge_stats(*tla.attention_stats_plain(
            torch.from_numpy(x).reshape(1, 24, 16), torch.from_numpy(w_k),
            torch.from_numpy(wv), 24, dim_head=8))
        ctxs.append(tla.fold_context(ctx, den, torch.eye(32), torch.zeros(32),
                                     torch.ones(1))[0][0])
    diff = (ctxs[0] - ctxs[1]).abs()
    assert diff[:8, :8].max() > 0
    assert diff[8:].max() == 0 and diff[:, 8:].max() == 0


def test_plain_bf16_matches_jnp_reference():
    # bf16: JAX's _reference rounds exp(k - m) and v to bf16 before the
    # context product, the port keeps them f32 (as the kernels do); the
    # outputs then differ by a few bf16 ulps of the residual x
    args = _inputs(3, B=2, F=4, T=12, C=16, H=128)
    want = jla._reference(jnp.asarray(args[0], jnp.bfloat16),
                          *map(jnp.asarray, args[1:]), dim_head=32)
    got = tla.linear_attention_rezero_plain(
        torch.from_numpy(args[0]).bfloat16(),
        *map(torch.from_numpy, args[1:]), dim_head=32, chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(4, B=2, F=4, T=8, C=16,
                                                  H=128)]
    before = (tla.attention_stats.launches, tla.attention_apply.launches)
    out = tla.linear_attention_rezero(*args, dim_head=32)
    assert (tla.attention_stats.launches,
            tla.attention_apply.launches) == before
    torch.testing.assert_close(
        out, tla.linear_attention_rezero_plain(*args, dim_head=32),
        rtol=0, atol=0)


@pytest.mark.parametrize('case,error', [
    ('ok', None), ('H not 128', ValueError), ('weight dtype', ValueError),
    ('x not contiguous', ValueError), ('C not supported', ValueError),
    ('float16', TypeError), ('requires grad', None)])
def test_kernel_input_check(case, error):
    # the checks run before every CUDA launch; they take any device. A
    # weight that needs a grad is taken: LinearAttentionRezeroFn does the
    # backward
    x = torch.zeros(2, 24, 32)
    w = torch.zeros(32, tla.HIDDEN)
    if case == 'H not 128':
        w = torch.zeros(32, 64)
    elif case == 'weight dtype':
        w = w.bfloat16()
    elif case == 'x not contiguous':
        x = torch.zeros(2, 32, 24).transpose(1, 2)
    elif case == 'C not supported':
        x, w = torch.zeros(2, 24, 48), torch.zeros(48, tla.HIDDEN)
    elif case == 'float16':
        x, w = x.half(), w.half()
    elif case == 'requires grad':
        w.requires_grad_(True)
    C = x.shape[2]

    def check():
        tla._check('attention_stats', x, {'w_k': w, 'w_v': w},
                   [((C, tla.HIDDEN), x.dtype)] * 2)

    if error is None:
        check()
    else:
        with pytest.raises(error):
            check()


def _full_fold(x, w_k, w_v, w_out, b_out, g, chunk, dim_head):
    """The fold as it was before K2 kept head blocks: full [H, H] context
    per split, merged with exp(m_s - m), head block-diagonal mask, / den,
    @ Wout, * g."""
    ms, ctxs, dens = [], [], []
    for xs in torch.split(x, chunk, dim=1):
        k, v = xs @ w_k, xs @ w_v
        m = k.amax(dim=1)
        ek = torch.exp(k - m[:, None, :])
        ms.append(m)
        ctxs.append(ek.transpose(1, 2) @ v)
        dens.append(ek.sum(dim=1))
    m, ctx, den = torch.stack(ms, 1), torch.stack(ctxs, 1), torch.stack(dens,
                                                                        1)
    alpha = torch.exp(m - m.amax(dim=1)[:, None, :])
    ctx = (ctx * alpha[..., None]).sum(dim=1)
    den = (den * alpha).sum(dim=1)
    bd = tla.head_blockdiag(ctx.shape[-1], dim_head, 'cpu')
    ctx2 = ((ctx * bd) / den[:, :, None]) @ w_out * g
    return ctx2, b_out * g


@pytest.mark.parametrize('n_splits', [1, 3])
@pytest.mark.parametrize('H,dim_head', [(32, 8), (128, 32)])
def test_block_fold_matches_full_matrix_fold(H, dim_head, n_splits):
    # merge_stats + fold_context on head blocks give the ctx2 and bias of
    # the full-matrix fold on the same inputs; only f32 sums in other
    # orders differ
    x, w_q, w_k, w_v, w_out, b_out, g = map(
        torch.from_numpy, _inputs(5, B=2, F=5, T=9, C=32, H=H))
    xr = x.reshape(2, 45, 32)
    chunk = _chunk(45, n_splits)
    want = _full_fold(xr, w_k, w_v, w_out, b_out, g, chunk, dim_head)
    got = tla.fold_context(
        *tla.merge_stats(*tla.attention_stats_plain(xr, w_k, w_v, chunk,
                                                    dim_head))[1:],
        w_out, b_out, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('case,error', [
    ('ok', None), ('dim_head 16', ValueError), ('full [H, H] to fold',
                                                ValueError),
    ('full [H, H] to merge', ValueError), ('blocks do not tile H',
                                           ValueError)])
def test_block_contract_check(case, error):
    # K2's kernel is built for dim_head 32; merge_stats and fold_context
    # take head blocks [..., heads, dh, dh] that tile H, and refuse the old
    # full [H, H] context
    B, S, H = 2, 3, tla.HIDDEN
    m, den = torch.zeros(B, S, H), torch.ones(B, S, H)
    ctx = torch.zeros(B, S, H // 32, 32, 32)
    w_out, b_out, g = torch.zeros(H, 16), torch.zeros(16), torch.ones(1)

    def check():
        tla._check_dim_head('attention_stats',
                            16 if case == 'dim_head 16' else 32)
        if case == 'full [H, H] to merge':
            tla.merge_stats(m, torch.zeros(B, S, H, H), den)
        mc = (m, ctx[:, :, :2] if case == 'blocks do not tile H' else ctx,
              den)
        _, c, d = tla.merge_stats(*mc)
        if case == 'full [H, H] to fold':
            c = torch.zeros(B, H, H)
        ctx2, _ = tla.fold_context(c, d, w_out, b_out, g)
        assert ctx2.shape == (B, H, 16)

    if error is None:
        check()
    else:
        with pytest.raises(error):
            check()
