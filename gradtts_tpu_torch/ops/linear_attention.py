"""Linear attention + ReZero residual, forward, backward and forward-mode
tangent (kernels K2-K7 of the port).

Counterpart of gradtts_tpu/ops/pallas/linear_attention.py: the forward
``_stats_kernel`` (:58) and ``_apply_kernel`` (:113) driven by ``_forward``
(:146), whose result equals the jnp twin ``_reference`` (:227); the
streaming backward ``_bwd_sweep1_kernel`` (:329) and ``_bwd_sweep2_kernel``
(:381) driven by ``_backward_pallas`` (:444); and the forward-mode sweeps
``_jvp_stats_kernel`` (:651) and ``_jvp_apply_kernel`` (:724) driven by
``_jvp_pallas`` (:742), phases=1 layout. The CUDA kernels are in
``csrc/linear_attention.cu`` (K2, K3), ``csrc/linear_attention_bwd.cu``
(K4, K5) and ``csrc/linear_attention_jvp.cu`` (K6, K7); their sources say
what bounds them on the H100 and how they are laid out.

For x [B, N = F*T, C] and H = heads * dim_head:

  K2 ``attention_stats``: per batch item and per split of the N rows,
     k = x Wk, v = x Wv and, under a running max m over the rows, the
     head-diagonal blocks of the f32 context sum exp(k - m) v^T
     [heads, dh, dh] (the fold reads no other entry) and the denominator
     sum exp(k - m) [H];
  ``merge_stats``: merges the splits with the same exp(m_s - m) rescale;
  ``fold_context``: / den, @ Wout per head, * g -> ctx2 [B, H, C], and
     bias = b_out * g (as ``_forward`` :195-200);
  K3 ``attention_apply``: out = x + (x Wq rounded to x's dtype) ctx2 + bias;
  K4 ``attention_bwd_sweep1``: dA = q^T dy per batch item, and over the
     batch dWq = x^T (dy A_full^T), db = sum dy, dgv = sum dy (q A_pre + b);
  K5 ``attention_bwd_sweep2``: recomputes exp(x Wk - m) and x Wv, emits
     dx = dy + dq Wq^T + dk Wk^T + dv Wv^T and sums dWk, dWv over the batch;
     dctx is taken as block diagonal over the heads;
  K6 ``attention_jvp_stats``: K2's statistics and their tangents along
     (dx, dWk, dWv) under the same running max (m is stop-gradient): the
     head-diagonal blocks of ctx and dctx = sum dek v^T + ek dv^T, den and
     dden = sum dek, with dek = exp(k - m) * dk;
  ``merge_jvp_stats`` and ``fold_context_jvp``: the split merge and the
     fold, with the quotient and product rules for the tangents
     (``_jvp_pallas`` :800-817);
  K7 ``attention_jvp_apply``: y = x + q A + bias and its tangent dy = dx +
     q dA + dq A + dbias, with q and dq rounded to x's dtype.

:class:`LinearAttentionRezeroFn` ties them together for autograd, in both
modes; the host algebra between K4 and K5 is ``_backward_pallas`` :459-478
and :515-538.
"""

import torch

from gradtts_tpu_torch.ops import _build

HIDDEN = 128               # heads * dim_head the CUDA kernels are built for
DIM_HEAD = 32              # dim_head K5 is built for (csrc: DH)
_ROWS = 32                 # csrc/linear_attention*.cu: f32 rows per tile R
_TC_ROWS = 64              # csrc/linear_attention*.cu: bf16 rows per tile TR
_TARGET_BLOCKS = 2 * 132   # two blocks per SM of an H100
_CHANNELS = (16, 32, 64, 128, 256)
_NEG = -1e30               # running-max start value (Pallas _NEG)


def split_chunk(B: int, N: int) -> int:
    """Rows per split of a forward kernel (K2, K3, K6, K7): enough splits
    to fill the card at batch B, each a whole number of the bf16 kernels'
    64-row tiles (:data:`_TC_ROWS`)."""
    n_splits = max(1, min(-(-_TARGET_BLOCKS // B), -(-N // _TC_ROWS)))
    return -(-N // (n_splits * _TC_ROWS)) * _TC_ROWS


def bwd_roles(kernel: str, C: int) -> int:
    """Blocks per split and batch item of K4 / K5 in f32
    (csrc/linear_attention_bwd.cu Bwd1::ROLES, Bwd2::ROLES): each owns one
    slice of the accumulators."""
    return 2 * max(1, C // 128) if kernel == 'sweep1' \
        else 1 + HIDDEN // DIM_HEAD


def bwd_split_chunk(B: int, N: int, C: int, itemsize: int, roles: int) -> int:
    """Rows per split of K4/K5 in f32. Each split of each batch item writes f32
    partial sums of 2*C*H values (dA and dWq, or dWk and dWv), so the
    splits fill the card only as far as those partials stay under half the
    bytes of x: B*S*C*H*8 <= B*N*C*itemsize / 2."""
    cap = max(1, N * itemsize // (16 * HIDDEN))
    n_splits = max(1, min(-(-_TARGET_BLOCKS // (B * roles)),
                          -(-N // _ROWS), cap))
    return -(-N // (n_splits * _ROWS)) * _ROWS


_SMS = 132                 # streaming multiprocessors of an H100
_DW_ROWS = 128             # csrc/linear_attention_bwd.cu: TRW


def bwd2_split_chunks(B: int, N: int, C: int):
    """Rows per split of K5's two bf16 kernels (csrc/linear_attention_bwd.cu
    ``la_bwd2_dx_kernel``, ``la_bwd2_dw_kernel``): (chunk, chunk_w). The dx
    kernel's grid is (S, B) and its shared memory holds two blocks an SM at
    C <= 64, one above; the dW kernel's is (S_w, B, 4 heads), two blocks an
    SM below C 256, one at it. Each grid fills its SMs once (no second wave
    of a few blocks), each dx split at least two 64-row tiles where N
    allows, and each chunk is whole tiles (64 rows, 128 for dW)."""
    def chunk_for(blocks_per_item, rows, tile):
        n_splits = max(1, min(blocks_per_item, -(-N // rows)))
        return -(-N // (n_splits * tile)) * tile

    dx_blocks = (2 if C <= 64 else 1) * _SMS
    dw_blocks = (2 if C < 256 else 1) * _SMS
    return (chunk_for(dx_blocks // B, 2 * _TC_ROWS, _TC_ROWS),
            chunk_for(dw_blocks // (B * HIDDEN // DIM_HEAD), _DW_ROWS,
                      _DW_ROWS))


def bwd1_split_chunks(B: int, N: int, C: int) -> int:
    """Rows per split of K4's bf16 kernel (csrc/linear_attention_bwd.cu
    ``la_bwd1_tc_kernel``, ``Bwd1Tc``). Its grid is (S, B, 4 heads) and
    its shared memory holds two blocks an SM at C <= 128, one at C 256; the
    grid fills its SMs once (no second wave of a few blocks), and each
    chunk is whole tiles (128 rows at C <= 64, else 64)."""
    tile = 2 * _TC_ROWS if C <= 64 else _TC_ROWS
    blocks = (2 if C <= 128 else 1) * _SMS
    n_splits = max(1, min(blocks // (B * HIDDEN // DIM_HEAD), -(-N // tile)))
    return -(-N // (n_splits * tile)) * tile


def head_blockdiag(H: int, dim_head: int, device) -> torch.Tensor:
    """[H, H] f32 mask of the per-head diagonal blocks."""
    head = torch.arange(H, device=device) // dim_head
    return (head[:, None] == head[None, :]).float()


# ---- plain PyTorch versions ----------------------------------------------


def _head_blocks(a, b, dim_head):
    """sum over rows of a^T b, head-diagonal blocks only: a, b [..., n, H]
    -> [..., H / dim_head, dim_head, dim_head]."""
    a = a.reshape(*a.shape[:-1], -1, dim_head)
    b = b.reshape(*b.shape[:-1], -1, dim_head)
    return torch.einsum('...nhd,...nhe->...hde', a, b)


def attention_stats_plain(x, w_k, w_v, chunk: int,
                          dim_head: int = DIM_HEAD):
    """x [B, N, C]; w_k, w_v [C, H]. Returns f32 (m [B, S, H],
    ctx [B, S, H / dim_head, dim_head, dim_head], den [B, S, H]) for the
    S = ceil(N / chunk) splits of rows [s * chunk, (s + 1) * chunk): ctx
    holds the head-diagonal blocks of sum exp(k - m) v^T, the only
    entries the fold reads."""
    ms, ctxs, dens = [], [], []
    for xs in torch.split(x, chunk, dim=1):
        xs = xs.float()
        k = xs @ w_k.float()
        v = xs @ w_v.float()
        m = k.amax(dim=1)                                   # [B, H]
        ek = torch.exp(k - m[:, None, :])
        ms.append(m)
        ctxs.append(_head_blocks(ek, v, dim_head))
        dens.append(ek.sum(dim=1))
    return torch.stack(ms, 1), torch.stack(ctxs, 1), torch.stack(dens, 1)


def attention_apply_plain(x, w_q, ctx2, bias):
    """x [B, N, C]; w_q [C, H], ctx2 [B, H, C] in x's dtype; bias [C] f32.
    Returns x + (x Wq rounded to x's dtype) ctx2 + bias in x's dtype."""
    q = (x.float() @ w_q.float()).to(x.dtype)
    out = q.float() @ ctx2.float() + bias.float() + x.float()
    return out.to(x.dtype)


def attention_bwd_sweep1_plain(x, dy, w_q, a_full_t, a_pre, b_out):
    """x, dy [B, N, C]; w_q [C, H]; a_full_t [B, C, H]; a_pre [B, H, C], all
    in x's dtype; b_out [C] f32. Returns f32 (dA [B, H, C], dWq [C, H],
    db [C], dgv [C]) with the Pallas kernel's rounding points: q and dq are
    rounded to x's dtype before their second products (:357, :365)."""
    dt = x.dtype
    xf, dyf = x.float(), dy.float()
    q = xf @ w_q.float()                                    # [B, N, H]
    da = q.transpose(1, 2) @ dyf
    o_pre = q.to(dt).float() @ a_pre.float()                # [B, N, C]
    dgv = (dyf * (o_pre + b_out.float())).sum(dim=(0, 1))
    dq = (dyf @ a_full_t.float()).to(dt).float()            # [B, N, H]
    dwq = (xf.transpose(1, 2) @ dq).sum(dim=0)
    return da, dwq, dyf.sum(dim=(0, 1)), dgv


def attention_bwd_sweep2_plain(x, dy, w_q, w_k, w_v, m, a_full_t, dctx,
                               dden, dim_head: int = DIM_HEAD):
    """x, dy [B, N, C]; w_q, w_k, w_v [C, H]; a_full_t [B, C, H]; dctx
    [B, H, H], all in x's dtype; m, dden [B, H] f32. dctx is read as block
    diagonal over heads of ``dim_head`` (entries off the blocks are
    ignored). Returns (dx [B, N, C] in x's dtype, dWk [C, H] f32, dWv
    [C, H] f32) with the Pallas kernel's rounding points (:404-410)."""
    dt = x.dtype
    xf, dyf = x.float(), dy.float()
    dctx = dctx.float() * head_blockdiag(dctx.shape[-1], dim_head, x.device)
    ek = torch.exp(xf @ w_k.float() - m[:, None, :])        # [B, N, H]
    v = (xf @ w_v.float()).to(dt).float()
    dek = v @ dctx.transpose(1, 2) + dden[:, None, :]
    dk = (ek * dek).to(dt).float()
    dv = (ek.to(dt).float() @ dctx).to(dt).float()
    dq = (dyf @ a_full_t.float()).to(dt).float()
    dx = (dyf + dq @ w_q.float().t() + dk @ w_k.float().t()
          + dv @ w_v.float().t())
    xt = xf.transpose(1, 2)
    return dx.to(dt), (xt @ dk).sum(dim=0), (xt @ dv).sum(dim=0)


def attention_jvp_stats_plain(x, dx, w_k, w_v, dw_k, dw_v, chunk: int,
                              dim_head: int = DIM_HEAD):
    """x, dx [B, N, C]; w_k, w_v and the tangents dw_k, dw_v [C, H], all in
    x's dtype; dw_k and dw_v may both be None (zero). Returns f32 (m, ctx,
    den, dctx, dden) for the S = ceil(N / chunk) splits of the rows: m, den
    and dden [B, S, H]; ctx and dctx [B, S, H / dim_head, dim_head,
    dim_head], the head-diagonal blocks (the fold reads no other entry).
    k, v and their tangents stay f32, as in ``_jvp_stats_kernel``. The
    splits are computed at once, as rows [B, S, chunk] padded past N."""
    B, N, C = x.shape
    S = -(-N // chunk)

    def rows(t):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, S * chunk - N))
        return t.reshape(B, S, chunk, C)

    xs, dxs = rows(x), rows(dx)
    k, v = xs @ w_k.float(), xs @ w_v.float()          # [B, S, chunk, H]
    dk, dv = dxs @ w_k.float(), dxs @ w_v.float()
    if dw_k is not None:
        dk = xs @ dw_k.float() + dk
        dv = xs @ dw_v.float() + dv
    valid = (torch.arange(S * chunk, device=x.device) < N).reshape(
        S, chunk, 1)
    m = k.masked_fill(~valid, float('-inf')).amax(dim=2)       # [B, S, H]
    ek = torch.exp(k - m[:, :, None, :]) * valid
    dek = ek * dk                                       # m stop-grad
    return (m, _head_blocks(ek, v, dim_head), ek.sum(dim=2),
            _head_blocks(dek, v, dim_head) + _head_blocks(ek, dv, dim_head),
            dek.sum(dim=2))


def attention_jvp_apply_plain(x, dx, w_q, dw_q, a, da, bias, dbias):
    """x, dx [B, N, C]; w_q, dw_q [C, H] and a, da [B, H, C] in x's dtype
    (dw_q may be None: zero); bias, dbias [C] f32. Returns (y, dy) in x's
    dtype: y = q A + bias + x and dy = q dA + dq A + dbias + dx, with
    q = x Wq and dq = dx Wq + x dWq rounded to x's dtype before their
    products (``_jvp_apply_kernel`` :731-732)."""
    dt = x.dtype
    xf, dxf = x.float(), dx.float()
    q = xf @ w_q.float()
    dq = dxf @ w_q.float()
    if dw_q is not None:
        dq = xf @ dw_q.float() + dq
    q, dq = q.to(dt).float(), dq.to(dt).float()
    af = a.float()
    y = q @ af + bias.float() + xf
    dy = (q @ da.float() + dq @ af) + dbias.float() + dxf
    return y.to(dt), dy.to(dt)


# ---- the kernels' wrappers -------------------------------------------------


def _check(name, x, tensors, dtypes):
    if x.dim() != 3 or x.shape[2] not in _CHANNELS:
        raise ValueError(f'{name}: x must be [B, N, C] with C in {_CHANNELS}, '
                         f'got {tuple(x.shape)}')
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f'{name}: unsupported dtype {x.dtype}')
    for (label, t), (shape, dtype) in zip(tensors.items(), dtypes):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f'{name}: {label} must be {shape} {dtype}, got '
                             f'{tuple(t.shape)} {t.dtype}')
    for label, t in [('x', x)] + list(tensors.items()):
        if t.device != x.device:
            raise ValueError(f'{name}: {label} is not on {x.device}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name}: {label} must be contiguous and '
                             '16-byte aligned')


def _check_dim_head(name, dim_head):
    if dim_head != DIM_HEAD:
        raise ValueError(f'{name}: the kernel is built for dim_head '
                         f'{DIM_HEAD}, got {dim_head}')


def attention_stats(x, w_k, w_v, chunk: int, dim_head: int = DIM_HEAD):
    """K2. Same contract as :func:`attention_stats_plain`; CPU tensors take
    the plain version, CUDA tensors launch the kernel (built for
    ``dim_head`` 32) or raise."""
    if x.device.type == 'cpu':
        return attention_stats_plain(x, w_k, w_v, chunk, dim_head)
    _check_dim_head('attention_stats', dim_head)
    B, N, C = x.shape
    _check('attention_stats', x, {'w_k': w_k, 'w_v': w_v},
           [((C, HIDDEN), x.dtype)] * 2)
    S = -(-N // chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    m = torch.empty((B, S, HIDDEN), **f32)
    ctx = torch.empty((B, S, HIDDEN // DIM_HEAD, DIM_HEAD, DIM_HEAD), **f32)
    den = torch.empty((B, S, HIDDEN), **f32)
    lib = _build.load('linear_attention')
    _build.check(lib, lib.gtt_la_stats(
        x.data_ptr(), w_k.data_ptr(), w_v.data_ptr(), m.data_ptr(),
        ctx.data_ptr(), den.data_ptr(), B, N, C, chunk, S,
        _build.DTYPE_CODES[x.dtype], _build.stream_of(x)), 'gtt_la_stats')
    attention_stats.launches += 1
    return m, ctx, den


attention_stats.launches = 0


def attention_apply(x, w_q, ctx2, bias):
    """K3. Same contract as :func:`attention_apply_plain`; CPU tensors take
    the plain version, CUDA tensors launch the kernel or raise."""
    if x.device.type == 'cpu':
        return attention_apply_plain(x, w_q, ctx2, bias)
    B, N, C = x.shape
    _check('attention_apply', x, {'w_q': w_q, 'ctx2': ctx2, 'bias': bias},
           [((C, HIDDEN), x.dtype), ((B, HIDDEN, C), x.dtype),
            ((C,), torch.float32)])
    chunk = split_chunk(B, N)
    out = torch.empty_like(x)
    lib = _build.load('linear_attention')
    _build.check(lib, lib.gtt_la_apply(
        x.data_ptr(), w_q.data_ptr(), ctx2.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, N, C, chunk, -(-N // chunk),
        _build.DTYPE_CODES[x.dtype], _build.stream_of(x)), 'gtt_la_apply')
    attention_apply.launches += 1
    return out


attention_apply.launches = 0


def attention_bwd_sweep1(x, dy, w_q, a_full_t, a_pre, b_out):
    """K4. Same contract as :func:`attention_bwd_sweep1_plain`; CPU tensors
    take the plain version, CUDA tensors launch the kernel (in bf16 the
    tensor cores' one, in f32 the CUDA cores') or raise. The per-split
    partial sums are added up here, in a fixed order."""
    if x.device.type == 'cpu':
        return attention_bwd_sweep1_plain(x, dy, w_q, a_full_t, a_pre, b_out)
    B, N, C = x.shape
    H = HIDDEN
    _check('attention_bwd_sweep1', x,
           {'dy': dy, 'w_q': w_q, 'a_full_t': a_full_t, 'a_pre': a_pre,
            'b_out': b_out},
           [((B, N, C), x.dtype), ((C, H), x.dtype), ((B, C, H), x.dtype),
            ((B, H, C), x.dtype), ((C,), torch.float32)])
    tc = x.dtype == torch.bfloat16
    chunk = bwd1_split_chunks(B, N, C) if tc else bwd_split_chunk(
        B, N, C, x.element_size(), bwd_roles('sweep1', C))
    S = -(-N // chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    da = torch.empty((B, S, H, C), **f32)
    dwq = torch.empty((B, S, C, H), **f32)
    db = torch.empty((B, S, C), **f32)
    # the tensor cores' kernel writes dgv's share of each head
    dgv = torch.empty((B, S, H // DIM_HEAD, C) if tc else (B, S, C), **f32)
    lib = _build.load('linear_attention_bwd')
    ptrs = (x.data_ptr(), dy.data_ptr(), w_q.data_ptr(), a_full_t.data_ptr(),
            a_pre.data_ptr(), b_out.data_ptr(), da.data_ptr(), dwq.data_ptr(),
            db.data_ptr(), dgv.data_ptr(), B, N, C, chunk, S)
    if tc:
        _build.check(lib, lib.gtt_la_bwd1_tc(*ptrs, _build.stream_of(x)),
                     'gtt_la_bwd1_tc')
    else:
        _build.check(lib, lib.gtt_la_bwd1(*ptrs, _build.DTYPE_CODES[x.dtype],
                                          _build.stream_of(x)), 'gtt_la_bwd1')
    attention_bwd_sweep1.launches += 1
    return (da.sum(dim=1), dwq.sum(dim=(0, 1)), db.sum(dim=(0, 1)),
            dgv.flatten(0, -2).sum(dim=0))


attention_bwd_sweep1.launches = 0


def attention_bwd_sweep2(x, dy, w_q, w_k, w_v, m, a_full_t, dctx, dden,
                         dim_head: int = DIM_HEAD):
    """K5. Same contract as :func:`attention_bwd_sweep2_plain`; CPU tensors
    take the plain version, CUDA tensors launch the kernel (built for
    ``dim_head`` 32: in bf16 the tensor cores' dx and dW kernels, in f32
    the CUDA cores' one) or raise. The per-split partial sums are added
    up here, in a fixed order."""
    if x.device.type == 'cpu':
        return attention_bwd_sweep2_plain(x, dy, w_q, w_k, w_v, m, a_full_t,
                                          dctx, dden, dim_head)
    _check_dim_head('attention_bwd_sweep2', dim_head)
    B, N, C = x.shape
    H = HIDDEN
    f32 = torch.float32
    _check('attention_bwd_sweep2', x,
           {'dy': dy, 'w_q': w_q, 'w_k': w_k, 'w_v': w_v, 'm': m,
            'a_full_t': a_full_t, 'dctx': dctx, 'dden': dden},
           [((B, N, C), x.dtype)] + [((C, H), x.dtype)] * 3
           + [((B, H), f32), ((B, C, H), x.dtype), ((B, H, H), x.dtype),
              ((B, H), f32)])
    dx = torch.empty_like(x)
    lib = _build.load('linear_attention_bwd')
    if x.dtype == torch.bfloat16:        # the tensor cores' two kernels
        chunk, chunk_w = bwd2_split_chunks(B, N, C)
        S, S_w = -(-N // chunk), -(-N // chunk_w)
        # A_full [B, H, C] is read at C 256, where it does not fit in
        # shared memory beside the weights
        a_full = a_full_t.transpose(1, 2).contiguous() if C == 256 \
            else a_full_t
        dwkv = torch.empty((B, S_w, C, 2 * H), dtype=f32, device=x.device)
        _build.check(lib, lib.gtt_la_bwd2_tc(
            x.data_ptr(), dy.data_ptr(), w_q.data_ptr(), w_k.data_ptr(),
            w_v.data_ptr(), a_full_t.data_ptr(), a_full.data_ptr(),
            m.data_ptr(), dctx.data_ptr(), dden.data_ptr(), dx.data_ptr(),
            dwkv.data_ptr(), B, N, C, chunk, S, chunk_w, S_w,
            _build.stream_of(x)), 'gtt_la_bwd2_tc')
    else:
        chunk = bwd_split_chunk(B, N, C, x.element_size(),
                                bwd_roles('sweep2', C))
        S = -(-N // chunk)
        wqkv_t = torch.cat([w_q, w_k, w_v], dim=1).t().contiguous()
        dctx_t = dctx.transpose(1, 2).contiguous()
        dwkv = torch.empty((B, S, C, 2 * H), dtype=f32, device=x.device)
        _build.check(lib, lib.gtt_la_bwd2(
            x.data_ptr(), dy.data_ptr(), w_k.data_ptr(), w_v.data_ptr(),
            a_full_t.data_ptr(), wqkv_t.data_ptr(), m.data_ptr(),
            dctx_t.data_ptr(), dctx.data_ptr(), dden.data_ptr(),
            dx.data_ptr(), dwkv.data_ptr(), B, N, C, chunk, S,
            _build.DTYPE_CODES[x.dtype], _build.stream_of(x)), 'gtt_la_bwd2')
    attention_bwd_sweep2.launches += 1
    dwkv = dwkv.sum(dim=(0, 1))
    return dx, dwkv[:, :H], dwkv[:, H:]


attention_bwd_sweep2.launches = 0


def attention_jvp_stats(x, dx, w_k, w_v, dw_k, dw_v, chunk: int,
                        dim_head: int = DIM_HEAD):
    """K6. Same contract as :func:`attention_jvp_stats_plain`; CPU tensors
    take the plain version, CUDA tensors launch the kernel (built for
    ``dim_head`` 32; the variant without weight tangents when dw_k and dw_v
    are None) or raise."""
    if x.device.type == 'cpu':
        return attention_jvp_stats_plain(x, dx, w_k, w_v, dw_k, dw_v, chunk,
                                         dim_head)
    _check_dim_head('attention_jvp_stats', dim_head)
    if (dw_k is None) != (dw_v is None):
        raise ValueError('attention_jvp_stats: dw_k and dw_v are given '
                         'together or not at all')
    B, N, C = x.shape
    H, nh = HIDDEN, HIDDEN // DIM_HEAD
    tensors = {'dx': dx, 'w_k': w_k, 'w_v': w_v}
    if dw_k is not None:
        tensors.update(dw_k=dw_k, dw_v=dw_v)
    _check('attention_jvp_stats', x, tensors,
           [((B, N, C), x.dtype)] + [((C, H), x.dtype)] * (len(tensors) - 1))
    S = -(-N // chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    m, den, dden = (torch.empty((B, S, H), **f32) for _ in range(3))
    ctx, dctx = (torch.empty((B, S, nh, DIM_HEAD, DIM_HEAD), **f32)
                 for _ in range(2))
    lib = _build.load('linear_attention_jvp')
    _build.check(lib, lib.gtt_la_jvp_stats(
        x.data_ptr(), dx.data_ptr(), w_k.data_ptr(), w_v.data_ptr(),
        None if dw_k is None else dw_k.data_ptr(),
        None if dw_v is None else dw_v.data_ptr(), m.data_ptr(),
        ctx.data_ptr(), den.data_ptr(), dctx.data_ptr(), dden.data_ptr(),
        B, N, C, chunk, S, _build.DTYPE_CODES[x.dtype],
        _build.stream_of(x)), 'gtt_la_jvp_stats')
    attention_jvp_stats.launches += 1
    return m, ctx, den, dctx, dden


attention_jvp_stats.launches = 0


def attention_jvp_apply(x, dx, w_q, dw_q, a, da, bias, dbias):
    """K7. Same contract as :func:`attention_jvp_apply_plain`; CPU tensors
    take the plain version, CUDA tensors launch the kernel (the variant
    without a weight tangent when dw_q is None) or raise."""
    if x.device.type == 'cpu':
        return attention_jvp_apply_plain(x, dx, w_q, dw_q, a, da, bias,
                                         dbias)
    B, N, C = x.shape
    H = HIDDEN
    tensors = {'dx': dx, 'w_q': w_q, 'a': a, 'da': da, 'bias': bias,
               'dbias': dbias}
    shapes = [((B, N, C), x.dtype), ((C, H), x.dtype), ((B, H, C), x.dtype),
              ((B, H, C), x.dtype), ((C,), torch.float32),
              ((C,), torch.float32)]
    if dw_q is not None:
        tensors['dw_q'] = dw_q
        shapes.append(((C, H), x.dtype))
    _check('attention_jvp_apply', x, tensors, shapes)
    chunk = split_chunk(B, N)
    y, dy = torch.empty_like(x), torch.empty_like(x)
    lib = _build.load('linear_attention_jvp')
    _build.check(lib, lib.gtt_la_jvp_apply(
        x.data_ptr(), dx.data_ptr(), w_q.data_ptr(),
        None if dw_q is None else dw_q.data_ptr(), a.data_ptr(),
        da.data_ptr(), bias.data_ptr(), dbias.data_ptr(), y.data_ptr(),
        dy.data_ptr(), B, N, C, chunk, -(-N // chunk),
        _build.DTYPE_CODES[x.dtype], _build.stream_of(x)),
        'gtt_la_jvp_apply')
    attention_jvp_apply.launches += 1
    return y, dy


attention_jvp_apply.launches = 0


# ---- merge, fold and the whole op ------------------------------------------


def _check_blocks(name, ctx, rows):
    """ctx [..., heads, dh, dh] head blocks that tile the H of ``rows``
    [..., H]."""
    if (ctx.dim() != rows.dim() + 2 or ctx.shape[-1] != ctx.shape[-2]
            or ctx.shape[:-3] != rows.shape[:-1]
            or ctx.shape[-3] * ctx.shape[-1] != rows.shape[-1]):
        raise ValueError(f'{name}: ctx must be head blocks [..., heads, dh, '
                         f'dh] with heads * dh = {rows.shape[-1]}, got '
                         f'{tuple(ctx.shape)}')


def _merge_splits(m, blocks, rows):
    """Sums per-split statistics over the split axis 1 with the online-max
    rescale exp(m_s - m): ``blocks`` [B, S, heads, dh, dh] by the rescale
    of their row, ``rows`` [B, S, H] by their own. Returns (m [B, H],
    blocks, rows), each without the split axis."""
    m_all = m.amax(dim=1)                                    # [B, H]
    alpha = torch.exp(m - m_all[:, None, :])                 # [B, S, H]
    a_rows = alpha.reshape(blocks[0].shape[:-1])[..., None]  # per block row
    return (m_all, [(c * a_rows).sum(dim=1) for c in blocks],
            [(r * alpha).sum(dim=1) for r in rows])


def merge_stats(m, ctx, den):
    """Merges K2's per-split statistics (m, den [B, S, H]; ctx [B, S,
    heads, dh, dh] head blocks) into (m [B, H], ctx [B, heads, dh, dh],
    den [B, H]) with the online-max rescale exp(m_s - m)."""
    _check_blocks('merge_stats', ctx, m)
    m_all, (ctx,), (den,) = _merge_splits(m, [ctx], [den])
    return m_all, ctx, den


def _per_head(ctx, w):
    """Head blocks ctx [B, heads, dh, dh] @ the matching rows of w [H, C]
    -> [B, H, C]: the block-diagonal context times w."""
    B, nh, dh, _ = ctx.shape
    return torch.einsum('bhde,hec->bhdc', ctx,
                        w.float().reshape(nh, dh, -1)).reshape(B, nh * dh, -1)


def fold_context(ctx, den, w_out, b_out, g):
    """(ctx [B, heads, dh, dh] head blocks, den [B, H]) -> (ctx2 [B, H, C],
    bias [C]) in f32: / den, @ Wout, * g (``_forward`` :195-200; its head
    block-diagonal mask is the block form here)."""
    _check_blocks('fold_context', ctx, den)
    g = g.float().reshape(())
    ctx2n = ctx / den.reshape(ctx.shape[:-1])[..., None]
    return _per_head(ctx2n, w_out) * g, b_out.float() * g


def _full_context(ctx):
    """Head blocks [B, heads, dh, dh] -> the block-diagonal [B, H, H]."""
    B, nh, dh, _ = ctx.shape
    full = ctx.new_zeros(B, nh, dh, nh, dh)
    full.diagonal(dim1=1, dim2=3).copy_(ctx.permute(0, 2, 3, 1))
    return full.reshape(B, nh * dh, nh * dh)


def _forward(x, w_q, w_k, w_v, w_out, b_out, g, dim_head, chunk, ops):
    """K2 -> merge -> fold -> K3 (or their plain versions, ``ops``).
    Returns (out [B, F, T, C], m, ctx, den), the last three merged (ctx in
    head blocks)."""
    stats, apply = ops[:2]
    B, F, T, C = x.shape
    xr = x.reshape(B, F * T, C)
    dt = x.dtype
    if chunk is None:
        chunk = split_chunk(B, F * T)
    m, cx, den = merge_stats(*stats(xr, w_k.to(dt).contiguous(),
                                    w_v.to(dt).contiguous(), chunk,
                                    dim_head))
    ctx2, bias = fold_context(cx, den, w_out, b_out, g)
    out = apply(xr, w_q.to(dt).contiguous(), ctx2.to(dt), bias)
    return out.reshape(B, F, T, C), m, cx, den


def merge_jvp_stats(m, ctx, den, dctx, dden):
    """Merges K6's per-split statistics into (ctx, den, dctx, dden), each
    without its split axis, with the rescale exp(m_s - m) of
    :func:`merge_stats`; m is stop-gradient, so the rescale has no tangent
    and scales the tangents alike. ctx and dctx are [B, S, heads, dh, dh]
    head blocks, rescaled by their row's max."""
    _, (ctx, dctx), (den, dden) = _merge_splits(m, [ctx, dctx], [den, dden])
    return ctx, den, dctx, dden


def fold_context_jvp(ctx, den, dctx, dden, w_out, b_out, g, dw_out, db_out,
                     dg):
    """The primal fold of :func:`fold_context` and its tangent, in f32, on
    head blocks ctx, dctx [B, heads, dh, dh] and den, dden [B, H]; the
    weight tangents dw_out [H, C], db_out [C] and dg may be None (zero).
    Returns (A [B, H, C], dA, bias [C], dbias): with ctx2n = ctx / den,
    A = ctx2n Wout g, dA = (dctx2n Wout + ctx2n dWout) g + ctx2n Wout dg
    where dctx2n = dctx / den - ctx2n dden / den (``_jvp_pallas``
    :800-817)."""
    g = g.float().reshape(())
    den_h = den.reshape(ctx.shape[:-1])[..., None]
    ctx2n = ctx / den_h
    dctx2n = dctx / den_h - ctx2n * (dden.reshape(den_h.shape) / den_h)
    a_pre = _per_head(ctx2n, w_out)
    da_pre = _per_head(dctx2n, w_out)
    if dw_out is not None:
        da_pre = da_pre + _per_head(ctx2n, dw_out)
    b32 = b_out.float()
    da = da_pre * g
    dbias = torch.zeros_like(b32) if db_out is None else db_out.float() * g
    if dg is not None:
        dg = dg.float().reshape(())
        da, dbias = da + a_pre * dg, dbias + b32 * dg
    return a_pre * g, da, b32 * g, dbias


def _jvp(x, dx, w_q, w_k, w_v, w_out, b_out, g, tangents, dim_head, chunk,
         ops):
    """K6 -> merge -> fold -> K7 (or their plain versions, ``ops``) on
    plain tensors: returns dy [B, F, T, C] in x's dtype. ``tangents``
    are those of (w_q, w_k, w_v, w_out, b_out, g), each None where zero;
    dx is None where zero."""
    jvp_stats, jvp_apply = ops
    dwq, dwk, dwv, dwout, dbout, dg = tangents
    B, F, T, C = x.shape
    dt = x.dtype
    xr = x.reshape(B, F * T, C)
    dxr = (torch.zeros_like(xr) if dx is None
           else dx.to(dt).reshape(B, F * T, C).contiguous())
    if chunk is None:
        chunk = split_chunk(B, F * T)

    def cast(w):
        return None if w is None else w.to(dt).contiguous()

    if (dwk is None) != (dwv is None):   # K6 takes both or neither
        dwk = torch.zeros_like(w_k) if dwk is None else dwk
        dwv = torch.zeros_like(w_v) if dwv is None else dwv
    cx, den, dcx, dden = merge_jvp_stats(*jvp_stats(
        xr, dxr, cast(w_k), cast(w_v), cast(dwk), cast(dwv), chunk,
        dim_head))
    a, da, bias, dbias = fold_context_jvp(cx, den, dcx, dden, w_out, b_out,
                                          g, dwout, dbout, dg)
    _, dy = jvp_apply(xr, dxr, cast(w_q), cast(dwq), a.to(dt).contiguous(),
                      da.to(dt).contiguous(), bias, dbias.contiguous())
    return dy.reshape(B, F, T, C)


class LinearAttentionRezeroFn(torch.autograd.Function):
    """(x [B, F, T, C]; w_q, w_k, w_v [C, H]; w_out [H, C]; b_out [C]; g [1])
    -> (out, m, ctx, den): out = (attention(x) @ w_out + b_out) * g + x in
    x's dtype, and the merged statistics of the forward (not
    differentiable; the backward reads them). The weights may be f32 under
    a bf16 x: they are cast to x's dtype at use, and their grads come back
    in their own dtype. The running max m is stop-gradient, as in
    ``models/diffusion.py:423`` of the JAX package.

    Reverse mode (``backward``): K4 and K5 around the host algebra of
    ``_backward_pallas``. Forward mode (``jvp``, for ``torch.func.jvp`` and
    ``torch.autograd.forward_ad``): K6 -> merge -> fold -> K7, as
    ``_jvp_pallas``; it recomputes the primal statistics under its own
    running max, as the Pallas rule does. Tangents that are absent arrive
    as None (``set_materialize_grads(False)``) and cost nothing.

    ``ops`` = (stats, apply, sweep1, sweep2, jvp_stats, jvp_apply): the
    kernels' wrappers, or their plain versions."""

    @staticmethod
    def forward(x, w_q, w_k, w_v, w_out, b_out, g, dim_head, chunk, ops):
        return _forward(x, w_q, w_k, w_v, w_out, b_out, g, dim_head, chunk,
                        ops)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w_q, w_k, w_v, w_out, b_out, g, dim_head, chunk, ops = inputs
        _, m, cx, den = output
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(m, cx, den)
        ctx.save_for_backward(x, w_q, w_k, w_v, w_out, b_out, g, m, cx, den)
        ctx.save_for_forward(x, w_q, w_k, w_v, w_out, b_out, g)
        ctx.dim_head, ctx.chunk, ctx.ops = dim_head, chunk, ops

    @staticmethod
    def backward(ctx, dy, _dm, _dctx, _dden):
        if dy is None:
            return (None,) * 10
        x, w_q, w_k, w_v, w_out, b_out, g, m, cx, den = ctx.saved_tensors
        sweep1, sweep2 = ctx.ops[2:4]
        B, F, T, C = x.shape
        dt = x.dtype
        xr = x.reshape(B, F * T, C)
        dyr = dy.to(dt).contiguous().reshape(B, F * T, C)
        g32 = g.float().reshape(())
        bd = head_blockdiag(w_q.shape[1], ctx.dim_head, x.device)
        cx = _full_context(cx)                               # [B, H, H]
        ctx2n = cx / den[:, :, None]
        w_out32 = w_out.float()
        a_pre = ctx2n @ w_out32                              # [B, H, C]
        a_full_t = (a_pre * g32).transpose(1, 2).to(dt).contiguous()
        wq, wk, wv = (w.to(dt).contiguous() for w in (w_q, w_k, w_v))
        da, dwq, db, dgv = sweep1(xr, dyr, wq, a_full_t,
                                  a_pre.to(dt).contiguous(),
                                  b_out.float().contiguous())
        # host algebra of _backward_pallas :521-528 on the tiny matrices
        dwout = torch.einsum('bde,bdc->ec', ctx2n, da) * g32
        dctx2n = torch.einsum('bdc,ec->bde', da, w_out32) * g32
        dctx = dctx2n * bd / den[:, :, None]
        dden = -(dctx2n * cx).sum(dim=2) / (den * den)
        dxr, dwk, dwv = sweep2(xr, dyr, wq, wk, wv, m, a_full_t,
                               dctx.to(dt).contiguous(), dden, ctx.dim_head)
        return (dxr.reshape(B, F, T, C), dwq.to(w_q.dtype),
                dwk.to(w_k.dtype), dwv.to(w_v.dtype),
                dwout.to(w_out.dtype), (db * g32).to(b_out.dtype),
                dgv.sum().reshape(g.shape).to(g.dtype), None, None, None)

    @staticmethod
    def jvp(ctx, dx, dwq, dwk, dwv, dwout, dbout, dg, *_):
        # under torch.func.jvp the saved primals and the tangents arrive
        # wrapped at the transform's level, and every op would wrap its
        # result again: the rule runs on the values underneath, with the
        # transforms' dispatch off, so that the kernels can read them
        with torch._C._DisableFuncTorch():
            x, w_q, w_k, w_v, w_out, b_out, g = map(_build.raw,
                                                    ctx.saved_tensors)
            tangents = [_build.raw(t)
                        for t in (dwq, dwk, dwv, dwout, dbout, dg)]
            dy = _jvp(x, _build.raw(dx), w_q, w_k, w_v, w_out, b_out, g,
                      tangents, ctx.dim_head, ctx.chunk, ctx.ops[4:])
        return dy, None, None, None


_KERNELS = (attention_stats, attention_apply, attention_bwd_sweep1,
            attention_bwd_sweep2, attention_jvp_stats, attention_jvp_apply)
_PLAIN = (attention_stats_plain, attention_apply_plain,
          attention_bwd_sweep1_plain, attention_bwd_sweep2_plain,
          attention_jvp_stats_plain, attention_jvp_apply_plain)


def _run(ops, args, dim_head, chunk):
    """Through the autograd Function where a grad or a forward-mode tangent
    may be asked for, else the forward alone (no autograd bookkeeping on
    the synthesis path)."""
    if _build.needs_function(args):
        return LinearAttentionRezeroFn.apply(*args, dim_head, chunk, ops)[0]
    return _forward(*args, dim_head, chunk, ops)[0]


def linear_attention_rezero(x, w_q, w_k, w_v, w_out, b_out, g,
                            dim_head: int = 32, chunk=None):
    """x [B, F, T, C] contiguous; w_q, w_k, w_v [C, H]; w_out [H, C];
    b_out [C]; g the ReZero gain ([1]). Returns (attention(x) @ w_out +
    b_out) * g + x in x's dtype, through K2 and K3; under autograd its
    grads through K4 and K5, under forward mode its tangent through K6 and
    K7 (their plain versions for CPU tensors). ``chunk`` is the rows per
    split of K2 and K6 (default: :func:`split_chunk`)."""
    return _run(_KERNELS, (x, w_q, w_k, w_v, w_out, b_out, g), dim_head,
                chunk)


def linear_attention_rezero_plain(x, w_q, w_k, w_v, w_out, b_out, g,
                                  dim_head: int = 32, chunk=None):
    """Plain PyTorch version of :func:`linear_attention_rezero`, with the
    same splits, merge, fold, backward and tangent algebra, on any device."""
    return _run(_PLAIN, (x, w_q, w_k, w_v, w_out, b_out, g), dim_head,
                chunk)
