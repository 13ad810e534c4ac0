"""Linear attention + ReZero residual forward (kernels K2 and K3 of the port).

Counterpart of gradtts_tpu/ops/pallas/linear_attention.py: ``_stats_kernel``
(:58) and ``_apply_kernel`` (:113) driven by ``_forward`` (:146), whose
result equals the jnp twin ``_reference`` (:227). The CUDA kernels are in
``csrc/linear_attention.cu``; its source says what bounds them on the H100
and how they are laid out.

For x [B, N = F*T, C] and H = heads * dim_head:

  K2 ``attention_stats``: per batch item and per split of the N rows,
     k = x Wk, v = x Wv and, under a running max m over the rows, the f32
     context sum exp(k - m) v^T [H, H] and denominator sum exp(k - m) [H];
  ``merge_stats``: merges the splits with the same exp(m_s - m) rescale;
  ``fold_context``: head block-diagonal mask, / den, @ Wout, * g -> ctx2
     [B, H, C], and bias = b_out * g (as ``_forward`` :195-200);
  K3 ``attention_apply``: out = x + (x Wq rounded to x's dtype) ctx2 + bias.
"""

import torch

from gradtts_tpu_torch.ops import _build

HIDDEN = 128               # heads * dim_head the CUDA kernels are built for
_ROWS = 32                 # csrc/linear_attention.cu: rows per tile R
_TARGET_BLOCKS = 2 * 132   # two blocks per SM of an H100
_CHANNELS = (16, 32, 64, 128, 256)
_NEG = -1e30               # running-max start value (Pallas _NEG)


def split_chunk(B: int, N: int) -> int:
    """Rows per split: enough splits to fill the card at batch B, each a
    whole number of the kernels' row tiles."""
    n_splits = max(1, min(-(-_TARGET_BLOCKS // B), -(-N // _ROWS)))
    return -(-N // (n_splits * _ROWS)) * _ROWS


# ---- plain PyTorch versions ----------------------------------------------


def attention_stats_plain(x, w_k, w_v, chunk: int):
    """x [B, N, C]; w_k, w_v [C, H]. Returns f32 (m [B, S, H],
    ctx [B, S, H, H], den [B, S, H]) for the S = ceil(N / chunk) splits of
    rows [s * chunk, (s + 1) * chunk)."""
    ms, ctxs, dens = [], [], []
    for xs in torch.split(x, chunk, dim=1):
        xs = xs.float()
        k = xs @ w_k.float()
        v = xs @ w_v.float()
        m = k.amax(dim=1)                                   # [B, H]
        ek = torch.exp(k - m[:, None, :])
        ms.append(m)
        ctxs.append(ek.transpose(1, 2) @ v)                 # [B, H, H]
        dens.append(ek.sum(dim=1))
    return torch.stack(ms, 1), torch.stack(ctxs, 1), torch.stack(dens, 1)


def attention_apply_plain(x, w_q, ctx2, bias):
    """x [B, N, C]; w_q [C, H], ctx2 [B, H, C] in x's dtype; bias [C] f32.
    Returns x + (x Wq rounded to x's dtype) ctx2 + bias in x's dtype."""
    q = (x.float() @ w_q.float()).to(x.dtype)
    out = q.float() @ ctx2.float() + bias.float() + x.float()
    return out.to(x.dtype)


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x] + list(tensors.values())):
        raise NotImplementedError(
            f'{name}: the CUDA kernel has no backward yet; call it under '
            'torch.no_grad()')


def attention_stats(x, w_k, w_v, chunk: int):
    """K2. Same contract as :func:`attention_stats_plain`; CPU tensors take
    the plain version, CUDA tensors launch the kernel or raise."""
    if x.device.type == 'cpu':
        return attention_stats_plain(x, w_k, w_v, chunk)
    B, N, C = x.shape
    _check('attention_stats', x, {'w_k': w_k, 'w_v': w_v},
           [((C, HIDDEN), x.dtype)] * 2)
    S = -(-N // chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    m = torch.empty((B, S, HIDDEN), **f32)
    ctx = torch.empty((B, S, HIDDEN, HIDDEN), **f32)
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


# ---- merge, fold and the whole op ------------------------------------------


def merge_stats(m, ctx, den):
    """Merges per-split statistics [B, S, ...] into (m [B, H],
    ctx [B, H, H], den [B, H]) with the online-max rescale exp(m_s - m)."""
    m_all = m.amax(dim=1)                                    # [B, H]
    alpha = torch.exp(m - m_all[:, None, :])                 # [B, S, H]
    return (m_all, (ctx * alpha[..., None]).sum(dim=1),
            (den * alpha).sum(dim=1))


def fold_context(ctx, den, w_out, b_out, g, dim_head: int):
    """(ctx [B, H, H], den [B, H]) -> (ctx2 [B, H, C], bias [C]) in f32:
    head block-diagonal mask, / den, @ Wout, * g (``_forward`` :195-200)."""
    H = ctx.shape[-1]
    head = torch.arange(H, device=ctx.device) // dim_head
    bd = (head[:, None] == head[None, :]).float()
    g = g.float().reshape(())
    ctx2 = (ctx * bd) / den[:, :, None]
    ctx2 = (ctx2 @ w_out.float()) * g
    return ctx2, b_out.float() * g


def _rezero(x, w_q, w_k, w_v, w_out, b_out, g, dim_head, chunk, stats,
            apply):
    B, F, T, C = x.shape
    xr = x.reshape(B, F * T, C)
    dt = x.dtype
    if chunk is None:
        chunk = split_chunk(B, F * T)
    m, ctx, den = merge_stats(*stats(xr, w_k.to(dt).contiguous(),
                                     w_v.to(dt).contiguous(), chunk))
    ctx2, bias = fold_context(ctx, den, w_out, b_out, g, dim_head)
    out = apply(xr, w_q.to(dt).contiguous(), ctx2.to(dt), bias)
    return out.reshape(B, F, T, C)


def linear_attention_rezero(x, w_q, w_k, w_v, w_out, b_out, g,
                            dim_head: int = 32, chunk=None):
    """x [B, F, T, C]; w_q, w_k, w_v [C, H]; w_out [H, C]; b_out [C]; g the
    ReZero gain ([1]). Returns (attention(x) @ w_out + b_out) * g + x in x's
    dtype, through K2 and K3 (their plain versions for CPU tensors).
    ``chunk`` is the rows per split of K2 (default: :func:`split_chunk`)."""
    return _rezero(x, w_q, w_k, w_v, w_out, b_out, g, dim_head, chunk,
                   attention_stats, attention_apply)


def linear_attention_rezero_plain(x, w_q, w_k, w_v, w_out, b_out, g,
                                  dim_head: int = 32, chunk=None):
    """Plain PyTorch version of :func:`linear_attention_rezero`, with the
    same splits, merge and fold, on any device."""
    return _rezero(x, w_q, w_k, w_v, w_out, b_out, g, dim_head, chunk,
                   attention_stats_plain, attention_apply_plain)
