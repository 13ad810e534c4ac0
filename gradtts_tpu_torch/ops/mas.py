"""Monotonic alignment search (the MAS kernel of the port).

Counterpart of gradtts_tpu/ops/mas.py ``maximum_path`` (:88): the Viterbi
dynamic program of ``_forward_dp`` (:31) over the feasible band, then the
backtrace of ``_backtrace`` (:58). The JAX package runs it as a
``lax.scan``; the port runs it as one CUDA kernel, ``csrc/mas.cu``, whose
source says what bounds it on the H100 and how it is laid out. Both give
the path bit for bit: the same f32 additions in the same order per cell.
The kernel has two routes, chosen by shape (:func:`mas_route`): a DP held
in one warp's registers for every text bucket up to 512, and a block-wide
DP for longer texts.
"""

import torch

from gradtts_tpu_torch.ops import _build

MAX_NEG = -1e9

# csrc/mas.cu: the register route's cells a lane (K), its ring of 16-frame
# tiles (2 to 4 stages) and the dynamic shared memory it may take
_DP_K = (4, 8, 12, 16)
_DP_FRAMES, _DP_MAX_STAGES = 16, 4
_DP_SMEM_MAX = 226 * 1024


def dp_smem(K: int, ty_max: int):
    """Shared memory bytes of the register route at K cells a lane
    (csrc/mas.cu ``DpLayout<K>::smem``): the decision words, one bit a cell
    and frame, and as many value * mask tiles (2 to 4) as fit beside them;
    None where two do not."""
    ls = K + 4 if K % 8 == 0 else K
    tile = _DP_FRAMES * (32 * ls + 4) * 4
    dec = -(-ty_max // 32) * K * 32 * 4
    if dec + 2 * tile > _DP_SMEM_MAX:
        return None
    return min(_DP_MAX_STAGES, (_DP_SMEM_MAX - dec) // tile) * tile + dec


def mas_route(tx_max: int, ty_max: int):
    """(route, K) of the CUDA kernel at [*, tx_max, ty_max]: ('register', K)
    for the one-warp DP with K cells a lane (the least K of 4, 8, 12, 16
    with 32 K >= tx_max) where its ring and decision words fit in shared
    memory, else ('block', None), the block-wide DP."""
    K = next((k for k in _DP_K if 32 * k >= tx_max), None)
    if K is None or dp_smem(K, ty_max) is None:
        return 'block', None
    return 'register', K


def _lengths(mask):
    """(t_x, t_y) [B]: the text and mel lengths that the mask spans."""
    return (mask[:, :, 0] != 0).sum(dim=1), (mask[:, 0, :] != 0).sum(dim=1)


def maximum_path_plain(value, mask):
    """Plain PyTorch version: value, mask [B, Tx, Ty] -> the binary path
    [B, Tx, Ty] in value's dtype. Vectorised over the batch and the text
    positions, with a loop over the Ty mel frames."""
    dtype = value.dtype
    value = (value * mask).float()
    B, tx_max, ty_max = value.shape
    t_x, t_y = _lengths(mask)
    xs = torch.arange(tx_max, device=value.device)
    prev = torch.full((B, tx_max), MAX_NEG, device=value.device)
    acc = torch.empty_like(value)                             # V [B, Tx, Ty]
    for y in range(ty_max):
        v_cur = torch.where(xs == y, MAX_NEG, prev)
        head = torch.full((B, 1), 0.0 if y == 0 else MAX_NEG,
                          device=value.device)
        v_prev = torch.cat([head, prev[:, :-1]], dim=1)
        lo = (t_x + y - t_y).clamp_min(0)
        hi = t_x.clamp_max(y + 1)
        band = (xs >= lo[:, None]) & (xs < hi[:, None])
        raw = value[:, :, y]
        prev = torch.where(band, torch.maximum(v_cur, v_prev) + raw, raw)
        acc[:, :, y] = prev
    # x moves to x - 1 after frame y when x != 0 and (x == y or
    # V[x, y-1] < V[x-1, y-1]); the move after frame 0 is never taken
    move = torch.zeros((B, tx_max, ty_max), dtype=torch.bool,
                       device=value.device)
    diag = xs[1:, None] == torch.arange(1, ty_max, device=value.device)
    move[:, 1:, 1:] = diag | (acc[:, 1:, :-1] < acc[:, :-1, :-1])
    path = torch.zeros_like(value)
    index = t_x - 1
    batch = torch.arange(B, device=value.device)
    for y in range(ty_max - 1, -1, -1):
        active = y < t_y
        rows = index.clamp_min(0)
        path[batch, rows, y] = (active & (index >= 0)).float()
        index = torch.where(active & move[batch, rows, y], index - 1, index)
    return path.to(dtype)


def maximum_path(value, mask):
    """value, mask [B, Tx, Ty] f32 -> the binary path [B, Tx, Ty] f32.
    CPU tensors take :func:`maximum_path_plain`; CUDA tensors launch the
    kernel of :func:`mas_route`'s route or raise."""
    if value.device.type == 'cpu':
        return maximum_path_plain(value, mask)
    if value.dim() != 3 or value.dtype != torch.float32:
        raise ValueError('maximum_path: value must be [B, Tx, Ty] f32, got '
                         f'{tuple(value.shape)} {value.dtype}')
    if mask.shape != value.shape or mask.dtype != torch.float32 \
            or mask.device != value.device:
        raise ValueError('maximum_path: mask must be an f32 tensor of '
                         "value's shape on its device")
    value, mask = value.contiguous(), mask.contiguous()
    B, tx_max, ty_max = value.shape
    path = torch.empty_like(value)
    lib = _build.load('mas')
    route, K = mas_route(tx_max, ty_max)
    if route == 'register':
        index_of = torch.empty((B, ty_max), dtype=torch.int32,
                               device=value.device)
        _build.check(lib, lib.gtt_mas_dp(
            value.data_ptr(), mask.data_ptr(), index_of.data_ptr(),
            path.data_ptr(), B, tx_max, ty_max, K,
            _build.stream_of(value)), 'gtt_mas_dp')
    else:
        decision = torch.empty(value.shape, dtype=torch.uint8,
                               device=value.device)
        _build.check(lib, lib.gtt_mas(
            value.data_ptr(), mask.data_ptr(), decision.data_ptr(),
            path.data_ptr(), B, tx_max, ty_max, _build.stream_of(value)),
            'gtt_mas')
    maximum_path.launches += 1
    return path


maximum_path.launches = 0
