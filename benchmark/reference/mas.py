"""Monotonic alignment search in NumPy, as the published Cython
``maximum_path_c`` (Grad-TTS model/monotonic_align/core.pyx) computes it:
float32 sums, -1e9 for the unreachable, the path traced back from the last
token; vectorised over the batch and the tokens, one frame at a time."""

import numpy as np

NEG = np.float32(-1e9)


def maximum_path(value, mask):
    """value, mask [B, Tx, Ty] float32 -> the 0/1 path [B, Tx, Ty]."""
    value = (value * mask).astype(np.float32)
    B, tx_max, ty_max = value.shape
    t_x = mask[:, :, 0].sum(1).astype(np.int64)
    t_y = mask[:, 0, :].sum(1).astype(np.int64)
    xs = np.arange(tx_max)
    acc = value.copy()
    rows = np.arange(B)[:, None]
    for y in range(ty_max):
        lo = np.maximum(t_x + y - t_y, 0)[:, None]
        hi = np.minimum(t_x, y + 1)[:, None]
        band = (xs[None] >= lo) & (xs[None] < hi) & (y < t_y)[:, None]
        if y == 0:
            cur = np.full((B, tx_max), NEG, np.float32)
            prev = np.full((B, tx_max), NEG, np.float32)
            prev[:, 0] = 0.0
        else:
            cur = acc[:, :, y - 1].copy()
            prev = np.concatenate([np.full((B, 1), NEG, np.float32),
                                   acc[:, :-1, y - 1]], axis=1)
        if y < tx_max:
            cur[:, y] = NEG
        acc[:, :, y] = np.where(band, np.maximum(cur, prev) + value[:, :, y],
                                value[:, :, y])
    path = np.zeros_like(value)
    index = t_x - 1
    for y in range(ty_max - 1, -1, -1):
        on = y < t_y
        path[rows[:, 0][on], index[on], y] = 1.0
        move = on & (index != 0)
        ix = np.maximum(index, 1)
        step = (index == y) | (acc[rows[:, 0], ix, max(y - 1, 0)]
                                < acc[rows[:, 0], ix - 1, max(y - 1, 0)])
        index = np.where(move & step, index - 1, index)
    return path
