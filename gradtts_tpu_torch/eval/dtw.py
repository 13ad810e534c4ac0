"""Exact dynamic time warping with Euclidean frame distance.

Replaces fastdtw in upstream evaluate_tts.py:166,182 and
upstream eval/evaluate_mcd.py:163. fastdtw is an approximation with
a radius parameter; at TTS utterance lengths (hundreds of frames) the
exact O(T1*T2) DP is cheap, vectorized row-by-row in numpy, and returns
the same (distance, path) interface.

The port's own copy of gradtts_tpu/eval/dtw.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

from typing import List, Tuple

import numpy as np


def dtw_path(a: np.ndarray, b: np.ndarray
             ) -> Tuple[float, List[Tuple[int, int]]]:
    """a: [T1, D], b: [T2, D] -> (total cost, monotone alignment path of
    (i, j) pairs from (0,0) to (T1-1, T2-1))."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    T1, T2 = a.shape[0], b.shape[0]
    if T1 == 0 or T2 == 0:
        return 0.0, []
    # pairwise Euclidean distances in one shot
    d = np.sqrt(np.maximum(
        (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T),
        0.0))

    INF = np.inf
    acc = np.full((T1 + 1, T2 + 1), INF)
    acc[0, 0] = 0.0
    # step pattern: (i-1,j), (i,j-1), (i-1,j-1) — same as fastdtw
    for i in range(1, T1 + 1):
        prev = acc[i - 1]
        row = acc[i]
        np.minimum(prev[1:], prev[:-1], out=row[1:])  # up / diagonal
        # left dependency is sequential within the row
        di = d[i - 1]
        run = row[0]
        for j in range(1, T2 + 1):
            best = row[j] if row[j] < run else run
            run = best + di[j - 1]
            row[j] = run
    # backtrace
    path = []
    i, j = T1, T2
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        steps = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(steps)
    path.reverse()
    return float(acc[T1, T2]), path


def align(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """DTW-align two feature tracks; returns (a[path_i], b[path_j]) like
    the reference's ``twf`` indexing (evaluate_tts.py:167-169)."""
    _, path = dtw_path(a, b)
    twf = np.array(path).T
    return a[twf[0]], b[twf[1]]


def warping_indices(a: np.ndarray, b: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    _, path = dtw_path(a, b)
    twf = np.array(path).T
    return twf[0], twf[1]
