"""MAS: the port's plain ``maximum_path_plain`` against the JAX package's
``maximum_path`` (a ``lax.scan``) and its numpy oracle, with the cases of
tests/test_mas.py. The path is compared exactly: both sides add the same
f32 values in the same order per cell."""

import numpy as np
import pytest
import torch

from gradtts_tpu.ops.mas import maximum_path, maximum_path_numpy
from gradtts_tpu_torch.ops import mas as tmas


def _random_problem(rng, b, tx_max, ty_max):
    value = rng.standard_normal((b, tx_max, ty_max)).astype(np.float32)
    t_xs = rng.integers(1, tx_max + 1, size=b)
    t_ys = np.maximum(rng.integers(1, ty_max + 1, size=b), t_xs)
    mask = np.zeros((b, tx_max, ty_max), np.float32)
    for i in range(b):
        mask[i, :t_xs[i], :t_ys[i]] = 1
    return value, mask


def _port(value, mask):
    return tmas.maximum_path_plain(torch.from_numpy(value),
                                   torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize('seed,shape', [(0, (8, 20, 32)), (4, (5, 7, 40)),
                                        (5, (3, 30, 31))])
def test_matches_jax_and_numpy_random(seed, shape):
    value, mask = _random_problem(np.random.default_rng(seed), *shape)
    got = _port(value, mask)
    np.testing.assert_array_equal(got, maximum_path_numpy(value, mask))
    np.testing.assert_array_equal(got, np.asarray(maximum_path(value, mask)))


def test_matches_jax_and_numpy_full_lengths():
    value = np.random.default_rng(1).standard_normal((4, 16, 16)).astype(
        np.float32)
    mask = np.ones_like(value)
    got = _port(value, mask)
    np.testing.assert_array_equal(got, maximum_path_numpy(value, mask))
    np.testing.assert_array_equal(got, np.asarray(maximum_path(value, mask)))


def test_log_prior_scale_ties_broken_alike():
    # values of the training grid's scale (large negative log-priors with
    # repeated columns) make ties of V[x, y-1] and V[x-1, y-1] likely
    rng = np.random.default_rng(6)
    value, mask = _random_problem(rng, 6, 12, 48)
    value = np.round(value * 4.0) - 100.0
    value[:, :, 1::2] = value[:, :, ::2]
    got = _port(value, mask)
    np.testing.assert_array_equal(got, maximum_path_numpy(value, mask))
    np.testing.assert_array_equal(got, np.asarray(maximum_path(value, mask)))


def test_path_properties():
    rng = np.random.default_rng(3)
    value, mask = _random_problem(rng, 6, 12, 24)
    path = _port(value, mask)
    t_xs = mask[:, :, 0].sum(1).astype(int)
    t_ys = mask[:, 0, :].sum(1).astype(int)
    for i in range(len(path)):
        p = path[i, :t_xs[i], :t_ys[i]]
        np.testing.assert_array_equal(p.sum(0), np.ones(t_ys[i]))
        assert (p.sum(1) >= 1).all()
        idx = p.argmax(0)
        assert (np.diff(idx) >= 0).all()
        assert idx[0] == 0 and idx[-1] == t_xs[i] - 1
        assert path[i].sum() == t_ys[i]       # nothing outside the mask


def test_wrapper_takes_plain_version_on_cpu():
    value, mask = _random_problem(np.random.default_rng(7), 2, 6, 10)
    before = tmas.maximum_path.launches
    got = tmas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask))
    assert tmas.maximum_path.launches == before
    np.testing.assert_array_equal(got.numpy(), _port(value, mask))


@pytest.mark.parametrize('tx,ty,route,K', [
    (32, 128, 'register', 4), (128, 512, 'register', 4),
    (129, 512, 'register', 8), (200, 700, 'register', 8),
    (384, 1024, 'register', 12), (512, 2048, 'register', 16),
    (513, 1024, 'block', None), (600, 1400, 'block', None),
    (512, 4096, 'block', None)])
def test_mas_route_picks_cells_a_lane_by_text_length(tx, ty, route, K):
    # the one-warp DP takes every text bucket up to 512 (config x_buckets)
    # with the least K of 4, 8, 12, 16 cells a lane that covers Tx, where
    # its ring and decision words (Tx Ty / 8 bytes) fit in shared memory;
    # longer texts, or more frames than fit, go to the block-wide DP
    assert tmas.mas_route(tx, ty) == (route, K)
    if route == 'register':
        assert 32 * K >= tx and (K == 4 or 32 * (K - 4) < tx)
        assert tmas.dp_smem(K, ty) <= 226 * 1024
    else:
        assert tx > 512 or tmas.dp_smem(16, ty) is None


@pytest.mark.parametrize('seed,shape', [(8, (3, 45, 120)),
                                        (9, (2, 512, 2048))])
def test_matches_jax_at_ragged_and_largest_buckets(seed, shape):
    # Tx not a multiple of 32, and the largest buckets (512 tokens, 2048
    # frames) with one item at full length
    rng = np.random.default_rng(seed)
    value, mask = _random_problem(rng, *shape)
    mask[0] = 1.0
    value = value * 30.0 - 100.0
    np.testing.assert_array_equal(_port(value, mask),
                                  np.asarray(maximum_path(value, mask)))


def _register_route_model(value, mask, K, rng):
    """numpy model of csrc/mas.cu mas_dp_kernel<K>: the band-free frames
    (dp_frames) on 32 K cells, the cells past Tx holding whatever the
    shared memory held (here large values and NaN), the move test as the
    sign of V[x, y-1] - V[x-1, y-1] funnel-shifted into a word per (lane,
    i) and stored bit-reversed every 32 frames, and the backtrace's ballot
    walk."""
    neg = np.float32(-1e9)
    B, tx, ty = value.shape
    n = 32 * K
    path = np.zeros_like(value)
    for b in range(B):
        t_x = int((mask[b, :, 0] != 0).sum())
        t_y = int((mask[b, 0, :] != 0).sum())
        r_all = rng.standard_normal((n, ty)).astype(np.float32) * 1e6
        r_all[tx + 1::3] = np.nan
        r_all[:tx] = value[b] * mask[b]
        v = np.full(n, neg, np.float32)
        words = np.zeros((-(-ty // 32), K, 32), np.int64)
        bits = np.zeros(n, np.int64)
        xs = np.arange(n)
        full = (1 << 32) - 1
        for y in range(t_y):
            head = np.float32(0.0) if y == 0 else neg
            diag = np.concatenate([[head], v[:-1]]).astype(np.float32)
            on_diag = (xs == y) & (y < tx)
            with np.errstate(invalid='ignore'):
                d = np.where(on_diag, np.float32(-1.0), v - diag)
            bits = ((bits << 1) | np.signbit(d)) & full
            v = (np.fmax(np.where(on_diag, neg, v), diag)
                 + r_all[:, y]).astype(np.float32)
            if (y & 31) == 31 or y == t_y - 1:
                shifted = (bits << (31 - (y & 31))) & full
                rev = np.array([int(f'{w:032b}'[::-1], 2) for w in shifted])
                rev[0] = 0                      # x == 0 never moves
                words[y >> 5] = rev.reshape(32, K).T
        index_of = np.full(ty, -1)
        index = t_x - 1
        for w in range((t_y - 1) >> 5, -1, -1):
            cells = index - np.arange(32)
            word = [int(words[w, c % K, c // K]) if c >= 0 else 0
                    for c in cells]
            moves = [sum(((word[j] >> yb) & 1) << j for j in range(32))
                     for yb in range(32)]
            m = 0
            for yb in range(31, -1, -1):
                if 32 * w + yb < t_y:
                    index_of[32 * w + yb] = index - m
                    m += (moves[yb] >> m) & 1
            index -= m
        path[b] = index_of[None, :] == np.arange(tx)[:, None]
    return path


@pytest.mark.parametrize('seed,shape,ties,scale', [
    (10, (4, 45, 150), False, 30.0), (11, (3, 100, 260), True, 30.0),
    (12, (2, 128, 300), False, 30.0), (13, (3, 40, 90), False, 4e8)])
def test_register_route_model_matches_jax(seed, shape, ties, scale):
    # the kernel's arithmetic leaves out the band test and reads garbage
    # past Tx: the path must still be the function's, with ragged lengths,
    # one item at full length, log-prior-scale ties, and values so large
    # that the cells above the diagonal climb past -1e9 (where the x == y
    # select decides)
    rng = np.random.default_rng(seed)
    value, mask = _random_problem(rng, *shape)
    mask[0] = 1.0
    value = value * scale + (scale if scale > 1e3 else -100.0)
    if ties:
        value = np.round(value / 8.0) * 8.0
        value[:, :, 1::2] = value[:, :, ::2]
    K = tmas.mas_route(shape[1], shape[2])[1]
    got = _register_route_model(value, mask, K, rng)
    np.testing.assert_array_equal(got, np.asarray(maximum_path(value, mask)))
