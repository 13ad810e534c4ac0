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
