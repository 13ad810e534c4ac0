"""gradtts_tpu_torch.ops.seq is exactly gradtts_tpu.ops.seq."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gradtts_tpu.ops import seq as jseq
from gradtts_tpu_torch.ops import seq as tseq


@pytest.mark.parametrize('max_length', [1, 7, 32])
def test_sequence_mask_equals_jax(max_length):
    lengths = np.array([0, 1, 5, 7, 32], np.int32)
    want = np.asarray(jseq.sequence_mask(jnp.asarray(lengths), max_length))
    got = tseq.sequence_mask(torch.from_numpy(lengths), max_length).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('length_scale', [1.0, 1.5])
def test_generate_path_equals_jax(length_scale):
    rng = np.random.default_rng(0)
    B, t_x, t_y = 3, 9, 40
    dur = (np.ceil(rng.uniform(0.2, 4.0, (B, t_x))) * length_scale
           ).astype(np.float32)
    x_mask = (np.arange(t_x)[None] < np.array([[9], [6], [1]])).astype(
        np.float32)
    y_mask = (np.arange(t_y)[None] < np.array([[40], [17], [3]])).astype(
        np.float32)
    dur *= x_mask
    mask = x_mask[:, :, None] * y_mask[:, None, :]
    want = np.asarray(jseq.generate_path(jnp.asarray(dur), jnp.asarray(mask)))
    got = tseq.generate_path(torch.from_numpy(dur),
                             torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
