"""The weight bridge: a JAX param tree -> reference-layout ``state_dict`` ->
the port's modules (strict), and back through the JAX package's own
``gradtts_torch_to_flax`` bit for bit."""

import numpy as np
import pytest

import jax

from _torch_port import jax_model_and_params, torch_model
from gradtts_tpu.utils.convert import gradtts_torch_to_flax
from gradtts_tpu.utils.io import save_params_npz
from gradtts_tpu_torch.utils.convert import (flax_params_to_state_dict,
                                             load_checkpoint)


@pytest.fixture(scope='module')
def params():
    return jax_model_and_params(seed=8)[1]


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(path))


def test_round_trip_is_exact(params):
    sd = flax_params_to_state_dict(params)
    model = torch_model(params)         # load_state_dict(strict=True)
    assert set(sd) == set(model.state_dict())
    back = gradtts_torch_to_flax(model.state_dict(), params)
    _assert_trees_equal(back, params)


def test_transposed_conv_is_unflipped(params):
    # the JAX Upsample stores the spatially flipped ConvTranspose2d kernel
    sd = flax_params_to_state_dict(params)
    k = np.asarray(params['params']['estimator']['ups_0_up']['kernel'])
    w = sd['decoder.estimator.ups.0.3.conv.weight'].numpy()
    np.testing.assert_array_equal(w[:, :, 0, 0], k[3, 3])
    np.testing.assert_array_equal(w[:, :, 3, 1], k[0, 2])


def test_load_checkpoint_npz(params, tmp_path):
    path = str(tmp_path / 'p.npz')
    save_params_npz(path, params)
    sd = load_checkpoint(path)
    want = flax_params_to_state_dict(params)
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy())


def test_load_checkpoint_refuses_directories(tmp_path):
    with pytest.raises(ValueError, match='unsupported checkpoint directory'):
        load_checkpoint(str(tmp_path))
