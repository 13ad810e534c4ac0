"""The port's TextEncoder against ``GradTTS.encode`` of the JAX package on
the same seeded weights, with padded lengths."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import jax_model_and_params, text_batch, torch_model
from gradtts_tpu.models import GradTTS as JaxGradTTS


@pytest.fixture(scope='module')
def models():
    jmodel, params = jax_model_and_params(seed=0)
    return jmodel, params, torch_model(params)


@pytest.mark.parametrize('lengths', [(16, 11), (5, 16, 1)])
def test_encode_matches_jax(models, lengths):
    jmodel, params, tmodel = models
    x, xl = text_batch(1, lengths)
    mu, logw, x_mask, _ = jmodel.apply(params, jnp.asarray(x),
                                       jnp.asarray(xl),
                                       method=JaxGradTTS.encode)
    with torch.no_grad():
        tmu, tlogw, tmask = tmodel.encode(torch.from_numpy(x).long(),
                                          torch.from_numpy(xl))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(x_mask))
    # f32 on both sides over 2 layers of convs, attention and layer norms,
    # summed in different orders: a few ulps of O(1) values
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tlogw.numpy(), np.asarray(logw), rtol=1e-5,
                               atol=1e-5)
    # padding past each length is exactly zero
    for b, n in enumerate(lengths):
        assert tmu[b, n:].abs().sum().item() == 0.0
