"""One call of the port's score U-Net against ``GradTTS.estimate`` of the
JAX package on the same seeded weights and inputs: the JAX default path
(``fold_freq=True``, ``fused_attention=False``) and the unfolded one."""

import numpy as np
import pytest
import torch

from _torch_port import jax_estimate, jax_model_and_params, torch_model


@pytest.fixture(scope='module')
def case():
    jmodel, params = jax_model_and_params(seed=3)
    rng = np.random.default_rng(4)
    B, T, F = 2, 64, 80
    xt = rng.standard_normal((B, T, F)).astype(np.float32)
    mu = rng.standard_normal((B, T, F)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[64], [40]])).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    with torch.no_grad():
        got = torch_model(params).estimate(
            *map(torch.from_numpy, (xt, mask, mu, t))).numpy()
    return jmodel, params, (xt, mask, mu, t), got


@pytest.mark.parametrize('fold_freq', [True, False])
def test_estimate_matches_jax(case, fold_freq):
    jmodel, params, inputs, got = case
    want = jax_estimate(jmodel, params, *inputs, fused_attention=False,
                        fold_freq=fold_freq)
    # f32 on both sides through ~40 convs, 25 group norms and 6 attentions
    # whose reductions run in different orders (XLA vs oneDNN): ~1e-5
    # relative per layer leaves ~1e-5 absolute on O(1) outputs
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # frames past each mask are exactly zero
    assert np.abs(got[1, 40:]).max() == 0.0
