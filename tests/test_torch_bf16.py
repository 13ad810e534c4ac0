"""bf16 compute in the port (``set_compute_dtype``): the encoder trunk and
the U-Net's convolutions and attention projections in bf16, norms, heads
and time MLPs in f32, held to the JAX package's f32 outputs with the
tolerances of tests/test_bf16.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import (jax_estimate, jax_model_and_params, text_batch,
                         torch_model)
from gradtts_tpu.models import GradTTS as JaxGradTTS
from gradtts_tpu_torch.models.tts import set_compute_dtype


@pytest.fixture(scope='module')
def models():
    jmodel, params = jax_model_and_params(seed=9)
    return jmodel, params, set_compute_dtype(torch_model(params),
                                             torch.bfloat16)


def test_cast_keeps_norms_heads_and_gains_f32(models):
    model = models[2]
    sd = model.state_dict()
    for key in ('encoder.emb.weight', 'encoder.proj_m.weight',
                'encoder.proj_w.conv_1.weight',
                'encoder.encoder.norm_layers_1.0.gamma',
                'decoder.estimator.mlp.0.weight',
                'decoder.estimator.downs.0.0.block1.block.1.weight',
                'decoder.estimator.downs.0.2.fn.g'):
        assert sd[key].dtype == torch.float32, key
    for key in ('encoder.prenet.conv_layers.0.weight',
                'encoder.encoder.attn_layers.0.conv_q.weight',
                'decoder.estimator.downs.0.0.block1.block.0.weight',
                'decoder.estimator.downs.0.2.fn.fn.to_qkv.weight',
                'decoder.estimator.ups.0.3.conv.weight',
                'decoder.estimator.final_conv.weight'):
        assert sd[key].dtype == torch.bfloat16, key


def test_encoder_bf16_tracks_jax_f32(models):
    jmodel, params, model = models
    x, xl = text_batch(10, (16, 12))
    mu, logw, _, _ = jmodel.apply(params, jnp.asarray(x), jnp.asarray(xl),
                                  method=JaxGradTTS.encode)
    with torch.no_grad():
        tmu, tlogw, _ = model.encode(torch.from_numpy(x).long(),
                                     torch.from_numpy(xl))
    assert tmu.dtype == torch.float32          # heads run in f32
    for want, got in ((mu, tmu), (logw, tlogw)):
        want = np.asarray(want)
        rel = np.abs(got.numpy() - want).max() / (want.std() + 1e-6)
        assert rel < 0.08, f'bf16 encoder deviates {rel:.3f} of output std'


def test_estimator_bf16_tracks_jax_f32(models):
    jmodel, params, model = models
    rng = np.random.default_rng(11)
    B, T = 2, 32
    y = rng.standard_normal((B, T, 80)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[32], [24]])).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    want = jax_estimate(jmodel, params, y, mask, y * 0.5, t)
    with torch.no_grad():
        got = model.estimate(*map(torch.from_numpy, (y, mask, y * 0.5, t)))
    assert got.dtype == torch.float32          # score returned in f32
    rel = np.abs(got.numpy() - want).max() / (want.std() + 1e-6)
    assert rel < 0.12, f'bf16 deviates {rel:.3f} of output std'
