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
    # every parameter stays f32 (flax param_dtype); the convolutions of the
    # trunk and the U-Net and the U-Net's attention compute in bf16, the
    # embedding, the encoder heads and the time MLP in f32
    model = models[2]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    f32_sites = ('encoder.emb', 'encoder.proj_m', 'encoder.proj_w.conv_1',
                 'decoder.estimator.mlp.0')
    bf16_sites = ('encoder.prenet.conv_layers.0',
                  'encoder.encoder.attn_layers.0.conv_q',
                  'decoder.estimator.downs.0.0.block1.block.0',
                  'decoder.estimator.downs.0.2',
                  'decoder.estimator.ups.0.3.conv',
                  'decoder.estimator.final_conv')
    out_dtypes = {}

    def record(name):
        def hook(module, inputs, out):
            out_dtypes.setdefault(name, out.dtype)
        return hook

    modules = dict(model.named_modules())
    hooks = [modules[name].register_forward_hook(record(name))
             for name in f32_sites + bf16_sites]
    x, xl = text_batch(12, (16, 12))
    y = torch.zeros(2, 16, 80)
    try:
        with torch.no_grad():
            model.encode(torch.from_numpy(x).long(), torch.from_numpy(xl))
            model.estimate(y, torch.ones(2, 16), y, torch.tensor([0.3, 0.7]))
    finally:
        for h in hooks:
            h.remove()
    for name in f32_sites:
        assert out_dtypes[name] == torch.float32, name
    for name in bf16_sites:
        assert out_dtypes[name] == torch.bfloat16, name


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


def test_kept_cast_follows_the_parameter():
    # without autograd a conv keeps its bf16 weight across calls, and
    # casts again once the f32 parameter changes (an optimizer step, a
    # load); with autograd the cast is differentiable and not kept
    from gradtts_tpu_torch.models.layers import Conv2d
    conv = Conv2d(4, 8, 3)
    with torch.no_grad():
        first = conv.cast('weight', torch.bfloat16)
        assert conv.cast('weight', torch.bfloat16) is first
        conv.weight.add_(1.0)
        second = conv.cast('weight', torch.bfloat16)
    assert second is not first
    torch.testing.assert_close(second, conv.weight.detach().bfloat16(),
                               rtol=0, atol=0)
    live = conv.cast('weight', torch.bfloat16)
    assert live.grad_fn is not None and live is not second
    assert conv.cast('weight', torch.float32) is conv.weight
