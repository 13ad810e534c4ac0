"""The port's HiFi-GAN V1 generator against the JAX package's: the waveform
in f32 for both residual-block kinds on JAX-initialised weights carried by
the bridge, the weight-norm fold of a reference checkpoint, bf16 against
f32, and the config from JSON."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import seeded_tree
from gradtts_tpu.models.hifigan import Generator as JaxGenerator
from gradtts_tpu.models.hifigan import HiFiGANConfig as JaxConfig
from gradtts_tpu.models.hifigan import hifigan_torch_to_flax
from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from gradtts_tpu_torch.utils.convert import (hifigan_flax_to_state_dict,
                                             load_hifigan_state_dict)

# tests/test_hifigan.py's SMALL config (V1 at 64 initial channels) and the
# reference V3 residual blocks ('2'), at tiny widths
SMALL = dict(resblock='1', upsample_rates=[8, 8, 2, 2],
             upsample_kernel_sizes=[16, 16, 4, 4],
             upsample_initial_channel=32, resblock_kernel_sizes=[3, 7, 11],
             resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]])
SMALL2 = dict(resblock='2', upsample_rates=[8, 8, 4],
              upsample_kernel_sizes=[16, 16, 8],
              upsample_initial_channel=32, resblock_kernel_sizes=[3, 5, 7],
              resblock_dilation_sizes=[[1, 2], [2, 6], [3, 12]])


def _mel(seed, frames=20):
    return np.random.default_rng(seed).standard_normal(
        (2, frames, 80)).astype(np.float32)


def _jax_params(cfg_dict, seed):
    """JAX-initialised generator params with every leaf (biases included)
    redrawn non-zero from ``seed``."""
    jgen = JaxGenerator(JaxConfig.from_json(dict(cfg_dict)))
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 80)))
    return jgen, seeded_tree(shapes, seed)


def _port(cfg_dict, params):
    cfg = HiFiGANConfig.from_json(dict(cfg_dict))
    gen = Generator(cfg)
    gen.load_state_dict(hifigan_flax_to_state_dict(params, cfg), strict=True)
    return gen.eval()


@pytest.mark.parametrize('cfg_dict', [SMALL, SMALL2], ids=['resblock1',
                                                             'resblock2'])
def test_generator_matches_jax(cfg_dict):
    jgen, params = _jax_params(cfg_dict, 61)
    mel = _mel(62)
    want = np.asarray(jax.jit(jgen.apply)(params, jnp.asarray(mel)))
    with torch.no_grad():
        got = _port(cfg_dict, params)(torch.from_numpy(mel)).numpy()
    hop = int(np.prod(cfg_dict['upsample_rates']))
    assert got.shape == want.shape == (2, 20 * hop)
    assert got.dtype == np.float32 and np.abs(want).max() > 0.1
    # tests/test_hifigan.py's parity tolerance
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def _reference_layout(plain, seed):
    """A plain generator state_dict as a reference checkpoint stores it:
    every weight split into weight_g ([out, 1, ...] norms, rescaled) and
    weight_v (the direction, rescaled)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, w in plain.items():
        if not key.endswith('.weight'):
            sd[key] = w
            continue
        base = key[:-len('.weight')]
        dims = tuple(range(1, w.ndim))
        scale = torch.from_numpy(rng.uniform(0.5, 2.0, w.shape[0]).astype(
            np.float32)).reshape((-1,) + (1,) * (w.ndim - 1))
        sd[base + '.weight_v'] = w * 3.0
        sd[base + '.weight_g'] = w.pow(2).sum(dims, keepdim=True).sqrt() \
            * scale
    return sd


def test_weight_norm_fold_matches_jax():
    cfg = HiFiGANConfig.from_json(dict(SMALL))
    _, params = _jax_params(SMALL, 63)
    ref_sd = _reference_layout(hifigan_flax_to_state_dict(params, cfg), 64)
    got = load_hifigan_state_dict(ref_sd, cfg)
    want = hifigan_flax_to_state_dict(
        hifigan_torch_to_flax(ref_sd, JaxConfig.from_json(dict(SMALL))), cfg)
    assert set(got) == set(want) == set(Generator(cfg).state_dict())
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=0,
                                   msg=key)
    # plain weights pass through, and the flax inverse round-trips
    plain = hifigan_flax_to_state_dict(params, cfg)
    for key, v in load_hifigan_state_dict(plain, cfg).items():
        assert torch.equal(v, plain[key]), key
    back = hifigan_torch_to_flax(plain, JaxConfig.from_json(dict(SMALL)))
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                      np.asarray(leaf))


def test_missing_layer_raises():
    cfg = HiFiGANConfig.from_json(dict(SMALL))
    sd = Generator(cfg).state_dict()
    del sd['resblocks.11.convs2.2.weight']
    with pytest.raises(KeyError):
        load_hifigan_state_dict(sd, cfg)


def test_bf16_close_to_f32():
    """tests/test_hifigan.py::test_generator_bf16_close_to_f32 on the port:
    bf16 convolutions from f32 parameters, f32 tanh."""
    _, params = _jax_params(SMALL, 65)
    gen = _port(SMALL, params)
    mel = torch.from_numpy(_mel(66))
    with torch.no_grad():
        w32 = gen(mel)
        gen.compute_dtype = torch.bfloat16
        w16 = gen(mel)
    assert w16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    diff = (w16 - w32).abs()
    assert float(diff.max()) < 0.05 and float(diff.mean()) < 5e-3
    assert float(diff.max()) > 0                  # bf16 did run


def test_config_from_json(tmp_path):
    d = dict(SMALL2, num_mels=80, sampling_rate=16000, unused_key=1)
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(d))
    for src in (str(path), d):
        cfg = HiFiGANConfig.from_json(src)
        want = JaxConfig.from_json(src)
        assert cfg.resblock_dilation_sizes == ((1, 2), (2, 6), (3, 12))
        assert cfg.upsample_rates == (8, 8, 4) and cfg.sampling_rate == 16000
        for field in ('resblock', 'upsample_rates', 'upsample_kernel_sizes',
                      'upsample_initial_channel', 'resblock_kernel_sizes',
                      'resblock_dilation_sizes', 'num_mels', 'sampling_rate',
                      'hop_size', 'fmax'):
            assert getattr(cfg, field) == getattr(want, field), field
    v1 = HiFiGANConfig()
    assert v1.upsample_initial_channel == 512
    assert int(np.prod(v1.upsample_rates)) == 256
