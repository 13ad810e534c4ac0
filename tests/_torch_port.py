"""Shared set-up of the tests that hold gradtts_tpu_torch to gradtts_tpu: a
tiny GradTTS whose every parameter is drawn from a numpy seed, in both
packages."""

import contextlib
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gradtts_tpu.models import GradTTS as JaxGradTTS
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.tts import GradTTS
from gradtts_tpu_torch.utils.convert import flax_params_to_state_dict

# the ljspeech vocabulary at tiny widths; dec_dim 16 gives U-Net levels of
# 16, 32 and 64 channels, each a multiple of the 8 GroupNorm groups
TINY = dict(n_enc_channels=32, filter_channels=64, filter_channels_dp=16,
            n_heads=2, n_enc_layers=2, n_feats=80, dec_dim=16)
TINY_SET = ['encoder.n_enc_channels=32', 'encoder.filter_channels=64',
            'encoder.filter_channels_dp=16', 'encoder.n_enc_layers=2',
            'decoder.dec_dim=16']
N_VOCAB = get_config('ljspeech').n_vocab

# The tiny shapes gain nothing from torch's intra-op threads, and with
# several pytest workers on one machine those threads oversubscribe its
# cores (measured: 3.6x the CPU time of these tests, 2x their wall time).
torch.set_num_threads(1)


def _draw(rng, shape, name):
    if shape == (1,):                 # ReZero gain: non-zero, so the
        return rng.uniform(0.3, 0.7, shape)   # attention contributes
    if len(shape) == 1:               # biases, norm scales and shifts
        return rng.standard_normal(shape) * 0.3
    # kernels [..., in, out]: std gain/sqrt(fan_in). A random score does not
    # pull x_t back towards mu, so the 10 Euler steps grow x_t - mu about
    # exp(0.5 * integral of beta) ~ 150-fold; the linear attention is
    # quadratic in its input's scale. The gains keep the U-Net's un-normed
    # residual stream finite for inputs up to 1000x their start while the
    # attention still moves the output by ~10%.
    gain = next((g for key, g in _GAINS if key in name), 1.0)
    return rng.standard_normal(shape) * gain / np.sqrt(np.prod(shape[:-1]))


_GAINS = (('to_qkv', 0.05), ('res_conv', 0.3), ('_down', 0.5), ('_up', 0.5))


def seeded_tree(tree, seed: int):
    """Every leaf of a param tree redrawn from ``seed`` as numpy f32."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    new = [_draw(rng, np.shape(l), jax.tree_util.keystr(path)).astype(
        np.float32) for path, l in leaves]
    return jax.tree_util.tree_unflatten(treedef, new)


def jax_model_and_params(seed: int = 0, **overrides):
    """The JAX GradTTS at the tiny widths (``overrides`` change them or add
    speakers) and a param tree drawn from ``seed``. A speaker model is
    initialised with a speaker (id 0, or a zero vector for ``n_spks``
    -1), so that its speaker MLP has parameters."""
    hp = {**TINY, **overrides}
    model = JaxGradTTS(n_vocab=N_VOCAB, **hp)
    x = jnp.ones((1, 8), jnp.int32)
    y = jnp.zeros((1, 16, hp['n_feats']), jnp.float32)
    n_spks = hp.get('n_spks', 1)
    spk = (jnp.zeros((1,), jnp.int32) if n_spks > 1 else
           jnp.zeros((1, hp.get('spk_emb_dim', 64))) if n_spks == -1
           else None)
    # every leaf is redrawn, so the tree's shapes are all that init must give
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x,
                            jnp.array([8]), y, jnp.array([16]), spk)
    return model, seeded_tree(shapes, seed)


def jax_estimate(model, params, x_t, mask, mu, t, **kw):
    """``GradTTS.estimate`` of the JAX package, jitted (op-by-op
    execution of the folded U-Net costs several times its compile)."""
    fn = jax.jit(lambda p, *a: model.apply(p, *a, method=JaxGradTTS.estimate,
                                           **kw))
    return np.asarray(fn(params, *map(jnp.asarray, (x_t, mask, mu, t))))


def torch_model(params, **overrides):
    """The port's GradTTS (f32, CPU) with the JAX params loaded strictly."""
    model = GradTTS(n_vocab=N_VOCAB, **{**TINY, **overrides})
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return model.eval()


def text_batch(seed: int, lengths=(16, 11), t_x: int = 16):
    """Token ids [B, Tx] padded with zeros past each length."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, N_VOCAB, (len(lengths), t_x)).astype(np.int32)
    for b, n in enumerate(lengths):
        x[b, n:] = 0
    return x, np.asarray(lengths, np.int32)


def ragged_batch(seed: int):
    """A training batch of 4 whose halves differ in length, as two ranks'
    blocks of a global batch: rows 0-1 long (64 and 60 frames, cropped at
    32), rows 2-3 short (20 and 24 frames, shorter than the crop)."""
    rng = np.random.default_rng(seed)
    xl = np.array([16, 14, 6, 5], np.int32)
    x = rng.integers(1, N_VOCAB, (4, 16)).astype(np.int32)
    x *= np.arange(16)[None] < xl[:, None]
    yl = np.array([64, 60, 20, 24], np.int32)
    y = rng.standard_normal((4, 64, 80)).astype(np.float32)
    y *= (np.arange(64)[None, :, None] < yl[:, None, None])
    return {'x': x, 'x_lengths': xl, 'y': y, 'y_lengths': yl}


CMUDICT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'resources', 'cmu_dictionary')


def write_corpus(directory, n_items: int = 5, sr: int = 22050,
                 speakers=None):
    """Synthetic wavs (a sine plus noise, 0.3-0.7 s, PCM16) and their
    ``path|text`` filelist in ``directory`` (``path|text|speaker`` lines
    with ``speakers``, one id an item); returns the filelist's path."""
    from scipy.io import wavfile
    lines = []
    for i in range(n_items):
        rng = np.random.default_rng(i)
        t = np.arange(int(sr * (0.3 + 0.1 * (i % 5)))) / sr
        wav = (0.3 * np.sin(2 * np.pi * (180 + 20 * i) * t)
               + 0.05 * rng.standard_normal(t.shape))
        path = str(directory / f'{i}.wav')
        wavfile.write(path, sr, (wav * 32767).astype(np.int16))
        lines.append(f'{path}|hello world, number {i}.'
                     + (f'|{speakers[i]}' if speakers is not None else ''))
    filelist = directory / 'list.txt'
    filelist.write_text('\n'.join(lines) + '\n')
    return str(filelist)


def _groupnorm_f64(x, gamma, beta, groups, eps, phases):
    """GroupNorm's affine output with two-pass f64 statistics, rounded to
    f32 once: x [B, F, T, C], C = phases * len(gamma), the statistics
    pooled over the phase dim as the JAX package's ``_reference`` pools
    them."""
    B, F, T, C = x.shape
    cg = C // phases // groups
    x64 = np.asarray(x, np.float64).reshape(B, F, T, phases, groups, cg)
    mean = x64.mean(axis=(1, 2, 3, 5), keepdims=True)
    var = ((x64 - mean) ** 2).mean(axis=(1, 2, 3, 5), keepdims=True)
    g = np.asarray(gamma, np.float64).reshape(1, 1, 1, 1, groups, cg)
    b = np.asarray(beta, np.float64).reshape(1, 1, 1, 1, groups, cg)
    return ((x64 - mean) / np.sqrt(var + eps) * g + b).reshape(
        B, F, T, C).astype(np.float32)


@contextlib.contextmanager
def f64_groupnorm_statistics():
    """Both packages' plain GroupNorm + Mish with two-pass f64 statistics
    (``_groupnorm_f64``) in place of their single-pass f32 E[x^2] - E[x]^2,
    the Mish and the mask as before. Over a frame budget that is mostly
    padding the f32 formula cancels, and there the two packages part by as
    much as their summation orders differ; with these statistics what is
    left is the rest of the model. JAX reaches numpy through
    ``pure_callback``; its traces are dropped on entry and exit."""
    from gradtts_tpu.ops.pallas import groupnorm_mish as jgn
    from gradtts_tpu_torch.ops import groupnorm_mish as tgn

    def jax_plain(x, mask, gamma, beta, groups, eps, phases=1):
        y = jax.pure_callback(
            lambda a, g, b: _groupnorm_f64(a, g, b, groups, eps, phases),
            jax.ShapeDtypeStruct(x.shape, jnp.float32), x, gamma, beta)
        return (jgn._mish_f32(y) * mask.astype(jnp.float32)).astype(x.dtype)

    def torch_plain(x, mask, gamma, beta, groups=8, eps=1e-5):
        y = torch.from_numpy(_groupnorm_f64(
            x.detach().float().numpy(), gamma.detach().numpy(),
            beta.detach().numpy(), groups, eps, 1))
        return (tgn.mish_f32(y) * mask.float()).to(x.dtype)

    saved = jgn._reference, tgn.groupnorm_mish_plain
    jgn._reference, tgn.groupnorm_mish_plain = jax_plain, torch_plain
    jax.clear_caches()
    try:
        yield
    finally:
        jgn._reference, tgn.groupnorm_mish_plain = saved
        jax.clear_caches()
