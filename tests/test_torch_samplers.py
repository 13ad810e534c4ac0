"""The port's samplers against the JAX package's on the tiny seeded model:
the DPM-Solver grid, the ``stoc`` Euler-Maruyama branch with the draws of
the JAX key chain, DPM-Solver-2M, and ``synthesize(sampler=, stoc=)`` end
to end with the same noise. Mirrors tests/test_dpm_sampler.py, whose
trained-weights fidelity test stays with the JAX package: here the port's
DPM-k and Euler-k are held to JAX's on the same random weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (JaxGradTTS, jax_model_and_params, text_batch,
                         torch_model)
from gradtts_tpu.models import GradTTS as JaxModel
from gradtts_tpu.models import synthesize as jax_synthesize
from gradtts_tpu.models.diffusion import get_noise as jax_get_noise
from gradtts_tpu.models.diffusion import reverse_diffusion as jax_reverse
from gradtts_tpu.models.diffusion import \
    reverse_diffusion_dpm as jax_reverse_dpm
from gradtts_tpu_torch.models.diffusion import (dpm_grid, interp,
                                                reverse_diffusion,
                                                reverse_diffusion_dpm)
from gradtts_tpu_torch.models.tts import GradTTS, synthesize
from gradtts_tpu_torch.utils.convert import flax_params_to_state_dict

B, TY, Y_MAX = 2, 32, 64
BETA = (0.05, 20.0)


@pytest.fixture(scope='module')
def tiny():
    jmodel, params = jax_model_and_params(seed=31)
    rng = np.random.default_rng(32)
    mu = (rng.standard_normal((B, TY, 80)) * 0.5).astype(np.float32)
    mask = np.ones((B, TY, 1), np.float32)
    mask[1, TY - 8:] = 0.0
    z = (mu + rng.standard_normal(mu.shape)).astype(np.float32)
    return jmodel, params, torch_model(params), z, mask, mu


def _jax_est(jmodel, params):
    def est(x_t, m2d, mu, t, s):
        return jmodel.apply(params, x_t, m2d, mu, t, s, spk_is_embedded=True,
                            method=JaxGradTTS.estimate)
    return est


def _jax_grid(n):
    """The grid lines of ``reverse_diffusion_dpm`` (diffusion.py:738-749)."""
    dtype = jnp.float32
    tt = jnp.linspace(jnp.asarray(0.02, dtype), 1.0, 2049)
    zt = 0.5 * jax_get_noise(tt, *BETA, cumulative=True)
    lam_tab = -zt - 0.5 * jnp.log(-jnp.expm1(-2.0 * zt))
    lam_edges = jnp.linspace(lam_tab[-1], lam_tab[0], n + 1)
    ts = jnp.interp(lam_edges, lam_tab[::-1], tt[::-1])
    zetas = 0.5 * jax_get_noise(ts, *BETA, cumulative=True)
    return [np.asarray(a) for a in (
        ts, jnp.exp(-zetas), jnp.sqrt(-jnp.expm1(-2.0 * zetas)),
        lam_edges[1:] - lam_edges[:-1])]


def _jax_step_times(n):
    """The times at which the JAX DPM sampler itself calls its estimator."""
    seen = []

    def est(x_t, m2d, mu, t, s):
        jax.debug.callback(lambda v: seen.append(float(v[0])), t)
        return jnp.zeros_like(x_t)

    z = jnp.ones((1, 4, 2))
    jax.block_until_ready(jax_reverse_dpm(est, z, jnp.ones((1, 4, 1)), z, n,
                                          *BETA))
    return np.asarray(seen, np.float32)


@pytest.mark.parametrize('n', [1, 4, 8, 10])
def test_dpm_grid_matches_jax(n):
    got = [a.numpy() for a in dpm_grid(n, *BETA)]
    want = _jax_grid(n)
    for name, g, w in zip(('ts', 'alphas', 'sigmas', 'hs'), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_allclose(got[0][:n], _jax_step_times(n), rtol=1e-6)
    assert got[0][0] == 1.0 and abs(got[0][-1] - 0.02) < 1e-7
    assert (got[3] > 0).all() and np.ptp(got[3]) < 1e-5 * got[3][0]


def test_interp_matches_numpy_endpoint_rule():
    xp = np.array([0.0, 1.0, 2.0, 4.0], np.float32)
    fp = np.array([3.0, 1.0, 5.0, -1.0], np.float32)
    x = np.array([-1.0, 0.0, 0.5, 1.0, 3.0, 4.0, 9.0], np.float32)
    got = interp(*map(torch.from_numpy, (x, xp, fp))).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.interp(x, xp, fp)),
                               rtol=1e-7)
    np.testing.assert_allclose(got, np.interp(x, xp, fp), rtol=1e-7)


def _jax_stoc_draws(key, n, shape):
    """The per-step normals of the JAX ``stoc`` branch: key, sub =
    split(key) each step (diffusion.py:680-685)."""
    draws = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(draws)


def _close(got, want):
    # test_torch_synthesize.py's tolerance: the U-Net's ~1e-5 relative
    # agreement carried through the steps, bounded by the largest value
    want = np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _port_est(model):
    return model.decoder.estimator


def test_stoc_euler_matches_jax_with_its_draws(tiny):
    jmodel, params, model, z, mask, mu = tiny
    key = jax.random.PRNGKey(33)
    want = jax.jit(lambda z_, m_, mu_: jax_reverse(
        _jax_est(jmodel, params), z_, m_, mu_, 6, *BETA, stoc=True,
        key=key))(z, mask, mu)
    draws = _jax_stoc_draws(key, 6, z.shape)
    with torch.no_grad():
        got = reverse_diffusion(_port_est(model), *map(
            torch.from_numpy, (z, mask, mu)), 6, *BETA, stoc=True,
            noise=torch.from_numpy(draws))
    _close(got.numpy(), want)
    # the draws matter: the ODE branch lands elsewhere
    with torch.no_grad():
        ode = reverse_diffusion(_port_est(model), *map(
            torch.from_numpy, (z, mask, mu)), 6, *BETA)
    assert np.abs(ode.numpy() - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize('sampler,k', [('dpm', 4), ('dpm', 8), ('dpm', 10),
                                       ('euler', 4), ('euler', 8),
                                       ('euler', 10)])
def test_sampler_matches_jax_on_random_weights(tiny, sampler, k):
    jmodel, params, model, z, mask, mu = tiny
    jfn, tfn = ((jax_reverse_dpm, reverse_diffusion_dpm) if sampler == 'dpm'
                else (jax_reverse, reverse_diffusion))
    want = jax.jit(lambda *a: jfn(_jax_est(jmodel, params), *a, k, *BETA))(
        z, mask, mu)
    with torch.no_grad():
        got = tfn(_port_est(model), *map(torch.from_numpy, (z, mask, mu)),
                  k, *BETA)
    _close(got.numpy(), want)


def test_dpm_masked_frames_are_exactly_zero(tiny):
    _, _, model, z, mask, mu = tiny
    with torch.no_grad():
        out = reverse_diffusion_dpm(_port_est(model), *map(
            torch.from_numpy, (z, mask, mu)), 4, *BETA).numpy()
    assert np.all(out[1, TY - 8:] == 0.0)
    assert np.isfinite(out).all()


@pytest.mark.parametrize('sampler,stoc', [('euler', True), ('dpm', False),
                                          ('dpm', True)])
def test_synthesize_matches_jax(tiny, sampler, stoc):
    jmodel, params, model = tiny[:3]
    x, xl = text_batch(34, (16, 9))
    noise = np.random.default_rng(35).standard_normal(
        (2, Y_MAX, 80)).astype(np.float32)
    key = jax.random.PRNGKey(36)
    want = jax_synthesize(jmodel, params, jnp.asarray(x), jnp.asarray(xl),
                          n_timesteps=5, y_max_length=Y_MAX, key=key,
                          temperature=1.5, stoc=stoc, sampler=sampler,
                          noise=jnp.asarray(noise))
    # synthesize splits its key in three; the SDE's chain starts at the last
    draws = _jax_stoc_draws(jax.random.split(key, 3)[2], 5, noise.shape)
    got = synthesize(model, torch.from_numpy(x).long(), torch.from_numpy(xl),
                     n_timesteps=5, y_max_length=Y_MAX, temperature=1.5,
                     noise=torch.from_numpy(noise), stoc=stoc,
                     sampler=sampler, stoc_noise=torch.from_numpy(draws))
    np.testing.assert_array_equal(got.y_lengths.numpy(),
                                  np.asarray(want.y_lengths))
    np.testing.assert_array_equal(got.attn.numpy(), np.asarray(want.attn))
    _close(got.decoder_outputs.numpy(), want.decoder_outputs)
    frames = got.y_mask[..., 0] == 0
    assert bool((got.decoder_outputs[frames] == 0).all())


def test_dpm_ignores_stoc_and_stoc_draws_from_the_generator(tiny):
    model = tiny[2]
    x, xl = text_batch(37, (16, 9))
    args = (torch.from_numpy(x).long(), torch.from_numpy(xl))
    kw = dict(n_timesteps=3, y_max_length=Y_MAX)

    def run(**extra):
        return synthesize(model, *args, **kw, **extra,
                          generator=torch.Generator().manual_seed(0))
    dpm = run(sampler='dpm')
    assert torch.equal(dpm.decoder_outputs,
                       run(sampler='dpm', stoc=True).decoder_outputs)
    a, b = run(stoc=True), run(stoc=True)
    assert torch.equal(a.decoder_outputs, b.decoder_outputs)
    assert not torch.equal(a.decoder_outputs, run().decoder_outputs)
    with pytest.raises(ValueError, match='sampler'):
        run(sampler='heun')


# --- tests/test_dpm_sampler.py on the port ---------------------------------

HP = dict(n_vocab=60, n_enc_channels=32, filter_channels=64,
          filter_channels_dp=16, n_heads=2, n_enc_layers=1, n_feats=16,
          dec_dim=16)


@pytest.fixture(scope='module')
def dpm_setup():
    """The JAX test's model and inputs: JAX's own init (ReZero gains 0),
    carried to the port by the bridge."""
    jmodel = JaxModel(**HP)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(1, HP['n_vocab'], (B, 8)), jnp.int32)
    xl = jnp.asarray([8, 6], jnp.int32)
    y = jnp.asarray(rng.standard_normal((B, TY, HP['n_feats'])), jnp.float32)
    yl = jnp.asarray([TY, TY - 8], jnp.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, xl, y, yl, None)
    model = GradTTS(**HP).eval()
    model.load_state_dict(flax_params_to_state_dict(
        jax.device_get(params)), strict=True)
    mu = np.asarray(rng.standard_normal((B, TY, HP['n_feats'])) * 0.5,
                    np.float32)
    mask = np.ones((B, TY, 1), np.float32)
    mask[1, TY - 8:] = 0.0
    z = mu + np.asarray(jax.random.normal(jax.random.PRNGKey(1), mu.shape))
    return model, [torch.from_numpy(np.asarray(a, np.float32))
                   for a in (z, mask, mu)]


def test_dpm_beats_euler_at_equal_steps(dpm_setup):
    model, (z, mask, mu) = dpm_setup
    est = model.decoder.estimator

    def err(a, b):
        return float((a - b).abs().max())

    with torch.no_grad():
        truth = reverse_diffusion(est, z, mask, mu, 400, *BETA)
        e10 = err(reverse_diffusion(est, z, mask, mu, 10, *BETA), truth)
        d10 = err(reverse_diffusion_dpm(est, z, mask, mu, 10, *BETA), truth)
        d4 = err(reverse_diffusion_dpm(est, z, mask, mu, 4, *BETA), truth)
    assert d10 < e10 / 3, f'dpm10={d10:.4f} euler10={e10:.4f}'
    assert d4 < e10 * 1.5, f'dpm4={d4:.4f} euler10={e10:.4f}'
