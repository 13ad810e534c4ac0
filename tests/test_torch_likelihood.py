"""The port's likelihood engine against the JAX package's on the tiny
seeded model: forward mode through the score U-Net, the SDEs, the Euler
likelihood of ``score_batch`` with the probe the JAX key drew, and the
adaptive Dormand-Prince integrator (analytic Gaussian case and the tiny
model). Mirrors tests/test_likelihood.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (JaxGradTTS, jax_model_and_params, text_batch,
                         torch_model)
from gradtts_tpu.likelihood import ode as jode
from gradtts_tpu.likelihood import sde as jsde
from gradtts_tpu.nbest.scoring import score_batch as jax_score_batch
from gradtts_tpu_torch.likelihood import ode as tode
from gradtts_tpu_torch.likelihood import sde as tsde
from gradtts_tpu_torch.nbest.scoring import score_batch

B, TY = 2, 32


def _jax_probe(key, shape):
    """The Rademacher probe ``get_likelihood_fn`` draws from ``key``
    (gradtts_tpu/likelihood/ode.py:86-87)."""
    return np.asarray(jax.random.randint(key, shape, 0, 2)
                      .astype(jnp.float32) * 2.0 - 1.0)


@pytest.fixture(scope='module')
def tiny():
    jmodel, params = jax_model_and_params(seed=5)
    x, x_lengths = text_batch(6, lengths=(16, 11))
    rng = np.random.default_rng(7)
    y = rng.standard_normal((B, TY, 80)).astype(np.float32) - 2.0
    y_lengths = np.array([TY, 24], np.int32)
    y[1, 24:] = 0.0
    targs = [torch.from_numpy(a) for a in (x.astype(np.int64), x_lengths, y,
                                           y_lengths)]
    return dict(jmodel=jmodel, params=params, model=torch_model(params),
                jargs=[jnp.asarray(a) for a in (x, x_lengths, y, y_lengths)],
                targs=targs)


def test_unet_jvp_matches_jax_estimate_jvp(tiny):
    """torch.func.jvp of the port's U-Net (K1's and the attention's
    forward-mode rules) against jax.jvp of the JAX estimate with the
    streaming custom_jvp attention (``fused_attention='jvp'``)."""
    rng = np.random.default_rng(8)
    xt, mu, eps = (rng.standard_normal((B, TY, 80)).astype(np.float32)
                   for _ in range(3))
    mask = (np.arange(TY)[None] < np.array([[TY], [24]])).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    jmodel, params = tiny['jmodel'], tiny['params']

    @jax.jit
    def jvp(xt, eps):
        return jax.jvp(lambda a: jmodel.apply(
            params, a, jnp.asarray(mask), jnp.asarray(mu), jnp.asarray(t),
            fused_attention='jvp', method=JaxGradTTS.estimate), (xt,), (eps,))

    want = [np.asarray(o) for o in jvp(jnp.asarray(xt), jnp.asarray(eps))]
    model = tiny['model']
    with torch.no_grad():
        got = torch.func.jvp(
            lambda a: model.estimate(a, torch.from_numpy(mask),
                                     torch.from_numpy(mu),
                                     torch.from_numpy(t)),
            (torch.from_numpy(xt),), (torch.from_numpy(eps),))
    # f32 on both sides through ~40 convs, 25 group norms and 6 attentions
    # in other orders (the estimator's tolerance, test_torch_estimator.py),
    # for the primal and for its tangent
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


SDES = {
    'vp': lambda m, mu, mask: m.VPSDE(beta_min=0.05, beta_max=20.0),
    'subvp': lambda m, mu, mask: m.SubVPSDE(),
    've': lambda m, mu, mask: m.VESDE(),
    'speech': lambda m, mu, mask: m.SpeechSDE(beta_min=0.05, beta_max=20.0,
                                              N=1000, mu=mu, mask=mask),
}


@pytest.mark.parametrize('name', list(SDES))
def test_sdes_match_jax(name):
    rng = np.random.default_rng(9)
    x, mu = (rng.standard_normal((B, 8, 4)).astype(np.float32)
             for _ in range(2))
    mask = np.ones((B, 8, 1), np.float32)
    t = np.array([0.3, 0.8], np.float32)
    j = SDES[name](jsde, jnp.asarray(mu), jnp.asarray(mask))
    p = SDES[name](tsde, torch.from_numpy(mu), torch.from_numpy(mask))
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    px, pt = torch.from_numpy(x), torch.from_numpy(t)
    pairs = list(zip(p.sde(px, pt), j.sde(jx, jt))) \
        + list(zip(p.marginal_prob(px, pt), j.marginal_prob(jx, jt))) \
        + [(p.prior_logp(px), j.prior_logp(jx))]
    # the same f32 formulas: within a few ulps
    for got, want in pairs:
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    draw = p.prior_sampling((B, 8, 4), torch.Generator().manual_seed(0))
    assert draw.shape == (B, 8, 4) and torch.isfinite(draw).all()


def test_probe_is_rademacher_or_gaussian():
    gen = torch.Generator().manual_seed(0)
    r = tode.sample_probe((4, 50, 3), 'Rademacher', gen)
    assert set(r.unique().tolist()) == {-1.0, 1.0}
    g = tode.sample_probe((4, 50, 3), 'Gaussian', gen)
    assert g.dtype == torch.float32 and g.std() > 0.5
    with pytest.raises(NotImplementedError):
        tode.sample_probe((1,), 'Bernoulli', gen)


def test_score_batch_euler_matches_jax(tiny):
    """4-step Euler ``score_batch`` with the probe the JAX key drew."""
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, *a: jax_score_batch(
        tiny['jmodel'], p, key, *a, n_euler=4))(tiny['params'],
                                                *tiny['jargs'])
    eps = _jax_probe(key, (B, TY, 80))
    got = score_batch(tiny['model'], *tiny['targs'], n_euler=4,
                      epsilon=torch.from_numpy(eps))
    assert got.nfe == 4 and got.converged
    # f32 on both sides: the U-Net's ~1e-5 relative difference per call
    # (test_torch_estimator.py) carried through 4 steps; scores are sums
    # over 2560 frames-by-bins of O(1) terms: 1e-5 relative
    for name in ('score', 'prior_logp', 'delta_logp', 'z'):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _gauss_logp(x, mu):
    return (-0.5 * np.sum((x - mu) ** 2, axis=(1, 2))
            - x[0].size / 2.0 * math.log(2 * math.pi))


def test_dopri_analytic_speech_sde():
    """p_0 = N(mu, I) has the true score -(x - mu): the likelihood is the
    Gaussian density, and the adaptive integrator takes the JAX package's
    steps (tests/test_likelihood.py:44-69)."""
    rng = np.random.default_rng(1)
    mu = rng.standard_normal((B, 8, 4)).astype(np.float32)
    mask = np.ones((B, 8, 1), np.float32)
    data = (mu + rng.standard_normal((B, 8, 4))).astype(np.float32)
    key = jax.random.PRNGKey(0)
    j = jsde.SpeechSDE(beta_min=0.05, beta_max=20.0, N=1000,
                       mu=jnp.asarray(mu), mask=jnp.asarray(mask))
    want = jax.jit(jode.get_likelihood_fn(
        j, lambda x, t: -(x - jnp.asarray(mu)), euler=0))(
        key, jnp.asarray(data))
    p = tsde.SpeechSDE(beta_min=0.05, beta_max=20.0, N=1000,
                       mu=torch.from_numpy(mu), mask=torch.from_numpy(mask))
    got = tode.get_likelihood_fn(
        p, lambda x, t: -(x - torch.from_numpy(mu)), euler=0)(
        torch.from_numpy(data),
        epsilon=torch.from_numpy(_jax_probe(key, data.shape)))
    assert got.converged and bool(want.converged)
    assert got.nfe == int(want.nfe)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-5)
    # and the density itself, at the JAX test's tolerance
    np.testing.assert_allclose(-got.score.numpy(), _gauss_logp(data, mu),
                               rtol=2e-3, atol=5e-2)


def test_dopri_flags_nonconvergence():
    # a budget of two attempts at a tolerance they cannot meet
    p = tsde.VPSDE(beta_min=0.05, beta_max=20.0)
    data = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 8, 4)).astype(np.float32))
    res = tode.get_likelihood_fn(p, lambda x, t: -x, euler=0, rtol=1e-8,
                                 atol=1e-8, max_steps=14)(
        data, generator=torch.Generator().manual_seed(0))
    assert not res.converged and res.nfe == 14


def test_dopri_tiny_model_matches_jax(tiny):
    """The adaptive integrator through the tiny U-Net at rtol = atol =
    1e-2: the same attempts (nfe), convergence, and scores."""
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda p, *a: jax_score_batch(
        tiny['jmodel'], p, key, *a, n_euler=0, rtol=1e-2, atol=1e-2))(
        tiny['params'], *tiny['jargs'])
    got = score_batch(tiny['model'], *tiny['targs'], n_euler=0, rtol=1e-2,
                      atol=1e-2,
                      epsilon=torch.from_numpy(_jax_probe(key, (B, TY, 80))))
    assert (got.nfe, got.converged) == (int(want.nfe), bool(want.converged))
    assert got.converged
    # the random U-Net's flow amplifies the ~1e-5 relative difference of
    # each call (test_torch_estimator.py): 4 Euler steps keep 1e-5, the
    # ~60 evaluations here reach ~2e-4 on prior_logp: 1e-3 of each score
    for name in ('score', 'prior_logp', 'delta_logp'):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-3,
                                   err_msg=name)
