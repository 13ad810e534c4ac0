"""Probability-flow ODE log-likelihood with the Hutchinson divergence.

Counterpart of gradtts_tpu/likelihood/ode.py (``_drift_and_div`` :56,
``get_likelihood_fn`` :70, ``_dopri54`` :139), which follows the
reference's n_best/likelihood/likelihood.py:

- divergence: eps^T (d f / d x) eps, the directional derivative of the
  masked drift along the probe eps by ``torch.func.jvp`` (forward mode, as
  ``jax.jvp``), summed over all non-batch axes in f32;
- fixed-step Euler: N steps forward in time, from the data (t ~ 0) to the
  prior (t = 1), at the midpoints t = (i + 0.5) / N;
- adaptive: an embedded Dormand-Prince 5(4) with the JAX package's step
  control, one host sync per attempted step; ``converged`` is False when
  ``max_steps`` drift evaluations ran out before t1.

The probe is an explicit input: ``epsilon=`` as it is, or drawn from
``generator`` (Rademacher randint(0, 2) * 2 - 1, or Gaussian); a
``models.layers.RowShard`` draws it at the global batch's shape and keeps
this rank's rows.

Data parallelism: where each process holds a block of the batch's rows,
the integrators take the 'data' process group. Euler needs no collective;
the Dormand-Prince error norm sums its squares and its element count over
the group, so every rank takes the steps that one process takes on the
global batch, as JAX's ``err_norm`` does over a sharded batch.
"""

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gradtts_tpu_torch.likelihood.sde import reverse_drift_fn
from gradtts_tpu_torch.models.layers import draw
from gradtts_tpu_torch.utils.profiling import span


class LikelihoodResult(NamedTuple):
    score: torch.Tensor       # [B] -(prior_logp + delta_logp)
    prior_logp: torch.Tensor  # [B]
    delta_logp: torch.Tensor  # [B]
    z: torch.Tensor           # latent at t = T
    nfe: int                  # drift evaluations: euler, or 7 per attempt
    converged: bool           # always True for Euler


def _masked(x, sde):
    mask = getattr(sde, 'mask', None)
    return x * mask if mask is not None else x


def _drift_and_div(sde, score_fn):
    drift = reverse_drift_fn(sde, score_fn, probability_flow=True)

    def masked_drift(x, t):
        return _masked(drift(_masked(x, sde), t), sde)

    def f(x, t, eps):
        d, jvp = torch.func.jvp(lambda xx: masked_drift(xx, t), (x,), (eps,))
        div = (jvp.float() * eps.float()).sum(dim=tuple(range(1, x.dim())))
        return d, div

    return f


def sample_probe(shape, hutchinson_type: str = 'Rademacher', generator=None,
                 dtype=torch.float32, device=None):
    """The Hutchinson probe (``ode.py:82-88``): Rademacher +-1 or standard
    normal, drawn from ``generator`` (a ``torch.Generator``, or a
    ``RowShard``: this rank's rows of the draw at the global shape)."""
    if hutchinson_type == 'Gaussian':
        return draw(torch.randn, shape, generator, dtype=dtype,
                    device=device)
    if hutchinson_type == 'Rademacher':
        return draw(functools.partial(torch.randint, 0, 2), shape,
                    generator, device=device).to(dtype) * 2.0 - 1.0
    raise NotImplementedError(hutchinson_type)


def get_likelihood_fn(sde, score_fn: Callable, hutchinson_type='Rademacher',
                      rtol=1e-5, atol=1e-5, eps=1e-5, euler=0,
                      max_steps=10_000, group=None):
    """likelihood_fn(data, generator=None, epsilon=None) ->
    :class:`LikelihoodResult`. ``euler`` > 0 selects the fixed-step Euler
    integrator with that many steps, 0 the adaptive Dormand-Prince 5(4),
    which stops after ``max_steps`` drift evaluations. ``group``: the
    'data' process group over whose ranks the batch's rows are split
    (None for one process)."""
    f = _drift_and_div(sde, score_fn)

    def likelihood_fn(data, generator=None,
                      epsilon: Optional[torch.Tensor] = None):
        data = _masked(data, sde)
        if epsilon is None:
            epsilon = sample_probe(data.shape, hutchinson_type, generator,
                                   data.dtype, data.device)
        epsilon = epsilon.to(data)
        B = data.shape[0]
        with span('gradtts.likelihood'):
            if euler > 0:
                h = 1.0 / euler
                z = data
                delta_logp = torch.zeros((B,), dtype=torch.float32,
                                         device=data.device)
                for i in range(euler):
                    # f32 arithmetic as the JAX scan's (i + 0.5) * h
                    t = (torch.full((B,), float(i), dtype=data.dtype,
                                    device=data.device) + 0.5) * h
                    d, div = f(z, t, epsilon)
                    z, delta_logp = z + d * h, delta_logp + div * h
                nfe, converged = euler, True
            else:
                z, delta_logp, nfe, converged = _dopri54(
                    f, data, epsilon, t0=eps, t1=sde.T, rtol=rtol,
                    atol=atol, max_steps=max_steps, group=group)
        prior_logp = sde.prior_logp(z)
        return LikelihoodResult(-(prior_logp + delta_logp), prior_logp,
                                delta_logp, z, nfe, converged)

    return likelihood_fn


# ---- adaptive Dormand-Prince 5(4) -----------------------------------------

_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_C = [0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1]
_DP_B5 = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
_DP_B4 = [5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40]


def _dopri54(f, x0, epsilon, t0, t1, rtol, atol, max_steps=10_000,
             group=None):
    """Integrates (x, delta_logp) from t0 to t1; the divergence rides along
    as an extra state coordinate. The step control is ``_dopri54`` :139-194
    of the JAX package: the error norm over the whole batch, the factor
    clip(0.9 err^-0.2, 0.2, 5), h = min(h, t1 - t), 7 evaluations counted
    per attempt, done when t >= t1 - 1e-12. Time and step size are f32
    scalars on the host. Under ``group`` (the 'data' ranks, each with its
    rows of the batch) the squares' sum and the element count are summed
    over the ranks, so every rank takes the global batch's steps. Returns
    (x, delta_logp, nfe, converged)."""
    B = x0.shape[0]
    f32 = np.float32
    h = f32((t1 - t0) * 0.01)
    t, t1 = f32(t0), f32(t1)
    x = x0
    dlp = torch.zeros((B,), dtype=torch.float32, device=x0.device)
    nfe, done = 0, False
    n = x0.numel() + dlp.numel()
    while not done and nfe < max_steps:
        h = min(h, f32(t1 - t))
        ks_x, ks_d = [], []
        for i in range(7):
            xi, di = x, dlp
            for j, a in enumerate(_DP_A[i]):
                ha = float(h * f32(a))
                xi = xi + ha * ks_x[j]
                di = di + ha * ks_d[j]
            ti = float(t + f32(_DP_C[i]) * h)
            kx, kd = f(xi, torch.full((B,), ti, dtype=x0.dtype,
                                      device=x0.device), epsilon)
            ks_x.append(kx)
            ks_d.append(kd)
        x5 = x + float(h) * sum(b * k for b, k in zip(_DP_B5, ks_x))
        d5 = dlp + float(h) * sum(b * k for b, k in zip(_DP_B5, ks_d))
        x4 = x + float(h) * sum(b * k for b, k in zip(_DP_B4, ks_x))
        d4 = dlp + float(h) * sum(b * k for b, k in zip(_DP_B4, ks_d))
        scale_x = atol + rtol * torch.maximum(x.abs(), x5.abs())
        scale_d = atol + rtol * torch.maximum(dlp.abs(), d5.abs())
        s = (((x5 - x4) / scale_x) ** 2).sum() \
            + (((d5 - d4) / scale_d) ** 2).sum()
        count = n
        if group is not None:
            sn = torch.stack([s, s.new_full((), n)])
            dist.all_reduce(sn, group=group)
            s, count = sn
        err = f32(torch.sqrt(s / count).item())
        if err <= 1.0:
            t, x, dlp = f32(t + h), x5, d5
        h = f32(h * np.clip(f32(0.9) * (err + f32(1e-12)) ** f32(-0.2),
                            f32(0.2), f32(5.0)))
        nfe += 7
        done = bool(t >= f32(t1 - 1e-12))
    return x, dlp, nfe, done
