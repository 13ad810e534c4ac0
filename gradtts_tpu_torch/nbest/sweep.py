"""Rescoring-weight search: TPE sampler + local refinement.

Behavioral parity target: the reference sweeps the 9 rescoring weights
with hydra's optuna TPE sweeper, 500 trials over box intervals
(the reference's n_best/config/hydra/sweep.yaml). optuna isn't a
dependency here, so this module provides:

- ``tpe_minimize``: a self-contained univariate Tree-structured Parzen
  Estimator matching optuna's default independent-TPE behavior (startup
  random trials, gamma split into good/bad, Parzen KDE per side, pick the
  candidate maximizing l(x)/g(x));
- ``refine``: scipy Nelder-Mead polish of the best TPE point (the
  reference also imports scipy.optimize.minimize, analyse_scores.py:6).

The port's own copy of gradtts_tpu/nbest/sweep.py (numpy only; the JAX
package's ``nbest`` imports JAX on import).
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np


def _parzen_logpdf(x: np.ndarray, centers: np.ndarray, sigma: np.ndarray,
                   lo: float, hi: float) -> np.ndarray:
    """Mixture-of-Gaussians log density, truncated to [lo, hi]."""
    from scipy.stats import norm
    x = x[:, None]
    c = centers[None, :]
    s = sigma[None, :]
    comp = norm.logpdf(x, loc=c, scale=s)
    # truncation normalizer per component
    z = norm.cdf((hi - c) / s) - norm.cdf((lo - c) / s)
    comp = comp - np.log(np.maximum(z, 1e-12))
    return np.logaddexp.reduce(comp, axis=1) - np.log(centers.size)


def _parzen_sample(rng, centers: np.ndarray, sigma: np.ndarray,
                   lo: float, hi: float, size: int) -> np.ndarray:
    idx = rng.integers(0, centers.size, size)
    out = rng.normal(centers[idx], sigma[idx])
    return np.clip(out, lo, hi)


def _bandwidths(centers: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """optuna-style: neighbor distances, clipped to the magic range."""
    order = np.argsort(centers)
    sorted_c = centers[order]
    ext = np.concatenate([[lo], sorted_c, [hi]])
    gaps = np.maximum(ext[2:] - ext[:-2], 1e-12)
    sigma = np.empty_like(centers)
    sigma[order] = gaps
    width = hi - lo
    return np.clip(sigma, width / max(100.0, centers.size), width)


class TPEResult:
    def __init__(self, best_params, best_value, trials):
        self.best_params = best_params
        self.best_value = best_value
        self.trials = trials  # list of (params_dict, value)


def tpe_minimize(objective: Callable[[Dict[str, float]], float],
                 space: Dict[str, Tuple[float, float]],
                 n_trials: int = 100, seed: int = 1,
                 n_startup_trials: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24,
                 fixed: Optional[Dict[str, float]] = None) -> TPEResult:
    """Minimize objective over a box. ``fixed`` entries are passed through
    to the objective unchanged (weights held at a constant)."""
    rng = np.random.default_rng(seed)
    names = list(space)
    los = np.array([space[k][0] for k in names])
    his = np.array([space[k][1] for k in names])
    X = np.empty((0, len(names)))
    y = np.empty((0,))
    trials = []

    for trial in range(n_trials):
        if trial < n_startup_trials or X.shape[0] < 2:
            x = rng.uniform(los, his)
        else:
            n_good = max(1, int(np.ceil(gamma * X.shape[0])))
            order = np.argsort(y)
            good, bad = X[order[:n_good]], X[order[n_good:]]
            x = np.empty(len(names))
            for d in range(len(names)):
                gc, bc = good[:, d], bad[:, d]
                gs = _bandwidths(gc, los[d], his[d])
                cand = _parzen_sample(rng, gc, gs, los[d], his[d],
                                      n_candidates)
                lg = _parzen_logpdf(cand, gc, gs, los[d], his[d])
                if bc.size:
                    bs = _bandwidths(bc, los[d], his[d])
                    lb = _parzen_logpdf(cand, bc, bs, los[d], his[d])
                else:
                    lb = np.zeros_like(lg)
                x[d] = cand[np.argmax(lg - lb)]
        params = dict(zip(names, x.tolist()))
        if fixed:
            params = {**fixed, **params}
        value = float(objective(params))
        X = np.vstack([X, x])
        y = np.append(y, value)
        trials.append((params, value))

    best = int(np.argmin(y))
    best_params = dict(zip(names, X[best].tolist()))
    if fixed:
        best_params = {**fixed, **best_params}
    return TPEResult(best_params, float(y[best]), trials)


def refine(objective: Callable[[Dict[str, float]], float],
           start: Dict[str, float],
           space: Dict[str, Tuple[float, float]],
           maxiter: int = 200) -> Tuple[Dict[str, float], float]:
    """Nelder-Mead polish clamped to the box."""
    from scipy.optimize import minimize
    names = list(space)
    los = np.array([space[k][0] for k in names])
    his = np.array([space[k][1] for k in names])

    def f(v):
        v = np.clip(v, los, his)
        params = dict(start)
        params.update(zip(names, v.tolist()))
        return float(objective(params))

    x0 = np.array([start.get(k, (lo + hi) / 2)
                   for k, lo, hi in zip(names, los, his)])
    res = minimize(f, x0, method='Nelder-Mead',
                   options={'maxiter': maxiter, 'xatol': 1e-4,
                            'fatol': 1e-6})
    v = np.clip(res.x, los, his)
    out = dict(start)
    out.update(zip(names, v.tolist()))
    return out, float(res.fun)


#: the reference's sweep box (n_best/config/hydra/sweep.yaml params)
DEFAULT_SPACE = {
    'am_score': (-1.0, 0.0),
    'bpe_lm_score': (0.0, 2.0),
    'first_pass_length_penalty': (-3.0, 0.0),
    'ngram_lm_score': (-2.0, 0.0),
    'diffusion_score': (-0.003, 0.000),
    'ngram_lm_score_oov': (-1.0, 0.0),
    'ngram_lm_score_non_oov': (-1.0, 0.0),
    'first_pass_score': (-2.0, 0.0),
    'second_pass_score': (-2.0, 0.0),
}
