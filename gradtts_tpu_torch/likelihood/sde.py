"""SDE library: VP / sub-VP / VE SDEs and the Grad-TTS SpeechSDE.

Counterpart of gradtts_tpu/likelihood/sde.py (``VPSDE`` :25, ``SubVPSDE``
:65, ``VESDE`` :83, ``SpeechSDE`` :113, ``reverse_drift_fn`` :144), which
follows the reference's n_best/likelihood/sde_lib.py. Each SDE is a frozen
dataclass of scalars (plus the speech conditioning tensors); ``t`` is a
Python float or a [B] tensor. Prior draws take an explicit
``torch.Generator``.

Layout: time-major mels [B, T, F], as in the JAX package. The math is
elementwise or reduced over all non-batch axes, so only ``prior_logp``'s
constant depends on the shape, and it counts the padded event size.
"""

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch


def _bcast(t, x):
    """A per-batch [B] tensor t broadcast over the event axes of x; a
    Python float or 0-dim tensor as it is."""
    if not torch.is_tensor(t) or t.dim() == 0:
        return t
    return t.reshape(t.shape + (1,) * (x.dim() - t.dim()))


def _sqrt(v):
    return torch.sqrt(v) if torch.is_tensor(v) else math.sqrt(v)


def _exp(v):
    return torch.exp(v) if torch.is_tensor(v) else math.exp(v)


def _event_size(z) -> int:
    return math.prod(z.shape[1:])


def _event_sum(z):
    return z.sum(dim=tuple(range(1, z.dim())))


@dataclass(frozen=True)
class VPSDE:
    beta_min: float = 0.1
    beta_max: float = 20.0
    N: int = 1000

    @property
    def T(self):
        return 1.0

    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def _log_mean_coeff(self, t):
        return (-0.25 * t ** 2 * (self.beta_max - self.beta_min)
                - 0.5 * t * self.beta_min)

    def sde(self, x, t):
        beta_t = self.beta(t)
        return -0.5 * _bcast(beta_t, x) * x, _sqrt(beta_t)

    def marginal_prob(self, x, t):
        lmc = self._log_mean_coeff(t)
        return _bcast(_exp(lmc), x) * x, _sqrt(1.0 - _exp(2.0 * lmc))

    def prior_sampling(self, shape, generator=None, device=None):
        return torch.randn(shape, generator=generator, device=device)

    def prior_logp(self, z):
        n = _event_size(z)
        return -n / 2.0 * math.log(2 * math.pi) - _event_sum(z ** 2) / 2.0


@dataclass(frozen=True)
class SubVPSDE(VPSDE):
    def sde(self, x, t):
        beta_t = self.beta(t)
        discount = 1.0 - _exp(-2 * self.beta_min * t
                              - (self.beta_max - self.beta_min) * t ** 2)
        return -0.5 * _bcast(beta_t, x) * x, _sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        lmc = self._log_mean_coeff(t)
        return _bcast(_exp(lmc), x) * x, 1.0 - _exp(2.0 * lmc)


@dataclass(frozen=True)
class VESDE:
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    N: int = 1000

    @property
    def T(self):
        return 1.0

    def _sigma(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def sde(self, x, t):
        diffusion = self._sigma(t) * math.sqrt(
            2 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self._sigma(t)

    def prior_sampling(self, shape, generator=None, device=None):
        return torch.randn(shape, generator=generator,
                           device=device) * self.sigma_max

    def prior_logp(self, z):
        n = _event_size(z)
        return (-n / 2.0 * math.log(2 * math.pi * self.sigma_max ** 2)
                - _event_sum(z ** 2) / (2 * self.sigma_max ** 2))


@dataclass(frozen=True)
class SpeechSDE(VPSDE):
    """VP-SDE with the text-conditional mean: dx = 0.5 beta (mu - x) dt +
    sqrt(beta) dW (sde_lib.py:256-297). ``mu`` [B, T, F]; ``mask``
    [B, T, 1] (None: every frame counts)."""
    mu: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None

    def sde(self, x, t):
        beta_t = self.beta(t)
        return 0.5 * _bcast(beta_t, x) * (self.mu - x), _sqrt(beta_t)

    def marginal_prob(self, x, t):
        decay = _bcast(_exp(self._log_mean_coeff(t)), x)
        mean = decay * x + (1.0 - decay) * self.mu
        return mean, _sqrt(1.0 - _exp(2.0 * self._log_mean_coeff(t)))

    def prior_sampling(self, shape=None, generator=None, device=None):
        return self.mu + torch.randn(self.mu.shape, generator=generator,
                                     device=self.mu.device,
                                     dtype=self.mu.dtype)

    def prior_logp(self, z):
        # the constant counts the padded event size, as the reference does
        n = _event_size(z)
        return (-n / 2.0 * math.log(2 * math.pi)
                - _event_sum((z - self.mu) ** 2) / 2.0)


def reverse_drift_fn(sde, score_fn: Callable, probability_flow: bool = True):
    """Drift of the reverse-time SDE, or of the probability-flow ODE
    (sde_lib.py:70-109). score_fn(x, t) is the model's score with its own
    sigma normalisation."""
    mult = 0.5 if probability_flow else 1.0

    def drift(x, t):
        f, g = sde.sde(x, t)
        return f - _bcast(g ** 2, x) * score_fn(x, t) * mult

    return drift
