"""Mel-cepstrum extraction via frequency-warped real cepstrum.

Replaces pysptk.mcep / pysptk.sp2mc in the rebuilds of
upstream evaluate_tts.py:118-156 and
upstream eval/evaluate_mcd.py:48-100.

Method: per frame, the log magnitude spectrum is resampled onto the
first-order all-pass warped frequency axis (warping constant ``alpha``,
the mel approximation pysptk uses), then the real cepstrum of the warped
log spectrum is taken and truncated to ``order+1`` coefficients. This is
the classical "warped cepstrum"; SPTK's mcep additionally runs a Newton
refinement for spectral-envelope fit, but for DISTORTION metrics both
sides go through the same linear-ish transform, so MCD comparisons remain
meaningful. Deviation documented here deliberately (no pysptk dependency).

The port's own copy of gradtts_tpu/eval/mcep.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

import numpy as np

from gradtts_tpu_torch.eval.dsp import frame_signal, hamming


def warp_frequency(omega: np.ndarray, alpha: float) -> np.ndarray:
    """First-order all-pass frequency warp omega -> omega~ (radians)."""
    return omega + 2.0 * np.arctan2(alpha * np.sin(omega),
                                    1.0 - alpha * np.cos(omega))


def log_spectrum_to_mcep(logmag: np.ndarray, order: int,
                         alpha: float) -> np.ndarray:
    """[N, K] log-magnitude half-spectra (K bins over [0, pi]) ->
    [N, order+1] warped cepstra."""
    n_half = logmag.shape[1]
    omega_t = np.linspace(0.0, np.pi, n_half)       # uniform warped grid
    # source (linear) frequency that maps onto each warped target bin:
    # warp(. , alpha) and warp(. , -alpha) are inverses
    omega_s = warp_frequency(omega_t, -alpha)
    pos = omega_s / np.pi * (n_half - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n_half - 1)
    frac = pos - lo
    warped = logmag[:, lo] * (1 - frac) + logmag[:, hi] * frac

    # real cepstrum of the (symmetric) warped log spectrum
    full = np.concatenate([warped, warped[:, -2:0:-1]], axis=1)
    ceps = np.fft.ifft(full, axis=1).real
    return ceps[:, :order + 1]


def mcep_from_waveform(x: np.ndarray, fs: int, n_fft: int = 512,
                       n_shift: int = 256, order: int = 25,
                       alpha: float = 0.41, eps: float = 1e-6,
                       window: str = 'hamming') -> np.ndarray:
    """Frame -> hamming window -> periodogram -> warped cepstrum
    (parity surface: sptk_extract, evaluate_tts.py:118-138: same framing
    ``(len(x)-n_fft)//n_shift + 1``, same hamming window, etype=1 eps)."""
    x = np.asarray(x, np.float64)
    frames = frame_signal(x, n_fft, n_shift)
    if frames.shape[0] == 0:
        return np.zeros((0, order + 1))
    win = hamming(n_fft) if window == 'hamming' else np.hanning(n_fft)
    spec = np.abs(np.fft.rfft(frames * win, n_fft, axis=1))
    logmag = np.log(np.maximum(spec, eps))
    return log_spectrum_to_mcep(logmag, order, alpha)
