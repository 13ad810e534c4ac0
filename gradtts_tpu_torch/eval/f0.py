"""F0 tracking via YIN (de Cheveigne & Kawahara 2002), vectorized numpy.

Replaces pyworld.harvest in the rebuild of
upstream evaluate_tts.py:141-156 (world_extract). The downstream
metrics (log-F0 RMSE / GPE / VDE / FFE, evaluate_tts.py:86-117) only need
an F0 contour with 0 marking unvoiced frames, which YIN provides; both
pred and ref go through the same tracker so the comparison stays fair.

All frames are processed as one batched FFT — no per-frame Python loop.

The port's own copy of gradtts_tpu/eval/f0.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

import numpy as np

from gradtts_tpu_torch.eval.dsp import frame_signal


def yin_f0(x: np.ndarray, fs: int, f0min: float = 70.0, f0max: float = 400.0,
           frame_length: int = 1024, hop: int = 256,
           threshold: float = 0.15, energy_floor: float = 1e-4) -> np.ndarray:
    """[T] waveform -> [n_frames] F0 in Hz (0 = unvoiced).

    Frame count matches the mcep extractor ((T - frame_length)//hop + 1) so
    F0 and cepstra align frame-for-frame.
    """
    x = np.asarray(x, np.float64)
    tau_max = min(int(fs / f0min) + 1, frame_length // 2)
    tau_min = max(2, int(fs / f0max))
    frames = frame_signal(x, frame_length, hop)            # [N, L]
    n_frames = frames.shape[0]
    if n_frames == 0:
        return np.zeros((0,))

    W = frame_length - tau_max                              # integration window
    a = frames[:, :W]

    # cross-correlation corr[tau] = sum_j a[j] * frame[j + tau], tau in [0, tau_max]
    nfft = 1
    while nfft < frame_length + W:
        nfft *= 2
    FA = np.fft.rfft(a, nfft)
    FF = np.fft.rfft(frames, nfft)
    corr = np.fft.irfft(np.conj(FA) * FF, nfft)[:, :tau_max + 1]

    # energy terms
    e0 = np.sum(a ** 2, axis=1, keepdims=True)              # [N, 1]
    csum = np.concatenate(
        [np.zeros((n_frames, 1)), np.cumsum(frames ** 2, axis=1)], axis=1)
    taus = np.arange(tau_max + 1)
    e_tau = csum[:, taus + W] - csum[:, taus]               # [N, tau_max+1]

    d = e0 + e_tau - 2.0 * corr                             # difference fn
    d = np.maximum(d, 0.0)

    # cumulative-mean-normalized difference
    cum = np.cumsum(d[:, 1:], axis=1)
    cmndf = np.ones_like(d)
    with np.errstate(divide='ignore', invalid='ignore'):
        cmndf[:, 1:] = d[:, 1:] * taus[1:] / np.maximum(cum, 1e-12)

    # first below-threshold dip in [tau_min, tau_max]: take the argmin of
    # the whole contiguous dip (the first crossing alone is biased sharp)
    band = cmndf[:, tau_min:tau_max + 1]
    below = band < threshold
    any_below = below.any(axis=1)
    first_below = below.argmax(axis=1)                      # 0 if none
    pos = np.arange(band.shape[1])[None, :]
    started = pos >= first_below[:, None]
    ended = np.cumsum((~below) & started, axis=1) > 0       # dip finished
    in_dip = started & below & ~ended
    masked = np.where(in_dip, band, np.inf)
    tau_rel = np.where(any_below, masked.argmin(axis=1), band.argmin(axis=1))
    tau0 = tau_rel + tau_min

    # parabolic interpolation around tau0
    t_prev = np.clip(tau0 - 1, 0, tau_max)
    t_next = np.clip(tau0 + 1, 0, tau_max)
    idx = np.arange(n_frames)
    y0, y1, y2 = cmndf[idx, t_prev], cmndf[idx, tau0], cmndf[idx, t_next]
    denom = y0 - 2 * y1 + y2
    with np.errstate(divide='ignore', invalid='ignore'):
        delta = np.where(np.abs(denom) > 1e-12,
                         0.5 * (y0 - y2) / denom, 0.0)
    delta = np.clip(np.nan_to_num(delta), -1.0, 1.0)
    tau_ref = tau0 + delta

    f0 = fs / np.maximum(tau_ref, 1e-6)
    rms = np.sqrt(np.mean(frames ** 2, axis=1))
    voiced = any_below & (rms > energy_floor) & (f0 >= f0min) & (f0 <= f0max)
    return np.where(voiced, f0, 0.0)
