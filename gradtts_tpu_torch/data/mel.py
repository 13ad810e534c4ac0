"""Mel-spectrogram front end for the data workers, in numpy.

The port's own copy of gradtts_tpu/data/mel.py:33-78 (the Slaney-scale
filterbank, librosa's ``mel(htk=False, norm='slaney')``, and the periodic
Hann window) and :211-228 (``mel_spectrogram_np``): importing that module
pulls in JAX. Reference pipeline: reflect pad by (n_fft - hop) / 2, STFT
with center=False, magnitude, mel filterbank, log(clamp(x, 1e-5)); the
result is time-major [..., frames, n_mels].
"""

import functools
import math

import numpy as np


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    mels = 3.0 * f / 200.0
    above = f >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10)
                                                / min_log_hz) / logstep, mels)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freqs = 200.0 * m / 3.0
    above = m >= min_log_mel
    return np.where(above, 1000.0 * np.exp(logstep * (m - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr, n_fft, n_mels=80, fmin=0.0, fmax=8000.0):
    """[n_mels, 1 + n_fft // 2] float32 Slaney filterbank."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(fmin),
                                           hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window_periodic(win_length):
    """torch.hann_window default (periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(
        np.float32)


def mel_spectrogram_np(y, n_fft=1024, num_mels=80, sampling_rate=22050,
                       hop_size=256, win_size=1024, fmin=0.0, fmax=8000.0):
    """[..., T] waveform -> [..., n_frames, num_mels] float32 log-mel."""
    y = np.asarray(y, dtype=np.float32)
    pad = (n_fft - hop_size) // 2
    y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, pad)], mode='reflect')
    window = hann_window_periodic(win_size)
    if win_size < n_fft:
        wpad = (n_fft - win_size) // 2
        window = np.pad(window, (wpad, n_fft - win_size - wpad))
    n_frames = 1 + (y.shape[-1] - n_fft) // hop_size
    idx = (np.arange(n_frames) * hop_size)[:, None] + np.arange(n_fft)[None, :]
    frames = y[..., idx] * window
    mag = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)).astype(np.float32)
    mel = mag @ mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax).T
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)
