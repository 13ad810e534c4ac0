"""Mel-spectrogram front end: numpy for the data workers, torch for the
device.

The port's own copy of gradtts_tpu/data/mel.py:33-78 (the Slaney-scale
filterbank, librosa's ``mel(htk=False, norm='slaney')``, and the periodic
Hann window), :80-209 (``stft_magnitude``, ``mel_spectrogram``,
``mel_from_padded``) and :211-228 (``mel_spectrogram_np``): importing that
module pulls in JAX. Reference pipeline: reflect pad by (n_fft - hop) / 2,
STFT with center=False, magnitude, mel filterbank, log(clamp(x, 1e-5)); the
result is time-major [..., frames, n_mels].

The tensor functions run on the device of their input and are
differentiable with respect to the waveform. The STFT is ``torch.fft.rfft``
over frames from ``Tensor.unfold`` (the JAX package's default windowed-DFT
matmuls are a TPU lowering of the same transform). The filterbank product
runs in float64 and rounds once to the input's dtype, so it does not
depend on ``torch.backends.cuda.matmul.allow_tf32``, a process-wide flag
that the loader's producer thread must not touch (JAX runs it at
``Precision.HIGHEST``). No hand kernel: the JAX package has no Pallas
kernel here either.
"""

import functools
import math

import numpy as np
import torch
from torch.nn import functional as F


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


@functools.lru_cache(maxsize=16)
def _window(win_length, n_fft, device):
    """The periodic Hann window, zero-padded to ``n_fft`` (centred)."""
    w = torch.from_numpy(hann_window_periodic(win_length))
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = F.pad(w, (pad, n_fft - win_length - pad))
    return w.to(device)


@functools.lru_cache(maxsize=16)
def _basis(sr, n_fft, n_mels, fmin, fmax, device):
    """The filterbank transposed, [1 + n_fft // 2, n_mels] float64."""
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
                            .astype(np.float64).T.copy()).to(device)


def stft_magnitude(y, n_fft=1024, hop_length=256, win_length=1024):
    """|STFT| of [..., T] with center=False and a periodic Hann window:
    [..., n_frames, 1 + n_fft // 2], n_frames = 1 + (T - n_fft) // hop."""
    frames = y.unfold(-1, n_fft, hop_length)
    window = _window(win_length, n_fft, y.device)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs()


def _log_mel(mag, sr, n_fft, n_mels, fmin, fmax):
    basis = _basis(sr, n_fft, n_mels, float(fmin), float(fmax), mag.device)
    mel = (mag.double() @ basis).to(mag.dtype)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(y, n_fft=1024, num_mels=80, sampling_rate=22050,
                    hop_size=256, win_size=1024, fmin=0.0, fmax=8000.0):
    """[..., T] float waveform -> [..., n_frames, num_mels] log-mel."""
    pad = (n_fft - hop_size) // 2
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode='reflect')
    mag = stft_magnitude(y.reshape(*lead, -1), n_fft, hop_size, win_size)
    return _log_mel(mag, sampling_rate, n_fft, num_mels, fmin, fmax)


def mel_from_padded(y_padded, y_lengths=None, n_fft=1024, num_mels=80,
                    sampling_rate=22050, hop_size=256, win_size=1024,
                    fmin=0.0, fmax=8000.0):
    """Log-mel [..., n_frames, num_mels] of audio that is already
    reflect-padded per utterance (``DeviceMelCollate``). int16 input is
    PCM and becomes float32 / 32768 on its device. Frames at or past
    ``y_lengths`` (a tensor or array, one length a row) are zeroed."""
    if y_padded.dtype == torch.int16:
        y_padded = y_padded.float() / 32768.0
    mel = _log_mel(stft_magnitude(y_padded, n_fft, hop_size, win_size),
                   sampling_rate, n_fft, num_mels, fmin, fmax)
    if y_lengths is not None:
        lengths = torch.as_tensor(y_lengths, device=mel.device)
        frames = torch.arange(mel.shape[-2], device=mel.device)
        mel = mel * (frames[:, None] < lengths[..., None, None])
    return mel
