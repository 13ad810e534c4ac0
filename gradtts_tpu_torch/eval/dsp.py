"""Shared DSP helpers for objective evaluation: framing, windows, file
discovery, resampling.

Supports the rebuilds of upstream evaluate_tts.py and
upstream eval/evaluate_mcd.py without their librosa / soundfile /
pysptk dependencies (numpy + scipy only).

The port's own copy of gradtts_tpu/eval/dsp.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

import fnmatch
import os
from typing import List

import numpy as np


def find_files(root_dir: str, query=('*.flac', '*.wav'),
               include_root_dir: bool = True) -> List[str]:
    """Recursive wav discovery (parity: eval/evaluate_mcd.py:23-45)."""
    files = []
    for root, _dirnames, filenames in os.walk(root_dir, followlinks=True):
        for q in query:
            for filename in fnmatch.filter(filenames, q):
                files.append(os.path.join(root, filename))
    if not include_root_dir:
        files = [f.replace(root_dir + '/', '') for f in files]
    return files


def basename_noext(path: str) -> str:
    return os.path.splitext(os.path.split(path)[-1])[0]


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (librosa.resample replacement)."""
    if orig_sr == target_sr:
        return x
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(orig_sr, target_sr)
    return resample_poly(x.astype(np.float64), target_sr // g, orig_sr // g)


def frame_signal(x: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    """[T] -> [n_frames, frame_length] by striding (no padding), matching
    the reference's ``(len(x) - n_fft) // n_shift + 1`` frame count
    (evaluate_tts.py sptk_extract)."""
    n_frames = (len(x) - frame_length) // hop + 1
    if n_frames <= 0:
        return np.zeros((0, frame_length), x.dtype)
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n_frames)[:, None]
    return x[idx]


def hamming(n: int) -> np.ndarray:
    return np.hamming(n)


def best_mcep_params(fs: int):
    """(order, alpha) per sampling rate (parity:
    eval/evaluate_mcd.py:106-118)."""
    table = {16000: (23, 0.42), 22050: (34, 0.45), 24000: (34, 0.46),
             44100: (39, 0.53), 48000: (39, 0.55)}
    if fs not in table:
        raise ValueError(f'Not found the setting for {fs}.')
    return table[fs]
