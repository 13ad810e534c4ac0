"""WORLD/SPTK DSP backend for the objective TTS metrics.

The reference toolchain (upstream evaluate_tts.py:118-156) extracts
F0 with pyworld ``harvest`` (+ ``cheaptrick`` spectra folded to mel-cepstra
via pysptk ``sp2mc``) and MCD cepstra with pysptk ``mcep`` (Newton-refined
SPTK mel-cepstrum).  Our built-in fast DSP (eval/f0.py YIN, eval/mcep.py
warped cepstrum) is self-consistent but produces absolute values that are
NOT comparable to numbers computed with the reference toolchain.

This module provides the reference-algorithm extractors with two
interchangeable implementations:

- ``impl='pyworld'``: the C libraries themselves, when importable —
  bit-identical to the reference toolchain.
- ``impl='numpy'``: from-scratch numpy re-implementations of the same
  published algorithms (eval/worldnp.py: Harvest, CheapTrick, SPTK
  mel-cepstral analysis) — algorithm-faithful, validated on synthetic
  ground truth, available everywhere.
- ``impl='auto'`` (default): pyworld/pysptk when installed, else numpy.

Parameters match the reference call sites exactly in either case:
harvest(f0_floor=f0min, f0_ceil=f0max, frame_period=n_shift/fs*1000);
mcep(eps=1e-6, etype=1) over hamming-windowed
``(len(x)-n_fft)//n_shift + 1`` frames.  Where both implementations are
installed, tests/test_eval.py cross-checks them against each other.

The port's own copy of gradtts_tpu/eval/world.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

from typing import Tuple

import numpy as np


def world_available() -> bool:
    """True when both pyworld and pysptk can be imported."""
    try:
        import pyworld  # noqa: F401
        import pysptk  # noqa: F401
        return True
    except ImportError:
        return False


def _resolve(impl: str) -> str:
    if impl == 'auto':
        return 'pyworld' if world_available() else 'numpy'
    if impl not in ('pyworld', 'numpy'):
        raise ValueError(f'unknown WORLD impl {impl!r}')
    return impl


def world_extract(x: np.ndarray, fs: int, f0min: float = 70.0,
                  f0max: float = 400.0, n_fft: int = 512,
                  n_shift: int = 256, mcep_dim: int = 34,
                  mcep_alpha: float = 0.45, impl: str = 'auto'
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(mel-cepstra [N, mcep_dim+1], F0 [N]) via WORLD harvest/cheaptrick +
    sp2mc (parity: evaluate_tts.py:141-156)."""
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    if _resolve(impl) == 'pyworld':
        import pyworld
        import pysptk
        f0, time_axis = pyworld.harvest(x, fs, f0_floor=f0min,
                                        f0_ceil=f0max,
                                        frame_period=n_shift / fs * 1000.0)
        sp = pyworld.cheaptrick(x, f0, time_axis, fs, fft_size=n_fft)
        mcep = pysptk.sp2mc(sp, mcep_dim, mcep_alpha)
        return mcep, f0
    from gradtts_tpu_torch.eval import worldnp
    f0, time_axis = worldnp.harvest(x, fs, f0_floor=f0min, f0_ceil=f0max,
                                    frame_period=n_shift / fs * 1000.0)
    sp = worldnp.cheaptrick(x, f0, time_axis, fs, fft_size=n_fft)
    return worldnp.sp2mc(sp, mcep_dim, mcep_alpha), f0


def sptk_mcep(x: np.ndarray, fs: int, n_fft: int = 512, n_shift: int = 256,
              mcep_dim: int = 34, mcep_alpha: float = 0.45,
              impl: str = 'auto') -> np.ndarray:
    """SPTK mel-cepstrum track [N, mcep_dim+1] straight from the waveform
    (parity: sptk_extract, evaluate_tts.py:118-138 — same framing, hamming
    window, eps=1e-6, etype=1)."""
    x = np.asarray(x, np.float64)
    if _resolve(impl) == 'pyworld':
        import pysptk
        n_frame = (len(x) - n_fft) // n_shift + 1
        if n_frame <= 0:
            return np.zeros((0, mcep_dim + 1))
        win = pysptk.sptk.hamming(n_fft)
        return np.stack([
            pysptk.mcep(x[n_shift * i:n_shift * i + n_fft] * win, mcep_dim,
                        mcep_alpha, eps=1e-6, etype=1)
            for i in range(n_frame)])
    from gradtts_tpu_torch.eval import worldnp
    return worldnp.mcep_frames_from_waveform(x, fs, n_fft, n_shift,
                                             mcep_dim, mcep_alpha)
