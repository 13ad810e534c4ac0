"""Objective TTS metrics: MCD, log-F0 RMSE, GPE, VDE, FFE.

Behavioral parity target: upstream evaluate_tts.py:63-194 — same
formulas, same DTW-then-compare structure, same thresholds (20% gross
pitch error band, MCD constant 10*sqrt(2)/ln10, full-coefficient
difference including c0 as the reference computes it).

The port's own copy of gradtts_tpu/eval/metrics.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

from typing import Dict, Optional

import numpy as np

from gradtts_tpu_torch.eval.dtw import align, warping_indices
from gradtts_tpu_torch.eval.f0 import yin_f0
from gradtts_tpu_torch.eval.mcep import mcep_from_waveform

MCD_CONST = 10.0 / np.log(10.0)


# --- F0 metrics (parity: evaluate_tts.py:86-117) ---------------------------


def _true_voiced_frames(true_f, est_f):
    return (est_f != 0) & (true_f != 0)


def _gross_pitch_error_frames(true_f, est_f, eps=1e-8):
    voiced = _true_voiced_frames(true_f, est_f)
    pitch_error = np.abs(est_f / (true_f + eps) - 1) > 0.2
    return voiced & pitch_error


def _voicing_decision_error_frames(true_f, est_f):
    return (est_f != 0) != (true_f != 0)


def gross_pitch_error(true_f, est_f) -> float:
    """Fraction of both-voiced frames whose estimate is >20% off."""
    true_f, est_f = np.asarray(true_f), np.asarray(est_f)
    correct = _true_voiced_frames(true_f, est_f)
    gpe = _gross_pitch_error_frames(true_f, est_f)
    denom = np.sum(correct)
    return float(np.sum(gpe) / denom) if denom else 0.0


def voicing_decision_error(true_f, est_f) -> float:
    true_f, est_f = np.asarray(true_f), np.asarray(est_f)
    return float(np.sum(_voicing_decision_error_frames(true_f, est_f))
                 / len(true_f))


def f0_frame_error(true_f, est_f) -> float:
    true_f, est_f = np.asarray(true_f), np.asarray(est_f)
    gpe = _gross_pitch_error_frames(true_f, est_f)
    vde = _voicing_decision_error_frames(true_f, est_f)
    return float((np.sum(gpe) + np.sum(vde)) / len(true_f))


def log_f0_rmse(true_f, est_f) -> float:
    """RMSE of log-F0 over frames voiced in both tracks
    (parity: evaluate_tts.py:170-175)."""
    true_f, est_f = np.asarray(true_f), np.asarray(est_f)
    idx = np.where((est_f != 0) & (true_f != 0))[0]
    if idx.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(
        (np.log(est_f[idx]) - np.log(true_f[idx])) ** 2)))


# --- MCD (parity: evaluate_tts.py:176-186) ---------------------------------


def mcd(gen_mcep: np.ndarray, gt_mcep: np.ndarray,
        use_dtw: bool = True) -> float:
    """Mean over (DTW-aligned) frames of 10/ln10 * sqrt(2 * ||dc||^2)."""
    if use_dtw:
        gen_mcep, gt_mcep = align(gen_mcep, gt_mcep)
    diff2sum = np.sum((gen_mcep - gt_mcep) ** 2, axis=1)
    return float(np.mean(MCD_CONST * np.sqrt(2.0 * diff2sum)))


def mel_dtw_distance(ref_mel: np.ndarray, pred_mel: np.ndarray) -> float:
    """MCD-style distance straight on mel frames
    (parity: fastdtw_distance_on_mels, evaluate_tts.py:63-74)."""
    h, r = align(np.asarray(ref_mel), np.asarray(pred_mel))
    d2 = np.sum((h - r) ** 2, axis=1)
    return float(np.mean(MCD_CONST * np.sqrt(2.0 * d2)))


# --- combined per-utterance evaluation ------------------------------------


def evaluate_pair(pred_x: np.ndarray, ref_x: np.ndarray, fs: int,
                  f0min: float = 70.0, f0max: float = 400.0,
                  n_fft: int = 512, n_shift: int = 256,
                  mcep_dim: int = 34, mcep_alpha: float = 0.45,
                  backend: str = 'auto') -> Dict[str, float]:
    """All metrics for one (synthesized, reference) waveform pair
    (parity: obtainMetrics, evaluate_tts.py:159-194): F0 tracks are
    DTW-aligned via the mcep tracks, log-F0 RMSE on both-voiced frames,
    MCD on a separate mcep DTW, GPE/VDE/FFE on the aligned F0.

    ``backend`` selects the feature extractors:
      - 'yin': built-in dependency-free DSP (YIN F0 + warped cepstrum).
        Self-consistent, but absolute values are NOT comparable to numbers
        from the reference toolchain (see eval/f0.py, eval/mcep.py).
      - 'world': WORLD harvest F0 + CheapTrick + SPTK mcep — the
        reference's extractors, producing reference-comparable MCD/F0
        numbers.  Uses pyworld/pysptk when installed (bit-identical to
        the reference toolchain); otherwise the from-scratch numpy
        implementations of the same algorithms (eval/worldnp.py), which
        are slower but always available.
      - 'auto' (default): 'world' when pyworld/pysptk are importable,
        else 'yin' (the fast built-in DSP).  Pass backend='world'
        explicitly for reference-algorithm numbers without the libs.
    """
    pred_x = np.asarray(pred_x, np.float64)
    ref_x = np.asarray(ref_x, np.float64)

    if backend == 'auto':
        from gradtts_tpu_torch.eval.world import world_available
        backend = 'world' if world_available() else 'yin'
    if backend == 'world':
        from gradtts_tpu_torch.eval.world import sptk_mcep, world_extract
        # reference structure: F0 (and its DTW alignment cepstra) from
        # WORLD, the MCD cepstra from pysptk.mcep on the raw waveform
        pred_mcep_f0, pred_f0 = world_extract(
            pred_x, fs, f0min, f0max, n_fft, n_shift, mcep_dim, mcep_alpha)
        ref_mcep_f0, ref_f0 = world_extract(
            ref_x, fs, f0min, f0max, n_fft, n_shift, mcep_dim, mcep_alpha)
        pred_mcep = sptk_mcep(pred_x, fs, n_fft, n_shift, mcep_dim,
                              mcep_alpha)
        ref_mcep = sptk_mcep(ref_x, fs, n_fft, n_shift, mcep_dim,
                             mcep_alpha)
        ti, tj = warping_indices(pred_mcep_f0, ref_mcep_f0)
        ti = np.clip(ti, 0, len(pred_f0) - 1) if len(pred_f0) else ti
        tj = np.clip(tj, 0, len(ref_f0) - 1) if len(ref_f0) else tj
        pred_f0_dtw = pred_f0[ti]
        ref_f0_dtw = ref_f0[tj]
        return {
            'log_f0_rmse': log_f0_rmse(ref_f0_dtw, pred_f0_dtw),
            'mcd': mcd(pred_mcep, ref_mcep, use_dtw=True),
            'gpe': gross_pitch_error(ref_f0_dtw, pred_f0_dtw),
            'vde': voicing_decision_error(ref_f0_dtw, pred_f0_dtw),
            'ffe': f0_frame_error(ref_f0_dtw, pred_f0_dtw),
        }
    if backend != 'yin':
        raise ValueError(f'unknown eval DSP backend {backend!r}')

    pred_mcep = mcep_from_waveform(pred_x, fs, n_fft, n_shift, mcep_dim,
                                   mcep_alpha)
    ref_mcep = mcep_from_waveform(ref_x, fs, n_fft, n_shift, mcep_dim,
                                  mcep_alpha)
    pred_f0 = yin_f0(pred_x, fs, f0min, f0max, frame_length=n_fft,
                     hop=n_shift)
    ref_f0 = yin_f0(ref_x, fs, f0min, f0max, frame_length=n_fft,
                    hop=n_shift)

    ti, tj = warping_indices(pred_mcep, ref_mcep)
    # f0 frames align 1:1 with mcep frames (same framing)
    ti = np.clip(ti, 0, len(pred_f0) - 1) if len(pred_f0) else ti
    tj = np.clip(tj, 0, len(ref_f0) - 1) if len(ref_f0) else tj
    pred_f0_dtw = pred_f0[ti]
    ref_f0_dtw = ref_f0[tj]

    return {
        'log_f0_rmse': log_f0_rmse(ref_f0_dtw, pred_f0_dtw),
        'mcd': mcd(pred_mcep, ref_mcep, use_dtw=True),
        'gpe': gross_pitch_error(ref_f0_dtw, pred_f0_dtw),
        'vde': voicing_decision_error(ref_f0_dtw, pred_f0_dtw),
        'ffe': f0_frame_error(ref_f0_dtw, pred_f0_dtw),
    }
