"""Objective TTS evaluation: MCD / log-F0 RMSE / GPE / VDE / FFE.

numpy/scipy rebuild of upstream evaluate_tts.py and
upstream eval/evaluate_mcd.py.  Two DSP paths:

- fast built-in: YIN F0 tracking, warped-cepstrum mcep, exact
  vectorized DTW (eval/f0.py, eval/mcep.py, eval/dtw.py);
- reference-algorithm (``evaluate_pair(backend='world')``): WORLD
  Harvest F0 + CheapTrick envelope + SPTK mel-cepstral analysis, via
  pyworld/pysptk when installed or the from-scratch numpy
  implementations in eval/worldnp.py otherwise (eval/world.py picks).

The port's own copy of gradtts_tpu/eval/__init__.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

from gradtts_tpu_torch.eval.dsp import (  # noqa: F401
    best_mcep_params, find_files, frame_signal, resample,
)
from gradtts_tpu_torch.eval.dtw import (  # noqa: F401
    align, dtw_path, warping_indices,
)
from gradtts_tpu_torch.eval.f0 import yin_f0  # noqa: F401
from gradtts_tpu_torch.eval.mcep import (  # noqa: F401
    log_spectrum_to_mcep, mcep_from_waveform, warp_frequency,
)
from gradtts_tpu_torch.eval.metrics import (  # noqa: F401
    MCD_CONST, evaluate_pair, f0_frame_error, gross_pitch_error,
    log_f0_rmse, mcd, mel_dtw_distance, voicing_decision_error,
)
from gradtts_tpu_torch.eval.mcd_tool import (  # noqa: F401
    evaluate_mcd_dirs, mcd_for_pair,
)
from gradtts_tpu_torch.eval.world import (  # noqa: F401
    sptk_mcep, world_available, world_extract,
)
