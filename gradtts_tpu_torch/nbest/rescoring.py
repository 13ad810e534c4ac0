"""Linear n-best rescoring and WER evaluation.

Behavioral parity targets: the reference's n_best/analyse_scores.py
(:18-65 linear rescoring + calc_wer) and n_best_list_evaluate.py (:17-94
evaluate-one-weight-vector script). The reference sorts beams ASCENDING by
``dot(alpha, features)`` and takes the first (analyse_scores.py:33,
``sorted(best_list, key=linear)``); with all-zero weights the sort is
stable, so rank-0 (the first pass) wins — reproducing the 0.09889 baseline
in n_best/result.yaml.

Vectorized here: features come out as one [I, N, K] tensor and the argmin
is a numpy reduction instead of per-utterance Python sorts.

The port's own copy of gradtts_tpu/nbest/rescoring.py (numpy only; the JAX
package's ``nbest`` imports JAX on import).
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from gradtts_tpu_torch.nbest.lists import NBestList, SCORE_NAMES
from gradtts_tpu_torch.nbest.wer import wer


def weights_vector(weights: Dict[str, float],
                   names: Sequence[str] = SCORE_NAMES) -> np.ndarray:
    return np.array([float(weights.get(name, 0.0)) for name in names])


def select_hypotheses(n_best: NBestList, weights: Dict[str, float], N: int,
                      features: Optional[np.ndarray] = None) -> List[str]:
    """Pick, per utterance, the hypothesis minimizing the linear score.
    Stable tie-breaking by rank (matches Python's stable sort in the
    reference, hence the all-zero-weights first-pass baseline)."""
    if features is None:
        features = n_best.feature_matrix(N)
    alpha = weights_vector(weights)
    combined = features @ alpha                      # [I, N]
    # stable argmin: np.argmin returns the first minimal index
    best = np.argmin(combined, axis=1)
    return [n_best.hypothesis(i, int(n)) for i, n in enumerate(best)]


def rescoring_wer(n_best: NBestList, weights: Dict[str, float], N: int,
                  features: Optional[np.ndarray] = None,
                  n_samples: Optional[int] = None) -> float:
    """Corpus WER of the rescored 1-best (parity: calc_wer,
    analyse_scores.py:48-65)."""
    if n_samples is not None and n_samples < len(n_best):
        sub = NBestList(n_best.raw[:n_samples])
        if features is not None:
            features = features[:n_samples]
        n_best = sub
    hyps = select_hypotheses(n_best, weights, N, features)
    refs = [n_best.target(i) for i in range(len(n_best))]
    return wer(refs, hyps)


def evaluate(n_best: NBestList, diff_scores: np.ndarray,
             weights: Dict[str, float], N: int) -> dict:
    """Inject diffusion scores, rescore, return {**weights, 'wer': ...}
    (parity: n_best_list_evaluate.py:59-91, including zeroing beams past
    rank N)."""
    n_best.set_diffusion_scores(diff_scores[:, :N], N)
    result = dict(weights)
    result['wer'] = rescoring_wer(n_best, weights, N)
    return result
