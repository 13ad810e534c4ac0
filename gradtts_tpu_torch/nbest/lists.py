"""n-best list container and feature extraction.

Behavioral parity targets: the reference's n_best/ — the pickle layout read
by all entry scripts is ``n_best_list[i]['beams'][0][n]['text']`` plus per-beam
score features, and ``n_best_list[i]['targets'][0]`` as the reference
transcription (n_best_list_experiment.py:66-74, analyse_scores.py:18-48,
n_best_list_evaluate.py:17-36).

Feature names follow the reference's rescoring config
(n_best/config/rescoring.yaml): first_pass_score, am_score, bpe_lm_score,
first_pass_length_penalty, ngram_lm_score_non_oov, ngram_lm_score_oov,
ngram_lm_score, second_pass_score, diffusion_score.

The port's own copy of gradtts_tpu/nbest/lists.py (numpy only; the JAX
package's ``nbest`` imports JAX on import).
"""

import pickle
from typing import Dict, List, Sequence

import numpy as np

#: score features used for linear rescoring, in the reference's weight order
SCORE_NAMES = (
    'first_pass_score', 'am_score', 'bpe_lm_score',
    'first_pass_length_penalty', 'ngram_lm_score_non_oov',
    'ngram_lm_score_oov', 'ngram_lm_score', 'second_pass_score',
    'diffusion_score',
)


def load_n_best(path: str) -> List[dict]:
    with open(path, 'rb') as f:
        return pickle.load(f)


def save_n_best(n_best_list: List[dict], path: str) -> None:
    with open(path, 'wb') as f:
        pickle.dump(n_best_list, f)


class NBestList:
    """Read/write view over the reference pickle layout.

    ``beams[0]`` may be a list of beam dicts or a dict keyed by rank; both
    appear in the wild and both index correctly with ``[n]`` in the
    reference scripts — we normalize to a list once at load.
    """

    def __init__(self, raw: List[dict]):
        self.raw = raw

    @classmethod
    def from_pickle(cls, path: str) -> 'NBestList':
        return cls(load_n_best(path))

    def __len__(self):
        return len(self.raw)

    def _beams(self, i: int) -> List[dict]:
        beams = self.raw[i]['beams'][0]
        if isinstance(beams, dict):
            return [beams[k] for k in sorted(beams)]
        return list(beams)

    def hypothesis(self, i: int, n: int) -> str:
        """Hypothesis text; empty hypotheses become a single space so the
        text frontend still emits a token (parity:
        get_score_parallel.py:103-107)."""
        text = self._beams(i)[n]['text']
        if len(text.strip(' ')) == 0:
            text += ' '
        return text

    def hypotheses(self, i: int, N: int) -> List[str]:
        return [self.hypothesis(i, n) for n in range(N)]

    def target(self, i: int) -> str:
        return self.raw[i]['targets'][0]

    def beam(self, i: int, n: int) -> dict:
        return self._beams(i)[n]

    def n_beams(self, i: int) -> int:
        return len(self._beams(i))

    def feature_matrix(self, N: int,
                       names: Sequence[str] = SCORE_NAMES) -> np.ndarray:
        """[I, N, K] feature tensor (missing features are 0)."""
        out = np.zeros((len(self), N, len(names)), np.float64)
        for i in range(len(self)):
            beams = self._beams(i)
            for n in range(min(N, len(beams))):
                for k, name in enumerate(names):
                    out[i, n, k] = float(beams[n].get(name, 0.0))
        return out

    def set_diffusion_scores(self, scores: np.ndarray, N: int,
                             fill_beyond: float = 0.0) -> None:
        """Write a [I, N] diffusion-score matrix into the beams; beams past
        rank N get ``fill_beyond`` (parity: n_best_list_evaluate.py:70-76,
        which zeros ranks N..1000)."""
        scores = np.asarray(scores).reshape((len(self), N))
        for i in range(len(self)):
            beams = self._beams(i)
            for n, beam in enumerate(beams):
                beam['diffusion_score'] = (
                    float(scores[i, n]) if n < N else fill_beyond)


def make_synthetic_n_best(texts_and_targets: List[Dict], seed: int = 0
                          ) -> List[dict]:
    """Build a pickle-layout list for tests: each entry is
    {'target': str, 'hyps': [str, ...]}; features are random."""
    rng = np.random.default_rng(seed)
    out = []
    for entry in texts_and_targets:
        beams = []
        for hyp in entry['hyps']:
            beam = {'text': hyp}
            for name in SCORE_NAMES[:-1]:
                beam[name] = float(rng.standard_normal())
            beams.append(beam)
        out.append({'targets': [entry['target']], 'beams': [beams]})
    return out
