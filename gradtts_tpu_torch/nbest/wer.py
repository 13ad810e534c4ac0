"""Word error rate via Levenshtein alignment (jiwer replacement).

Behavioral parity target: ``jiwer.wer(references, hypotheses)`` as used by
the reference's n_best/analyse_scores.py:4,65 and
n_best_list_evaluate.py:4,56 — corpus-level WER: total (substitutions +
deletions + insertions) over total reference words, with whitespace
tokenization.

The port's own copy of gradtts_tpu/nbest/wer.py (numpy only; the JAX
package's ``nbest`` imports JAX on import).
"""

from typing import List, Sequence, Tuple, Union

import numpy as np


def edit_counts(ref: Sequence[str], hyp: Sequence[str]) -> Tuple[int, int, int, int]:
    """(substitutions, deletions, insertions, hits) of the minimum-cost
    alignment of hyp to ref (unit costs)."""
    R, H = len(ref), len(hyp)
    # dp[i][j] = (cost, S, D, I, hits) for ref[:i] vs hyp[:j]
    INF = 1 << 30
    prev = [(j, 0, 0, j, 0) for j in range(H + 1)]
    for i in range(1, R + 1):
        cur = [(i, 0, i, 0, 0)] + [(INF, 0, 0, 0, 0)] * H
        ri = ref[i - 1]
        for j in range(1, H + 1):
            match = ri == hyp[j - 1]
            # diagonal: hit or substitution
            c, s, d, ins, h = prev[j - 1]
            diag = (c + (0 if match else 1), s + (0 if match else 1), d, ins,
                    h + (1 if match else 0))
            # up: deletion from ref
            c, s, d, ins, h = prev[j]
            up = (c + 1, s, d + 1, ins, h)
            # left: insertion
            c, s, d, ins, h = cur[j - 1]
            left = (c + 1, s, d, ins + 1, h)
            cur[j] = min(diag, up, left)
        prev = cur
    _, s, d, ins, h = prev[H]
    return s, d, ins, h


def _tokenize(text: str) -> List[str]:
    return text.split()


def wer(references: Union[str, List[str]],
        hypotheses: Union[str, List[str]]) -> float:
    """Corpus-level WER (jiwer semantics): sum of edit operations over the
    sum of reference word counts across all sentence pairs."""
    if isinstance(references, str):
        references = [references]
    if isinstance(hypotheses, str):
        hypotheses = [hypotheses]
    assert len(references) == len(hypotheses)
    total_err = 0
    total_ref = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = _tokenize(ref), _tokenize(hyp)
        s, d, ins, _ = edit_counts(r, h)
        total_err += s + d + ins
        total_ref += len(r)
    if total_ref == 0:
        return 0.0 if total_err == 0 else float('inf')
    return total_err / total_ref


def wer_details(references: List[str], hypotheses: List[str]) -> dict:
    """Aggregate S/D/I/hits plus WER (like jiwer.process_words summary)."""
    S = D = I = Hits = Nref = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = _tokenize(ref), _tokenize(hyp)
        s, d, ins, hits = edit_counts(r, h)
        S += s
        D += d
        I += ins
        Hits += hits
        Nref += len(r)
    return {'substitutions': S, 'deletions': D, 'insertions': I,
            'hits': Hits, 'ref_words': Nref,
            'wer': (S + D + I) / Nref if Nref else 0.0}
