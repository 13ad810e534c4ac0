"""Diffusion-likelihood scoring of n-best hypotheses.

Counterpart of gradtts_tpu/nbest/scoring.py (``score_batch`` :41,
``NBestScorer`` :59, ``score_n_best`` :127, ``compile_scores`` :189), which
follows the reference's n_best/n_best_list_experiment.py (:66-171) and
get_score_parallel.py (:68-157):

- a batch of (hypothesis text, real mel) pairs is scored at once: encoder,
  MAS, and the SpeechSDE probability-flow likelihood, whose Hutchinson
  divergence runs the U-Net in forward mode (the attention through K6 and
  K7 on the GPU);
- shapes are bucketed as the trainer buckets them, so the U-Net meets a
  handful of shapes;
- jobs are idempotent and resumable by (i, n): each scored pair is one
  JSON file ``{i, n, N, name, diffusion_score}``, written to a temporary
  name and renamed; a rerun skips the keys that exist;
- ``shard=(k, K)`` scores the utterances i with i % K == k.

The Hutchinson probes come from a ``torch.Generator`` seeded from ``seed``,
split once per batch: the scores are reproducible for one seed, but not
the JAX package's numbers, whose probes come from ``jax.random``.
"""

import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gradtts_tpu_torch.config import bucket_length, fix_len_compatibility
from gradtts_tpu_torch.data.dataset import BatchCollate
from gradtts_tpu_torch.likelihood.ode import (LikelihoodResult,
                                              get_likelihood_fn)
from gradtts_tpu_torch.likelihood.sde import SpeechSDE
from gradtts_tpu_torch.models.tts import GradTTS, get_score_fn
from gradtts_tpu_torch.nbest.lists import NBestList
from gradtts_tpu_torch.utils.profiling import span


@torch.no_grad()
def score_batch(model: GradTTS, x, x_lengths, y, y_lengths,
                n_euler: int = 10, rtol=1e-3, atol=1e-3, generator=None,
                epsilon=None, max_steps: int = 10_000,
                spk=None, mesh=None) -> LikelihoodResult:
    """Log-likelihood score of the real mels y [B, Ty, F] under the
    text-conditional score model, for token ids x [B, Tx] and speakers
    ``spk`` (ids [B] or vectors [B, D], where the model has speakers)
    (``score_batch`` :41). The probe is ``epsilon`` [B, Ty, F], or drawn
    from ``generator``.
    On a ('data', 'model') ``mesh`` (``parallel.mesh.make_mesh``), as the
    JAX package scores under its mesh: x, x_lengths, y, y_lengths, spk and
    ``epsilon`` are this rank's rows (``parallel.mesh.shard_batch``), the
    model may be split over 'model' (``parallel.mesh.shard_model``), and
    ``generator`` is then a ``models.layers.RowShard``, so the probe is
    this rank's rows of the global batch's; the adaptive integrator's
    steps are the global batch's. Every rank of the mesh must call it.
    ``.score`` holds the [B] scores, -(prior_logp + delta_logp); callers of
    the adaptive integrator (``n_euler=0``) check ``.converged``. The
    forward-mode derivatives need no autograd graph, so none is built."""
    with span('gradtts.score'):
        score_fn, mu_y, y_mask = get_score_fn(model, x, x_lengths, y,
                                              y_lengths, spk)
        dec = model.decoder
        sde = SpeechSDE(beta_min=dec.beta_min, beta_max=dec.beta_max,
                        N=int(dec.estimator.pe_scale), mu=mu_y, mask=y_mask)
        likelihood_fn = get_likelihood_fn(
            sde, score_fn, rtol=rtol, atol=atol, euler=n_euler,
            max_steps=max_steps,
            group=None if mesh is None else mesh.get_group('data'))
        return likelihood_fn(y, generator=generator, epsilon=epsilon)


class NBestScorer:
    """Bucket-batched scorer on the device of ``model``."""

    def __init__(self, model: GradTTS, n_euler: int = 10,
                 x_buckets: Sequence[int] = (64, 128, 192, 256, 384, 512),
                 y_buckets: Sequence[int] = (128, 256, 384, 512, 768, 1024,
                                             1536, 2048),
                 batch_size: int = 8, rtol=1e-3, atol=1e-3,
                 max_steps: int = 10_000):
        self.model = model
        self.n_euler = n_euler
        self.batch_size = batch_size
        self.collate = BatchCollate(x_buckets=x_buckets, y_buckets=y_buckets)
        self.rtol, self.atol, self.max_steps = rtol, atol, max_steps

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def score_items(self, items: List[dict], generator=None) -> np.ndarray:
        """items: [{'x': ids, 'y': mel [T, F] (, 'spk')}, ...] -> [B] f64
        scores.

        Raises RuntimeError when the adaptive integrator (n_euler=0) did not
        converge within its step budget: unconverged likelihoods are never
        written as scores (the reference's scipy solver raises on failure,
        n_best/likelihood/likelihood.py:117)."""
        batch = self.collate(items)
        args = [torch.from_numpy(batch[k]).to(self.device)
                for k in ('x', 'x_lengths', 'y', 'y_lengths')]
        spk = batch.get('spk')
        if spk is not None:
            spk = torch.from_numpy(spk).to(self.device)
        res = score_batch(self.model, *args, n_euler=self.n_euler,
                          rtol=self.rtol, atol=self.atol, generator=generator,
                          max_steps=self.max_steps, spk=spk)
        if not res.converged:
            raise RuntimeError(
                'likelihood ODE integration did not converge within '
                'max_steps; scores would be silently wrong: raise rtol/'
                'atol, use a fixed n_euler, or raise max_steps')
        return res.score.double().cpu().numpy()


def _result_path(out_dir: str, i: int, n: int) -> str:
    return os.path.join(out_dir, f'{i}_{n}.json')


def _iter_pairs(n_utts: int, N: int, shard: Optional[Tuple[int, int]]
                ) -> Iterable[Tuple[int, int]]:
    for i in range(n_utts):
        if shard is not None and i % shard[1] != shard[0]:
            continue
        for n in range(N):
            yield i, n


def score_n_best(scorer: NBestScorer, dataset, n_best: NBestList, N: int,
                 out_dir: str, name: str = 'scores', seed: int = 1,
                 shard: Optional[Tuple[int, int]] = None,
                 resume: bool = True,
                 progress: Optional[Callable[[int, int], None]] = None
                 ) -> int:
    """Scores every (utterance i, hypothesis n) pair and writes one JSON
    file per pair under ``out_dir``. Returns the number of pairs scored in
    this call (skipped pairs not counted); ``progress(done, total)`` is
    called after each batch.

    ``dataset`` gives ``get_text(str)`` and ``__getitem__ -> {'y'(,
    'spk')}`` like TextMelDataset: the real mel and the speaker come from
    the dataset, the text from the hypothesis (NBestDataset,
    n_best_list_experiment.py:91-116)."""
    os.makedirs(out_dir, exist_ok=True)
    pairs = [(i, n) for i, n in _iter_pairs(len(n_best), N, shard)
             if not (resume and os.path.exists(_result_path(out_dir, i, n)))]
    mel_cache: Dict[int, dict] = {}

    def item_for(i, n):
        if i not in mel_cache:
            mel_cache[i] = dataset[i]
            if len(mel_cache) > 4 * scorer.batch_size:   # bound host memory
                mel_cache.pop(next(iter(mel_cache)))
        item = {'x': dataset.get_text(n_best.hypothesis(i, n)),
                'y': mel_cache[i]['y']}
        if 'spk' in mel_cache[i]:
            item['spk'] = mel_cache[i]['spk']
        return item

    def bucket_key(item):
        return (bucket_length(item['x'].shape[-1], scorer.collate.x_buckets),
                bucket_length(fix_len_compatibility(item['y'].shape[0]),
                              scorer.collate.y_buckets))

    # each batch meets one bucket shape
    loaded = sorted(((i, n, item_for(i, n)) for i, n in pairs),
                    key=lambda p: bucket_key(p[2]))
    master = torch.Generator().manual_seed(seed)
    n_scored = 0
    for start in range(0, len(loaded), scorer.batch_size):
        chunk = loaded[start:start + scorer.batch_size]
        sub_seed = int(torch.randint(0, 2 ** 62, (1,), generator=master))
        sub = torch.Generator(device=scorer.device).manual_seed(sub_seed)
        scores = scorer.score_items([c[2] for c in chunk], sub)
        for (i, n, _), s in zip(chunk, scores):
            payload = {'i': i, 'n': n, 'N': N, 'name': name,
                       'diffusion_score': float(s)}
            tmp = _result_path(out_dir, i, n) + '.tmp'
            with open(tmp, 'w') as f:
                json.dump(payload, f)
            os.replace(tmp, _result_path(out_dir, i, n))
            n_scored += 1
        if progress is not None:
            progress(n_scored, len(loaded))
    return n_scored


def compile_scores(directory: str, I: int, N: int,
                   out_path: Optional[str] = None) -> np.ndarray:
    """A score directory -> [I, N] f64 matrix (the reference's
    compile_scores.py:8-43, which reads hydra YAML shards; here the JSON
    shards of :func:`score_n_best`, plus any .yaml shards with the same
    keys). Missing pairs stay 0, as there."""
    scores = np.zeros((I, N))
    for root, _dirs, files in os.walk(directory):
        if '.hydra' in root:
            continue
        for filename in files:
            path = os.path.join(root, filename)
            if filename.endswith('.json'):
                with open(path) as f:
                    data = json.load(f)
            elif filename.endswith(('.yaml', '.yml')):
                import yaml
                with open(path) as f:
                    data = yaml.safe_load(f)
            else:
                continue
            if not isinstance(data, dict) or 'diffusion_score' not in data:
                continue
            scores[data['i'], data['n']] = data['diffusion_score']
    if out_path:
        os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
        np.save(out_path, scores)
    return scores
