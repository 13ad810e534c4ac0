"""``cli.playground``: one finite likelihood line per utterance, each the
mean of ``--repeats`` scores of ``NBestScorer.score_items`` under one
seeded generator, and its bits per dimension; the JAX package's scorer
gives the same score with the port's probe."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (CMUDICT, TINY_SET, jax_model_and_params,
                         write_corpus)
from gradtts_tpu.nbest.scoring import score_batch as jax_score_batch
from gradtts_tpu.utils.io import save_params_npz
from gradtts_tpu_torch.cli import playground
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.data.dataset import TextMelDataset
from gradtts_tpu_torch.models.tts import GradTTS
from gradtts_tpu_torch.nbest.scoring import NBestScorer, score_batch
from gradtts_tpu_torch.utils.convert import load_checkpoint

LINE = re.compile(r'^utt (\d+): score=(\S+) \(std (\S+) over (\d+) probes\), '
                  r'(\S+) bpd$')


@pytest.fixture
def setup(tmp_path, monkeypatch):
    """A 4-utterance filelist, a tiny .npz and the tiny preset (the JAX CLI,
    like this one, has no --set)."""
    tiny = {k: int(v) for k, v in (s.split('=') for s in TINY_SET)}

    def tiny_config(name):
        return get_config(name, **tiny, **{'data.cmudict_path': CMUDICT})

    monkeypatch.setattr(playground, 'get_config', tiny_config)
    jmodel, params = jax_model_and_params(seed=71)
    ckpt = str(tmp_path / 'params.npz')
    save_params_npz(ckpt, params)
    return write_corpus(tmp_path, 4), ckpt, jmodel, params, tiny_config


def test_playground_prints_a_finite_line_per_utterance(setup, capsys):
    filelist, ckpt, _, _, tiny_config = setup
    playground.main(['--checkpoint', ckpt, '--filelist', filelist,
                     '--n-utterances', '3', '--n-euler', '2', '--repeats',
                     '2', '--cpu'])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == 'Calculating likelihood'
    assert out[-1] == "That's a nice likelihood!"
    rows = [LINE.match(line) for line in out[1:-1]]
    assert len(rows) == 3 and all(rows)

    # the same scores in-process: one generator, probes drawn in turn
    cfg = tiny_config('ljspeech')
    model = GradTTS.from_config(cfg)
    model.load_state_dict(load_checkpoint(ckpt), strict=True)
    dataset = TextMelDataset(filelist, CMUDICT, shuffle=False)
    scorer = NBestScorer(model.eval(), n_euler=2, batch_size=1)
    generator = torch.Generator().manual_seed(0)
    for i, row in enumerate(rows):
        assert int(row.group(1)) == i and int(row.group(4)) == 2
        item = dataset[i]
        scores = [float(scorer.score_items([item], generator)[0])
                  for _ in range(2)]
        bpd = np.mean(scores) / (item['y'].shape[0] * 80) / np.log(2)
        assert np.isfinite(scores).all()
        assert row.group(2) == f'{np.mean(scores):.1f}'
        assert row.group(5) == f'{bpd:.3f}'


def test_playground_score_matches_jax_with_the_same_probe(setup):
    """The first utterance as the CLI scores it (NBestScorer's collate,
    2 Euler steps) against the JAX package's score_batch, with the probe
    its key draws (tests/test_torch_likelihood.py's bound)."""
    filelist, ckpt, jmodel, params, tiny_config = setup
    model = GradTTS.from_config(tiny_config('ljspeech'))
    model.load_state_dict(load_checkpoint(ckpt), strict=True)
    item = TextMelDataset(filelist, CMUDICT, shuffle=False)[0]
    batch = NBestScorer(model).collate([item])
    args = [batch[k] for k in ('x', 'x_lengths', 'y', 'y_lengths')]
    key = jax.random.PRNGKey(73)
    want = jax.jit(lambda p, *a: jax_score_batch(jmodel, p, key, *a,
                                                 n_euler=2))(
        params, *map(jnp.asarray, args))
    eps = np.array(jax.random.randint(key, batch['y'].shape, 0, 2)
                     .astype(jnp.float32) * 2.0 - 1.0)
    got = score_batch(model.eval(), *[torch.from_numpy(a) for a in args],
                      n_euler=2, epsilon=torch.from_numpy(eps))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-5)


def test_playground_n_euler_0_selects_dormand_prince(setup, monkeypatch,
                                                     capsys):
    """--n-euler 0 reaches the scorer as its n_euler, which selects the
    adaptive solver (tests/test_torch_likelihood.py holds that solver)."""
    filelist, ckpt, _, _, _ = setup
    built = []

    class Recording(NBestScorer):
        def __init__(self, model, **kw):
            built.append(kw)
            super().__init__(model, **kw)

        def score_items(self, items, generator=None):
            return np.zeros(len(items))

    monkeypatch.setattr(playground, 'NBestScorer', Recording)
    playground.main(['--checkpoint', ckpt, '--filelist', filelist,
                     '--n-utterances', '1', '--n-euler', '0', '--repeats',
                     '1', '--cpu'])
    assert built == [{'n_euler': 0, 'batch_size': 1}]
    assert 'utt 0: score=0.0' in capsys.readouterr().out
