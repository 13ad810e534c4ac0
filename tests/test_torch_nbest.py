"""The port's n-best subsystem: its numpy copies give the JAX package's
results (WER, rescoring WER, the TPE search), ``score_n_best`` writes,
resumes and shards as tests/test_nbest.py requires, an unconverged adaptive
run raises, and ``cli.nbest`` scores, compiles and rescores on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import gradtts_tpu.nbest as jnb
import gradtts_tpu_torch.nbest as tnb
from _torch_port import TINY_SET, jax_model_and_params, write_corpus
from gradtts_tpu.utils.io import save_params_npz
from gradtts_tpu_torch.cli.nbest import main as nbest_main
from gradtts_tpu_torch.models.tts import GradTTS


def _random_entries(seed, n_utts=12, n_hyps=4):
    rng = np.random.default_rng(seed)
    vocab = ['a', 'b', 'c', 'd', 'e']

    def sentence():
        return ' '.join(vocab[i] for i in rng.integers(0, 5,
                                                       rng.integers(1, 7)))
    return [{'target': sentence(), 'hyps': [sentence()
                                            for _ in range(n_hyps)]}
            for _ in range(n_utts)]


def test_wer_and_rescoring_equal_jax():
    entries = _random_entries(0)
    refs = [e['target'] for e in entries]
    hyps = [e['hyps'][1] for e in entries]
    assert tnb.wer(refs, hyps) == jnb.wer(refs, hyps)
    assert tnb.wer_details(refs, hyps) == jnb.wer_details(refs, hyps)
    raw_t = tnb.make_synthetic_n_best(entries, seed=3)
    raw_j = jnb.make_synthetic_n_best(entries, seed=3)
    assert raw_t == raw_j
    lists = (tnb.NBestList(raw_t), jnb.NBestList(raw_j))
    rng = np.random.default_rng(1)
    for _ in range(5):
        weights = dict(zip(tnb.SCORE_NAMES, rng.standard_normal(9)))
        got, want = (mod.rescoring_wer(nb, weights, 4)
                     for mod, nb in zip((tnb, jnb), lists))
        assert got == want


def test_tpe_equals_jax():
    entries = _random_entries(2)
    lists = [mod.NBestList(mod.make_synthetic_n_best(entries, seed=4))
             for mod in (tnb, jnb)]
    results = []
    for mod, nb in zip((tnb, jnb), lists):
        feats = nb.feature_matrix(4)
        res = mod.tpe_minimize(
            lambda w: mod.rescoring_wer(nb, w, 4, features=feats),
            mod.DEFAULT_SPACE, n_trials=30, seed=7)
        results.append((res.best_value, res.best_params))
    assert results[0] == results[1]


class _TinyDataset:
    """score_n_best's dataset protocol: real mels and a text tokenizer."""

    def __init__(self, n_utts, T=16, F=8, seed=0):
        rng = np.random.default_rng(seed)
        self.mels = [rng.standard_normal((T, F)).astype(np.float32)
                     for _ in range(n_utts)]

    def get_text(self, text):
        ids = [1 + (ord(c) % 40) for c in text.strip() or ' ']
        return np.asarray(ids[:12], np.int32)

    def __getitem__(self, i):
        return {'y': self.mels[i]}

    def __len__(self):
        return len(self.mels)


@pytest.fixture(scope='module')
def tiny_scored(tmp_path_factory):
    torch.manual_seed(0)
    model = GradTTS(n_vocab=50, n_enc_channels=16, filter_channels=32,
                    filter_channels_dp=16, n_heads=2, n_enc_layers=1,
                    n_feats=8, dec_dim=8).eval()
    for m in model.modules():                # non-zero gains: attention runs
        if hasattr(m, 'g'):
            m.g.data.fill_(0.5)
    ds = _TinyDataset(2)
    entries = [{'target': 'ab cd', 'hyps': ['ab cd', 'ab ce']},
               {'target': 'ef gh', 'hyps': ['ef gh', 'xf gh']}]
    n_best = tnb.NBestList(tnb.make_synthetic_n_best(entries))
    out_dir = str(tmp_path_factory.mktemp('scores'))
    scorer = tnb.NBestScorer(model, n_euler=2, batch_size=4,
                             x_buckets=(16,), y_buckets=(16,))
    seen = []
    n = tnb.score_n_best(scorer, ds, n_best, N=2, out_dir=out_dir, seed=1,
                         progress=lambda done, total: seen.append(
                             (done, total)))
    return scorer, ds, n_best, out_dir, n, seen


def test_score_n_best_writes_all_pairs(tiny_scored):
    _scorer, _ds, _n_best, out_dir, n, seen = tiny_scored
    assert n == 4 and seen == [(4, 4)]
    files = sorted(os.listdir(out_dir))
    assert files == ['0_0.json', '0_1.json', '1_0.json', '1_1.json']
    with open(os.path.join(out_dir, '0_1.json')) as f:
        payload = json.load(f)
    assert set(payload) == {'i', 'n', 'N', 'name', 'diffusion_score'}
    assert (payload['i'], payload['n'], payload['N']) == (0, 1, 2)
    assert np.isfinite(payload['diffusion_score'])


def test_score_n_best_resume_skips_existing(tiny_scored):
    scorer, ds, n_best, out_dir, _n, _seen = tiny_scored
    assert tnb.score_n_best(scorer, ds, n_best, N=2, out_dir=out_dir,
                            seed=1) == 0


def test_scores_differ_across_hypotheses_and_compile(tiny_scored):
    _scorer, _ds, _n_best, out_dir, _n, _seen = tiny_scored
    mat = tnb.compile_scores(out_dir, I=2, N=2)
    assert mat.shape == (2, 2) and mat.dtype == np.float64
    assert np.all(np.isfinite(mat)) and np.all(mat != 0)
    # another hypothesis text for the same audio: another mu, another score
    assert mat[0, 0] != mat[0, 1]


def test_scores_are_reproducible_for_a_seed(tiny_scored, tmp_path):
    scorer, ds, n_best, out_dir, _n, _seen = tiny_scored
    tnb.score_n_best(scorer, ds, n_best, N=2, out_dir=str(tmp_path), seed=1)
    np.testing.assert_array_equal(tnb.compile_scores(str(tmp_path), 2, 2),
                                  tnb.compile_scores(out_dir, 2, 2))


def test_score_n_best_sharding(tiny_scored, tmp_path):
    scorer, ds, n_best, _out, _n, _seen = tiny_scored
    d0, d1 = str(tmp_path / 's0'), str(tmp_path / 's1')
    assert tnb.score_n_best(scorer, ds, n_best, N=2, out_dir=d0,
                            shard=(0, 2)) == 2
    assert tnb.score_n_best(scorer, ds, n_best, N=2, out_dir=d1,
                            shard=(1, 2)) == 2
    m0, m1 = tnb.compile_scores(d0, 2, 2), tnb.compile_scores(d1, 2, 2)
    assert np.all(m0[1] == 0) and np.all(m1[0] == 0)
    assert np.all(m0 + m1 != 0)


def test_unconverged_adaptive_scoring_raises(tiny_scored):
    scorer, ds, _n_best, _out, _n, _seen = tiny_scored
    strict = tnb.NBestScorer(scorer.model, n_euler=0, batch_size=4,
                             x_buckets=(16,), y_buckets=(16,), rtol=1e-10,
                             atol=1e-10, max_steps=14)
    items = [{'x': ds.get_text('ab cd'), 'y': ds[0]['y']}]
    with pytest.raises(RuntimeError, match='did not converge'):
        strict.score_items(items, torch.Generator().manual_seed(0))


def test_cli_scores_compiles_and_rescores_on_cpu(tmp_path, capsys):
    _, params = jax_model_and_params(seed=9)
    ckpt = tmp_path / 'tiny.npz'
    save_params_npz(str(ckpt), params)
    filelist = write_corpus(tmp_path, n_items=2)
    entries = [{'target': 'hello world, number 0.',
                'hyps': ['hello world, number 0.', 'yellow word, number']},
               {'target': 'hello world, number 1.',
                'hyps': ['hello world, number 1.', 'hollow world']}]
    pkl = str(tmp_path / 'nbest.pkl')
    tnb.save_n_best(tnb.make_synthetic_n_best(entries, seed=5), pkl)
    out_dir = str(tmp_path / 'scores')
    nbest_main(['score', '--n-best', pkl, '--checkpoint', str(ckpt),
                '--filelist', filelist, '--out-dir', out_dir, '--cpu',
                '--preset', 'ljspeech', '-N', '2', '--n-euler', '2',
                '--set', *TINY_SET, 'data.x_buckets=(64,)',
                'data.y_buckets=(64,)'])
    out = capsys.readouterr().out
    assert 'scored 4/4 pairs' in out and 'scored 4 (utterance' in out
    npy = str(tmp_path / 'scores.npy')
    nbest_main(['compile', '--directory', out_dir, '-I', '2', '-N', '2',
                '--out', npy])
    mat = np.load(npy)
    assert mat.shape == (2, 2) and np.all(np.isfinite(mat))
    assert np.all(mat != 0) and mat[0, 0] != mat[0, 1]
    capsys.readouterr()
    nbest_main(['rescore', '--n-best', pkl, '--diff-scores', npy, '-n', '2',
                '--weight', 'diffusion_score=-0.001'])
    result = json.loads(capsys.readouterr().out)
    assert result['diffusion_score'] == -0.001
    assert result['diff_config'] == 'scores'
    assert 0.0 <= result['wer'] <= 1.0

