"""The harness with the program broken underneath, at a tiny size on the
CPU (the look for a card skipped): ``correct`` comes out false for each
fault a cell can have. One card runs every cell, so no exchange between
chips can be left out."""

import pytest
import torch

from benchmark.tests.test_bench_reference import tiny_run


def _altered(fn, field, row=0):
    """``fn`` whose result has ``field``'s row ``row`` moved by 1."""
    def broken(*args, **kwargs):
        res = fn(*args, **kwargs)
        value = getattr(res, field).clone()
        value[row] += 1.0
        return res._replace(**{field: value})
    return broken


def test_synthesis_answer_altered(monkeypatch):
    from gradtts_tpu_torch.models import tts
    monkeypatch.setattr(tts, 'synthesize',
                        _altered(tts.synthesize, 'decoder_outputs'))
    assert not tiny_run('ljspeech-synth-b32')['correct']


def test_waveform_altered(monkeypatch):
    from gradtts_tpu_torch.models import hifigan
    forward = hifigan.Generator.forward
    monkeypatch.setattr(hifigan.Generator, 'forward',
                        lambda self, mel: forward(self, mel) + 0.5)
    assert not tiny_run('tedlium-spk-generate-b32')['correct']


def test_likelihood_answer_altered(monkeypatch):
    from gradtts_tpu_torch.nbest import scoring
    monkeypatch.setattr(scoring, 'score_batch',
                        _altered(scoring.score_batch, 'z'))
    assert not tiny_run('tedlium-spk-nbest-b50')['correct']


def test_likelihood_tangent_dropped(monkeypatch):
    """The score U-Net's forward-mode tangent (K6, K7, K1's tangent) left
    out: delta_logp keeps only the drift's linear term."""
    from gradtts_tpu_torch.models.tts import GradTTS
    estimate = GradTTS.estimate
    monkeypatch.setattr(GradTTS, 'estimate',
                        lambda self, x_t, *args, **kwargs: estimate(
                            self, x_t.detach(), *args, **kwargs))
    result = tiny_run('tedlium-spk-nbest-b50')
    assert result['compared']['div_err']['value'] > 0.5, result['compared']
    assert not result['correct']


def test_training_step_leaves_state_unchanged(monkeypatch):
    from gradtts_tpu_torch.train import state

    step = state.train_step

    def frozen(model, optimizer, batch, *args, **kwargs):
        saved = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = step(model, optimizer, batch, *args, **kwargs)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved[n])
        optimizer.state.clear()
        return metrics
    monkeypatch.setattr(state, 'train_step', frozen)
    assert not tiny_run('ljspeech-train-b128')['correct']


def test_training_step_on_half_the_batch(monkeypatch):
    from gradtts_tpu_torch.train import state
    step = state.train_step

    def half(model, optimizer, batch, *args, **kwargs):
        rows = {k: v[:len(v) // 2] for k, v in batch.items()}
        return step(model, optimizer, rows, *args, **kwargs)
    monkeypatch.setattr(state, 'train_step', half)
    assert not tiny_run('ljspeech-train-b128')['correct']


@pytest.mark.parametrize('workload', ['ljspeech-synth-b32',
                                      'ljspeech-train-b128'])
def test_sound_runs_are_correct(workload):
    assert tiny_run(workload, seed=2 ** 31 + 7)['correct']
