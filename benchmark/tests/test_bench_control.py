"""The control of the output check on the card: the reference in the
nearest precision below the configuration's (fp8 operands for bf16, TF32
for f32) put in the program's place, and training's half-batch fault,
each at a size a test run holds, come out not correct.

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_control.py
"""

import pytest
import torch

from benchmark import control

SMALL = {
    'ljspeech-synth-b32': {'batch': 16, 'batches': 4},
    'tedlium-spk-generate-b32': {'batch': 16, 'batches': 4},
    'tedlium-spk-nbest-b50': {'batch': 25, 'hypotheses': 50},
    'ljspeech-train-b128': {'batch': 32, 'batches': 4},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the control runs at the cell\'s '
                    'precision on the card (TF32 exists only there)')
    return 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('workload', sorted(SMALL))
def test_control_is_not_correct(card, workload):
    res = control.control_run(workload, 2 ** 31 + 5, 'control', card,
                              traffic_sizes=SMALL[workload])
    assert not res['correct'], res['compared']


@pytest.mark.cuda
def test_half_batch_is_not_correct(card):
    res = control.control_run('ljspeech-train-b128', 2 ** 31 + 5,
                              'half_batch', card,
                              traffic_sizes=SMALL['ljspeech-train-b128'])
    assert not res['correct'], res['compared']
