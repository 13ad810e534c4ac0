"""The trained-weights gates with the port's own code, JAX-free: the
train -> synthesize -> vocode -> evaluate gate of
tests/test_e2e_quality_gate.py (800 steps on its sine-chunk corpus; the
trained model beats the untrained one on prior loss, mel MAE, MCD, FFE
and worldnp MCD by that test's margins) and
tests/test_dpm_sampler.py::test_dpm_fidelity_on_trained_weights (1500
steps on its codebook corpus; DPM-8 and DPM-10 against Euler-10 on a
400-step Euler truth). The corpora, models and margins are the JAX
tests'; the training draws come from a seeded torch.Generator, so the
trajectories are the port's own (chip_smoke.py ``quality_gate``,
``dpm_fidelity``). Each runs on the CPU (marked slow, as the JAX tests
are) and on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_quality_gate.py
"""

import json

import pytest
import torch

from chip_smoke import dpm_fidelity, quality_gate

DEVICES = [pytest.param('cpu', marks=pytest.mark.slow),
           pytest.param('cuda', marks=pytest.mark.cuda)]


@pytest.fixture
def device(request):
    if request.param == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    return torch.device(request.param)


def _hold(line, checks):
    print(json.dumps(line, default=str))
    for cond, msg in checks:
        assert cond, msg


@pytest.mark.parametrize('device', DEVICES, indirect=True)
def test_train_synthesize_vocode_evaluate_gate(device):
    line, checks, *_ = quality_gate(device)
    _hold(line, checks)


@pytest.mark.parametrize('device', DEVICES, indirect=True)
def test_dpm_fidelity_on_trained_weights(device):
    _hold(*dpm_fidelity(device))
