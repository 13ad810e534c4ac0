"""The frozen reference agrees with the program at a tiny size on the CPU,
in f32: every drive's check reads near zero, and the NumPy MAS is the
program's MAS exactly."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import mas

TINY = {'precision': 'float32', 'n_enc_channels': 32, 'filter_channels': 64,
        'filter_channels_dp': 16, 'n_enc_layers': 2, 'dec_dim': 16}
TINY_TRAFFIC = {
    'ljspeech-synth-b32': {'batch': 8, 'batches': 2, 'frame_budget': 128,
                           'euler_steps': 2},
    'tedlium-spk-generate-b32': {'batch': 8, 'batches': 2,
                                 'frame_budget': 64, 'euler_steps': 2},
    'tedlium-spk-nbest-b50': {'batch': 10, 'hypotheses': 20,
                              'frame_budget': 128, 'euler_steps': 2},
    'ljspeech-train-b128': {'batch': 8, 'batches': 4},
}
# mels of the n-best traffic fit its tiny budget at a faster speaking rate
TINY_SIZES = {'tedlium-spk-nbest-b50': {'chars_per_second': 60.0}}


def tiny_run(workload, seed=5):
    torch.manual_seed(0)
    return run.run_cell(workload, seed, 0.0, device='cpu',
                        sizes={**TINY, **TINY_SIZES.get(workload, {})},
                        traffic_sizes=TINY_TRAFFIC[workload])


@pytest.mark.parametrize('workload', sorted(TINY_TRAFFIC))
def test_program_matches_reference(workload):
    result = tiny_run(workload)
    for name, c in result['compared'].items():
        assert c['value'] <= 1e-4, (name, c['value'])
    assert result['correct'], result['compared']


def test_numpy_mas_is_the_programs():
    from gradtts_tpu_torch.ops.mas import maximum_path_plain
    rng = np.random.default_rng(0)
    B, tx, ty = 6, 17, 53
    t_x = rng.integers(3, tx + 1, B)
    t_y = np.minimum(t_x * rng.uniform(1.0, 3.0, B), ty).astype(int)
    t_y = np.maximum(t_y, t_x)
    mask = np.zeros((B, tx, ty), np.float32)
    for i in range(B):
        mask[i, :t_x[i], :t_y[i]] = 1.0
    value = (rng.standard_normal((B, tx, ty)) * 3).astype(np.float32)
    want = maximum_path_plain(torch.from_numpy(value), torch.from_numpy(mask))
    got = mas.maximum_path(value, mask)
    assert np.array_equal(got, want.numpy())
