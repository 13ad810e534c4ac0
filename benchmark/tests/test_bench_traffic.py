"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes (CPU)."""

import pytest
import torch

from benchmark import run, traffic

CELLS = ('ljspeech-synth-b32', 'tedlium-spk-nbest-b50',
         'ljspeech-train-b128', 'tedlium-spk-generate-b32')
SMALL = {'synthesize': {'batches': 2}, 'generate': {'batches': 2},
         'train': {'batch': 16, 'batches': 2}, 'score': {}}


def _inputs(workload, seed):
    cell = next(w for w in run.load_manifest()['workloads']
                if w['name'] == workload)
    cfg = run.load_json('configs', f"{cell['config']}.json")
    tr = traffic.load_traffic(cell['traffic'])
    tr.update(SMALL[tr['drive']])
    return traffic.make_inputs(tr, cfg, seed, 'cpu')


@pytest.mark.parametrize('workload', CELLS)
def test_same_seed_same_inputs(workload):
    a, b = _inputs(workload, 2 ** 31 + 11), _inputs(workload, 2 ** 31 + 11)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize('workload', CELLS)
def test_seeds_differ_in_values_not_in_sizes(workload):
    a, b = _inputs(workload, 3), _inputs(workload, 4)
    assert any(not torch.equal(x['x'], y['x']) for x, y in zip(a, b))
    for x, y in zip(a, b):
        for k in x:
            assert x[k].shape == y[k].shape, k
    if 'y_lengths' in a[0] and workload != 'tedlium-spk-nbest-b50':
        assert torch.equal(a[0]['y_lengths'].sort()[0],
                           b[0]['y_lengths'].sort()[0])
    assert torch.equal(a[0]['x_lengths'].sort()[0],
                       b[0]['x_lengths'].sort()[0]) \
        or workload == 'tedlium-spk-nbest-b50'


def test_texts_are_blank_interspersed():
    for batch in _inputs('ljspeech-synth-b32', 9) \
            + _inputs('tedlium-spk-nbest-b50', 9):
        for row, n in zip(batch['x'], batch['x_lengths']):
            ids = row[:int(n)]
            assert bool((ids[0::2] == 148).all())
            assert bool((ids[1::2] > 0).all() and (ids[1::2] < 148).all())
            assert bool((row[int(n):] == 0).all())


def test_quantile_rows_span_the_table():
    table = traffic.load_lengths('ljspeech-train')
    rows = traffic.quantile_rows(table, 32)
    assert rows[:, 0].min() > table[:, 0].min()
    assert rows[:, 0].max() < table[:, 0].max()
    assert abs(rows[:, 0].mean() - table[:, 0].mean()) < 2.0
