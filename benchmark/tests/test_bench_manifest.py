"""BENCHMARK.json against the benchmark's contract, and a cell added as
files alone (CPU)."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run

ROOT = run.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


@pytest.fixture(scope='module')
def manifest():
    return run.load_manifest()


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == KEYS
    assert manifest['paths'] == ['benchmark']
    assert manifest['command'][-1] == 'benchmark.run'
    assert len(manifest['command']) <= 32
    assert 1 <= manifest['run_seconds'] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_entry_keys(manifest):
    names = []
    for c in manifest['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and c['file'].startswith('benchmark/')
        assert len(c['reduced']) <= 16
        names.append(c['name'])
    for w in manifest['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and len(w['why']) <= 200
        names.append(w['name'])
    for kind in ('end_to_end', 'per_layer'):
        for m in manifest[kind]:
            assert NAME.match(m['name']) and UNIT.match(m['unit'])
            assert m['better'] in ('lower', 'higher')
            assert m['source'] in SOURCES
            if kind == 'end_to_end':
                assert 0 < m['bound'] <= 0.25
                assert m['source'] in ('host_clock', 'device_trace')
            else:
                assert m['layer'] and '\n' not in m['layer']
            names.append(m['name'])
    assert len(names) == len(set(names))


def test_every_cell_has_its_files_and_metrics(manifest):
    configs = {c['name']: c for c in manifest['configs']}
    e2e = {m['name']: m for m in manifest['end_to_end']}
    for w in manifest['workloads']:
        cfg = run.load_json('configs', f"{w['config']}.json")
        assert configs[w['config']]['file'] == \
            f"benchmark/configs/{w['config']}.json"
        assert cfg['reduced'] == configs[w['config']]['reduced']
        assert os.path.exists(os.path.join(run.HERE, 'traffic',
                                           f"{w['traffic']}.json"))
        assert run.load_json('limits', f"{w['name']}.json")
        reported = run.cell_metrics(manifest, w['name'], 'end_to_end')
        assert 'setup_s' in {m['name'] for m in reported}
        assert len(reported) >= 2
        assert run.cell_metrics(manifest, w['name'], 'per_layer')
    for kind in ('end_to_end', 'per_layer'):
        for m in manifest[kind]:
            assert callable(run.metric_reader(m['name']))
    assert 'setup_s' in e2e


def test_per_layer_metrics_move_what_their_cells_report(manifest):
    e2e = {m['name']: m for m in manifest['end_to_end']}
    for m in manifest['per_layer']:
        moved = e2e[m['moves']]
        for w in m['workloads']:
            assert w in moved.get('workloads', [w]), (m['name'], w)


def test_run_seconds_fit_a_check_of_24_cells(manifest):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (manifest['run_seconds'] + 60) + cells * 2 * 90 \
        + 1200 <= 43200


TINY = {'precision': 'float32', 'n_enc_channels': 32, 'filter_channels': 64,
        'filter_channels_dp': 16, 'n_enc_layers': 2, 'dec_dim': 16}


def test_a_cell_added_as_files_runs(tmp_path, manifest):
    """A new configuration, traffic mix, per-layer metric and limits file,
    and one workloads entry: the harness runs the cell unchanged."""
    shutil.copytree(run.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = tmp_path / 'benchmark'
    cfg = json.loads((bench / 'configs' / 'ljspeech.json').read_text())
    cfg['name'] = 'ljspeech-copy'
    (bench / 'configs' / 'ljspeech-copy.json').write_text(json.dumps(cfg))
    (bench / 'traffic' / 'synth-b8.json').write_text(json.dumps({
        'drive': 'synthesize', 'batch': 8, 'batches': 2,
        'lengths': 'ljspeech-train', 'frame_budget': 128, 'euler_steps': 2,
        'temperature': 1.0}))
    (bench / 'limits' / 'ljspeech-copy-synth-b8.json').write_text(
        json.dumps({'dur_gap': 0.0, 'mu_err': 1e-3, 'mel_err': 1e-3}))
    (bench / 'metrics' / 'frames_per_row.py').write_text(
        'def read(run):\n    return run.work["frames"] / run.work["rows"]\n')
    m = dict(manifest)
    m['configs'] = manifest['configs'] + [dict(
        manifest['configs'][0], name='ljspeech-copy',
        file='benchmark/configs/ljspeech-copy.json')]
    m['workloads'] = manifest['workloads'] + [{
        'name': 'ljspeech-copy-synth-b8', 'config': 'ljspeech-copy',
        'traffic': 'synth-b8', 'chips': 1, 'why': 'a throwaway cell'}]
    m['end_to_end'] = [dict(e, workloads=e['workloads']
                            + ['ljspeech-copy-synth-b8'])
                       if e['name'] == 'synth_audio_s_per_s' else e
                       for e in manifest['end_to_end']] + [{
        'name': 'frames_per_row', 'unit': 'frames', 'better': 'higher',
        'bound': 0.25, 'source': 'host_clock',
        'workloads': ['ljspeech-copy-synth-b8']}]
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(m))
    code = ('import json, torch; torch.set_num_threads(2);'
            'from benchmark import run;'
            f'r = run.run_cell("ljspeech-copy-synth-b8", 5, 0.0, '
            f'device="cpu", sizes={TINY!r});'
            'print(json.dumps(r))')
    env = dict(os.environ, PYTHONPATH=f'{tmp_path}{os.pathsep}{ROOT}')
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result['compared']
    metrics = result['metrics']
    assert metrics['frames_per_row']['value'] > 0
    assert {'synth_audio_s_per_s', 'setup_s', 'frames_per_row'} \
        <= set(metrics)
