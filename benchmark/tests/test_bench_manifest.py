"""BENCHMARK.json against the benchmark's contract, and a cell added as
files alone (CPU)."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import drives, imports, run
from benchmark.traffic import load_traffic

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


def test_every_drive_loads_and_every_reference_is_under_reference(
        manifest):
    for w in manifest['workloads']:
        drive = drives.load(load_traffic(w['traffic'])['drive'])
        assert issubclass(drive, drives.Drive) and drive.root_span
    for c in manifest['configs']:
        cfg = run.load_json('configs', f"{c['name']}.json")
        path = os.path.normpath(os.path.join(ROOT, cfg['reference']))
        assert os.path.dirname(path) == imports.REFERENCE_DIR, cfg['reference']
        assert drives.load_reference(cfg).__file__ == path


@pytest.mark.parametrize('reference', ['benchmark/reference/none.py',
                                       'benchmark/weights.py',
                                       'benchmark/reference/../compare.py',
                                       '/tmp/gradtts.py'])
def test_a_reference_outside_reference_is_refused(reference):
    with pytest.raises(ValueError, match='benchmark/reference/'):
        drives.load_reference({'reference': reference})


@pytest.mark.parametrize('name', ['gradtts', 'nothing', '../run', ''])
def test_only_a_drive_file_with_a_drive_loads(name):
    with pytest.raises(ValueError):
        drives.load(name)


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


VOCODE_DRIVE = '''\
"""The program's HiFi-GAN generator alone: each call vocodes one batch of
seeded mels."""

import torch

from benchmark import compare, counting, weights
from benchmark.drives import Drive as Base
from benchmark.reference.lowp import LowPrecision


class Vocode(Base):
    root_span = 'gradtts.vocoder'
    min_calls = 2
    kernel_families = {}

    def __init__(self, cfg, tr, seed, device):
        super().__init__(cfg, tr, seed, device)
        self.reference = self.ref.Generator(cfg['vocoder'])

    def state_dict(self):
        return weights.seeded_state_dict(weights.shapes_of(self.reference),
                                         self.weight_seed, self.device)

    def prepare(self):
        gen = torch.Generator(device=self.device).manual_seed(
            self.input_seed)
        shape = (self.tr['batch'], self.tr['frames'],
                 self.cfg['vocoder']['num_mels'])
        self.inputs = [torch.randn(shape, generator=gen, device=self.device)
                       for _ in range(self.tr['batches'])]
        self.kept, self.samples = {}, 0

    def setup(self, sizes):
        from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
        self.prepare()
        with torch.device(self.device):
            self.model = Generator(HiFiGANConfig.from_json(
                self.cfg['vocoder']))
        self.model.load_state_dict(self.state_dict(), strict=True)
        with torch.no_grad():
            self.model(self.inputs[0])

    def call(self, k):
        with torch.no_grad():
            wav = self.model(self.inputs[k % len(self.inputs)])
        self.samples += wav.numel()
        if k < self.min_calls:
            self.kept[k] = wav

    def work(self, calls):
        return {'audio_s': self.samples / self.cfg['sample_rate']}

    def check(self):
        model = self.reference_model().eval()
        with torch.no_grad():
            return {'wav_err': max(
                compare.rel_max(wav, model(self.inputs[k]))
                for k, wav in self.kept.items())}

    def reference_model(self):
        model = self.reference.to(self.device)
        model.load_state_dict(self.state_dict(), strict=True)
        return model

    def fill_from_reference(self, model, what):
        with torch.no_grad():
            self.kept = {k: model(self.inputs[k])
                         for k in range(self.min_calls)}

    def low_precision(self, model, on):
        lp = LowPrecision('fp8' if on else None)
        for m in model.modules():
            if isinstance(m, self.ref.Lp):
                m.lp = lp

    def flops_per_call(self):
        meta = counting.meta_model(lambda: self.ref.Generator(
            self.cfg['vocoder']))
        return counting.vocoder_flops(meta, self.tr['batch'],
                                      self.tr['frames'],
                                      self.cfg['vocoder']['num_mels'])

    def kernel_bound_per_call(self):
        return {}


Drive = Vocode
'''

HOST_MS = '''\
"""Host ms a call inside the program's ``gradtts.vocoder`` spans."""
from gradtts_tpu_torch.utils import profiling


def read(run):
    if run.trace is None:
        return None
    ivs = [(a, b) for n, a, b in profiling.RECORDED
           if n == run.drive.root_span]
    return 1e-6 * sum(b - a for a, b in ivs) / len(ivs) if ivs else None
'''


def _hashes(root):
    return {os.path.relpath(os.path.join(d, f), root): hashlib.sha256(
                open(os.path.join(d, f), 'rb').read()).hexdigest()
            for d, dirs, files in os.walk(root)
            for f in files if '__pycache__' not in d}


def test_a_cell_of_another_model_added_as_files_runs(tmp_path, manifest):
    """A cell whose model is not Grad-TTS (the program's HiFi-GAN V1
    generator alone, at a tiny width) added as new files only: its drive,
    a reference copied from ``reference/hifigan.py``, a configuration with
    no Grad-TTS key, a traffic mix, limits, an end-to-end and a per-layer
    metric (the latter reads the program's ``gradtts.vocoder`` span) and a
    workloads entry. The harness runs it traced and untraced, the control
    runs from the drive's own ``low_precision``, and no file that the
    benchmark had changes."""
    shutil.copytree(run.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = tmp_path / 'benchmark'
    before = _hashes(bench)
    (bench / 'drives' / 'vocode.py').write_text(VOCODE_DRIVE)
    shutil.copy(bench / 'reference' / 'hifigan.py',
                bench / 'reference' / 'vocoder.py')
    cfg = {'name': 'tiny-vocoder',
           'source': 'https://github.com/jik876/hifi-gan/blob/master/'
                     'config_v1.json',
           'reference': 'benchmark/reference/vocoder.py',
           'precision': 'float32', 'sample_rate': 22050,
           'reduced': ['vocoder'],
           'vocoder': {'resblock': '1', 'upsample_rates': [4, 4],
                       'upsample_kernel_sizes': [8, 8],
                       'upsample_initial_channel': 16,
                       'resblock_kernel_sizes': [3],
                       'resblock_dilation_sizes': [[1, 3]], 'num_mels': 80}}
    (bench / 'configs' / 'tiny-vocoder.json').write_text(json.dumps(cfg))
    (bench / 'traffic' / 'vocode-b2.json').write_text(json.dumps(
        {'drive': 'vocode', 'batch': 2, 'batches': 2, 'frames': 32}))
    workload = 'tiny-vocoder-vocode-b2'
    (bench / 'limits' / f'{workload}.json').write_text(
        json.dumps({'wav_err': 1e-4}))
    (bench / 'metrics' / 'vocoded_audio_s_per_s.py').write_text(
        'from benchmark.readers import rate\n\n\n'
        'def read(run):\n    return rate(run, "audio_s")\n')
    (bench / 'metrics' / 'vocoder_host_ms.vocode.py').write_text(HOST_MS)
    m = dict(manifest)
    m['configs'] = manifest['configs'] + [{
        'name': 'tiny-vocoder', 'source': cfg['source'],
        'file': 'benchmark/configs/tiny-vocoder.json',
        'reduced': ['vocoder'], 'why': 'HiFi-GAN V1 at a tiny width'}]
    m['workloads'] = manifest['workloads'] + [{
        'name': workload, 'config': 'tiny-vocoder', 'traffic': 'vocode-b2',
        'chips': 1, 'why': 'a throwaway cell of another model'}]
    m['end_to_end'] = manifest['end_to_end'] + [{
        'name': 'vocoded_audio_s_per_s', 'unit': 'audio-s/s',
        'better': 'higher', 'bound': 0.25, 'source': 'host_clock',
        'workloads': [workload]}]
    m['per_layer'] = manifest['per_layer'] + [{
        'name': 'vocoder_host_ms.vocode', 'unit': 'ms', 'better': 'lower',
        'source': 'program_span', 'layer': 'vocoder',
        'moves': 'vocoded_audio_s_per_s', 'workloads': [workload]}]
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(m))
    code = textwrap.dedent(f'''
        import json, torch
        torch.set_num_threads(2)
        from benchmark import control, run
        out = {{'plain': run.run_cell({workload!r}, 2 ** 31 + 9, 0.0,
                                      device='cpu'),
               'traced': run.run_cell({workload!r}, 2 ** 31 + 9, 0.0,
                                      trace=True, device='cpu'),
               'control': control.control_run({workload!r}, 2 ** 31 + 9,
                                              'control', 'cpu')}}
        print(json.dumps(out))
        ''')
    env = dict(os.environ, PYTHONPATH=f'{tmp_path}{os.pathsep}{ROOT}')
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    plain, traced, ctl = result['plain'], result['traced'], result['control']
    assert plain['correct'] and traced['correct'], (plain['compared'],
                                                    traced['compared'])
    assert set(plain['metrics']) == {'vocoded_audio_s_per_s', 'setup_s'}
    assert plain['metrics']['vocoded_audio_s_per_s']['value'] > 0
    assert set(traced['metrics']) == {'vocoder_host_ms.vocode'}
    assert traced['metrics']['vocoder_host_ms.vocode']['value'] > 0
    assert not ctl['correct'], ctl['compared']
    assert ctl['compared']['wav_err']['value'] > 1e-3
    after = _hashes(bench)
    assert {k: after.get(k) for k in before} == before
    assert set(after) - set(before) == {
        'drives/vocode.py', 'reference/vocoder.py',
        'configs/tiny-vocoder.json', 'traffic/vocode-b2.json',
        f'limits/{workload}.json', 'metrics/vocoded_audio_s_per_s.py',
        'metrics/vocoder_host_ms.vocode.py'}
