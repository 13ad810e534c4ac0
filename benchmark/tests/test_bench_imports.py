"""The import check, by whole top-level module names (CPU)."""

import os
import shutil
import subprocess
import sys

from benchmark import imports, run


def test_forbidden_by_whole_top_level_name():
    assert imports.forbidden_loaded(['gradtts_tpu_torch.models.tts',
                                     'jaxtyping', 'flaxen', 'torch']) == []
    assert imports.forbidden_loaded(['gradtts_tpu.models', 'jax.numpy',
                                     'jaxlib', 'flax.linen']) == \
        ['flax', 'gradtts_tpu', 'jax', 'jaxlib']


def test_reference_imports_nothing_of_the_program():
    assert imports.reference_violations() == {}
    code = ('import sys; import benchmark.reference.gradtts, '
            'benchmark.reference.hifigan, benchmark.reference.mas;'
            'from benchmark import imports;'
            'names = {n.split(".")[0] for n in sys.modules};'
            'print(sorted(names & {"gradtts_tpu_torch", *imports.FORBIDDEN}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == '[]'


def test_harness_fails_without_a_card():
    out = subprocess.run([sys.executable, '-m', 'benchmark.run', '--workload',
                          'ljspeech-synth-b32', '--seed', '1', '--seconds',
                          '1'], cwd=run.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ''


def test_harness_fails_with_only_its_own_files(tmp_path):
    shutil.copytree(run.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(os.path.join(run.ROOT, 'BENCHMARK.json'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-m', 'benchmark.run', '--workload',
                          'ljspeech-synth-b32', '--seed', '1', '--seconds',
                          '1'], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ''
