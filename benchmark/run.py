"""The benchmark's harness: runs one cell of ``BENCHMARK.json`` once on the
GPU and prints one JSON line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up builds the program's model with weights
drawn from the seed, the cell's inputs from the seed, and warms up every
shape of the cell; then calls run back to back until ``--seconds`` have
passed (the window ends at a call boundary; at least the calls the check
samples). After the window: the peak memory is read, the program's state
is freed and the plain reference checks the sampled outputs. With
``--trace 1`` a second window of ``--seconds`` follows the measured one
under ``torch.profiler``, and the line holds the cell's per-layer metrics,
else its end-to-end ones.

Everything a cell is made of is found by name: the workload's
configuration (``configs/<config>.json``), traffic (``traffic/<traffic>
.json``), limits (``limits/<workload>.json``), the traffic's drive
(``drives/<drive>.py``), the configuration's reference (its ``reference``
key, a file of ``reference/``) and each metric's reader
(``metrics/<metric>.py``). Build and kernel caches stay inside the
checkout, under ``build/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, 'build', 'benchmark')
for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                 ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TORCHINDUCTOR_CACHE_DIR', 'inductor'),
                 ('CUDA_CACHE_PATH', 'cuda')):
    os.environ[var] = os.path.join(CACHE, sub)

import torch  # noqa: E402

from benchmark import drives, imports, trace as trace_mod  # noqa: E402
from benchmark.traffic import load_traffic  # noqa: E402


def load_manifest(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def metric_reader(name):
    path = os.path.join(HERE, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'benchmark.metrics.{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(manifest, workload, kind):
    """The ``kind`` ('end_to_end' or 'per_layer') metrics this workload
    reports: those listing it, and those that list no workloads."""
    return [m for m in manifest[kind]
            if workload in m.get('workloads', [workload])]


def load_cell(workload, sizes=None, traffic_sizes=None, manifest=None):
    """(workload entry, configuration, traffic, limits) of a cell;
    ``sizes`` and ``traffic_sizes`` narrow the configuration and the
    traffic (CPU tests only)."""
    manifest = manifest or load_manifest()
    cell = next(w for w in manifest['workloads'] if w['name'] == workload)
    cfg = dict(load_json('configs', f"{cell['config']}.json"), **(sizes or {}))
    tr = dict(load_traffic(cell['traffic']), **(traffic_sizes or {}))
    return cell, cfg, tr, load_json('limits', f'{workload}.json')


def judge(numbers, limits):
    """({name: {'value', 'limit'}}, correct) of the check's numbers: correct
    where each has a limit and is finite and within it."""
    compared = {k: {'value': v, 'limit': limits.get(k)}
                for k, v in numbers.items()}
    return compared, all(
        c['limit'] is not None and math.isfinite(c['value'])
        and c['value'] <= c['limit'] for c in compared.values())


@dataclass
class Run:
    drive: object
    calls: int
    window_s: float
    setup_s: float
    work: dict
    trace: object = None


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def window(drive, seconds, first, device):
    """Calls from number ``first`` on, back to back, until ``seconds`` have
    passed (and at least the calls the check samples, counted from 0);
    returns (calls, seconds) of the window, which ends at a call
    boundary."""
    _sync(device)
    t0 = time.perf_counter()
    calls = 0
    while first + calls < drive.min_calls or calls == 0 \
            or time.perf_counter() - t0 < seconds:
        drive.call(first + calls)
        calls += 1
    _sync(device)
    return calls, time.perf_counter() - t0


def run_cell(workload, seed, seconds, trace=False, device='cuda',
             sizes=None, traffic_sizes=None, manifest=None):
    """Runs the cell once; returns the result dict (without the import
    check). ``sizes`` and ``traffic_sizes`` narrow the configuration and
    the traffic (CPU tests only)."""
    manifest = manifest or load_manifest()
    cell, cfg, tr, limits = load_cell(workload, sizes, traffic_sizes,
                                      manifest)
    if cfg['precision'] == 'float32':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    drive = drives.load(tr['drive'])(cfg, tr, seed, device)
    drive.setup(sizes or {})
    _sync(device)
    setup_s = time.perf_counter() - T0

    calls, window_s = window(drive, seconds, 0, device)
    work = drive.work(calls)
    traced = None
    if trace:
        # the profiler's host cost slows a host-paced call: the traced
        # window follows the measured one, whose pace the readers take
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            traced_calls, traced_s = window(drive, seconds, calls, device)
        traced = trace_mod.read(prof, traced_s, traced_calls)
        del prof
        print(f'trace: {len(traced.kernels)} kernels, {traced.linked()} '
              'linked to their launch', file=sys.stderr)
    run = Run(drive, calls, window_s, setup_s, work, traced)
    kind = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in cell_metrics(manifest, workload, kind):
        value = metric_reader(m['name'])(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': 'gpu' if torch.device(device).type == 'cuda'
           else 'cpu', 'count': cell['chips']}
    if dev['platform'] == 'gpu':
        dev['kind'] = torch.cuda.get_device_name(0)
        dev['memory_peak_bytes'] = torch.cuda.max_memory_allocated(0)
    if traced is not None:
        dev['busy_s'] = traced.busy_s()
        dev['window_s'] = traced.window_s
    attempted = calls + (traced.calls if traced is not None else 0)
    result = {'attempted': attempted, 'failed': 0, 'metrics': metrics,
              'device': dev}
    if traced is not None:
        result['breakdown'] = {'device_ops': traced.by_name(),
                               'idle_gaps': traced.idle_gaps()}
    drive.release()
    if dev['platform'] == 'gpu':
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    compared, result['correct'] = judge(drive.check(), limits)
    result['compared'] = compared     # last in the line: the numbers checked
    result['diagnostics'] = drive.diagnostics
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    manifest = load_manifest()
    cell = next((w for w in manifest['workloads']
                 if w['name'] == args.workload), None)
    if cell is None:
        p.error(f'no workload {args.workload!r} in BENCHMARK.json')
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell['chips']:
        print(f'benchmark: the cell needs {cell["chips"]} CUDA device(s), '
              f'found {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), 'cuda', manifest=manifest)
    found = imports.forbidden_loaded()
    if found:
        print(f'benchmark: the process loaded {found}', file=sys.stderr)
        return 3
    for name, c in result['compared'].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    del result['diagnostics']
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
