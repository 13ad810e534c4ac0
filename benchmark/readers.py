"""What the metric files read: a finished run's work, its measured window
and, in a traced run, the trace of the window that follows it.

Each metric of ``BENCHMARK.json`` has a file ``metrics/<name>.py`` with a
``read(run)`` that returns its value, or None where the run holds nothing
for it to read (the harness then leaves the metric out of its line).
"""

import glob
import os
import re

# a CUDA entry: __global__ void [__launch_bounds__(...)] name(
_ENTRY = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\s*\('
                    r'(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(')


def program_kernel_names():
    """The names of the program's hand kernels: every ``__global__`` entry
    of its CUDA sources."""
    import gradtts_tpu_torch
    root = os.path.dirname(gradtts_tpu_torch.__file__)
    names = set()
    for path in glob.glob(os.path.join(root, 'csrc', '*.cu')):
        with open(path) as f:
            names.update(_ENTRY.findall(f.read()))
    return names


def _matches(name, entries):
    return any(re.search(rf'\b{e}\b', name) for e in entries)


def rate(run, key):
    return run.work[key] / run.window_s


def mfu(run):
    """Model FLOPs of the calls completed in the measured window, over its
    seconds, over the cell's peak, in %."""
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * run.calls * run.drive.flops_per_call() \
        / run.window_s / run.drive.peak_flops()


def kernel_roofline(run):
    """The least time of the hand kernels' work over their device time, in
    %: the frozen bound of each kernel family that ran (the drive's
    ``kernel_families``: {family: entry names}), times the calls, over the
    traced time of every kernel of the program's sources."""
    if run.trace is None:
        return None
    entries = program_kernel_names()
    by_name = {}
    for n, s, e in run.trace.kernels:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    spent = sum(t for n, t in by_name.items() if _matches(n, entries))
    if not spent:
        return None
    families = run.drive.kernel_families
    bound = sum(v for fam, v in run.drive.kernel_bound_per_call().items()
                if any(_matches(n, families[fam]) for n in by_name))
    return 100.0 * bound * run.trace.calls / spent


def launches_per_call(run):
    """Kernels launched in the traced window over its calls."""
    if run.trace is None or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.trace.calls
