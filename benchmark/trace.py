"""Reads a ``torch.profiler`` capture of the measured window: device
activity (kernels, copies, sets) and the host's runtime calls that
launched them. The program's spans are read from its own record
(``spans.py``).

Only the profiler's in-memory events are read (nothing is written to
disk). Times are seconds; a device interval is [start, end) of one
kernel, copy or set on the card.
"""

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

NAME_CHARS = 64


@dataclass
class Trace:
    window_s: float
    calls: int
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    launches: Dict[int, Tuple[str, float]] = field(default_factory=dict)
    kernel_corr: Dict[int, Tuple[str, float, float]] = field(
        default_factory=dict)

    def busy_s(self):
        """Seconds in which an operation ran on the device: the union of
        the device intervals."""
        total, end = 0.0, None
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def by_name(self, top=10):
        """The device operations that took most time: [[name, s], ...]."""
        sums = {}
        for name, s, e in self.device_ops:
            key = short(name)
            sums[key] = sums.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(sums.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """The longest gaps between device operations, each named by the
        host call that launched the operation after it and the operation
        before it: [[name, s], ...]."""
        ops = sorted(self.device_ops, key=lambda o: o[1])
        corr_of = {(n, s): c for c, (n, s, _) in self.kernel_corr.items()}
        gaps, end, prev = [], None, None
        for name, s, e in ops:
            if end is not None and s > end:
                host = self.launches.get(corr_of.get((name, s)), ('host',))[0]
                gaps.append((s - end, f'{host}_after_{prev}'))
            if end is None or e > end:
                end, prev = e, name
        gaps.sort(key=lambda g: -g[0])
        return [[short(n), g] for g, n in gaps[:top]]

    def linked(self):
        """The kernels whose launching host call the trace holds."""
        return sum(c in self.launches for c in self.kernel_corr)


def short(name):
    """A name of at most 64 characters with no space."""
    return re.sub(r'[^A-Za-z0-9_.:<>,-]+', '_', name)[:NAME_CHARS]


def _kind(ev):
    """'kernel', 'copy', 'runtime' or None for a profiler event: by its
    activity type where the event has one, else by its device and name."""
    kind = getattr(ev, 'activity_type', None)
    if kind is not None:
        return {'kernel': 'kernel', 'gpu_memcpy': 'copy',
                'gpu_memset': 'copy', 'cuda_runtime': 'runtime',
                'cuda_driver': 'runtime'}.get(kind())
    if ev.device_type() == DeviceType.CUDA:
        return 'copy' if ev.name().startswith(('Memcpy', 'Memset')) \
            else 'kernel'
    return 'runtime' if ev.name().startswith('cu') else None


def read(prof, window_s, calls):
    """The :class:`Trace` of a finished ``torch.profiler.profile`` over a
    window of ``window_s`` seconds and ``calls`` calls."""
    tr = Trace(window_s, calls)
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        name, kind = ev.name(), _kind(ev)
        if kind in ('kernel', 'copy'):
            tr.device_ops.append((name, start, end))
        if kind == 'kernel':
            tr.kernels.append((name, start, end))
            tr.kernel_corr[ev.correlation_id()] = (name, start, end)
        elif kind == 'runtime':
            tr.launches[ev.correlation_id()] = (name, start)
    return tr
