"""The program's own spans in a traced window: the device time of the
kernels launched inside a span, over the calls (the drive's root span) or
over the span's own count, and the span the host was in at a given time.

The program keeps each span it opened under a capture in
``utils/profiling.py RECORDED``, on the clock of the profiler's events;
``program_spans`` takes every span of the traced window, whatever its
name, so a span that the program adds is readable at once. The names a
metric reads belong to its drive (``drives/gradtts.py`` for Grad-TTS). A
kernel belongs to a span when the host runtime call that launched it
(``Trace.launches``, by correlation id) lies inside one of the span's
intervals. The backward pass launches from autograd's own thread while
the main thread is inside its span, so matching by time covers it. A
program without these spans (an older checkout) records none: every
reader then returns None.
"""

import bisect

import numpy as np

_read = [None, None]     # the trace last read, and its spans and index


def program_spans(trace):
    """{name: [(start, end), ...]} in seconds of every span the program
    recorded that was open during the trace's launches, or {} where the
    program recorded none or its record no longer reaches back to the
    window's start."""
    from gradtts_tpu_torch.utils import profiling
    record = getattr(profiling, 'RECORDED', None)
    times = [at for _, at in trace.launches.values()]
    if not record or not times:
        return {}
    lo, hi = min(times), max(times)
    kept = list(record)
    if len(kept) == record.maxlen and min(a for _, a, _ in kept) * 1e-9 > lo:
        return {}
    out = {}
    for name, a, b in kept:
        a, b = a * 1e-9, b * 1e-9
        if b >= lo and a <= hi:
            out.setdefault(name, []).append((a, b))
    return out


def read_trace(trace):
    """(``program_spans``, ``launch_index``) of a trace, read once for the
    readers of one run."""
    if _read[0] is not trace:
        _read[:] = [trace, (program_spans(trace), launch_index(trace))]
    return _read[1]


def _union(intervals):
    """Sorted, disjoint [start, end] intervals covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def launch_index(trace):
    """(host launch times, ascending; running sum of the kernels' device
    seconds in that order, from 0) of the kernels whose launch the trace
    holds."""
    corrs = [c for c in trace.kernel_corr if c in trace.launches]
    at = np.fromiter((trace.launches[c][1] for c in corrs), np.float64,
                     len(corrs))
    dur = np.fromiter((trace.kernel_corr[c][2] - trace.kernel_corr[c][1]
                       for c in corrs), np.float64, len(corrs))
    order = np.argsort(at, kind='stable')
    return at[order], np.concatenate(([0.0], np.cumsum(dur[order])))


def kernel_s(index, intervals):
    """Device seconds of the kernels launched inside ``intervals`` (launch
    time in [start, end] of one), found by bisection: O((kernels +
    intervals) log kernels). ``index``: ``launch_index(trace)``."""
    at, cum = index
    ivs = np.array(_union(intervals), np.float64)
    if not len(ivs):
        return 0.0
    lo = np.searchsorted(at, ivs[:, 0], 'left')
    hi = np.searchsorted(at, ivs[:, 1], 'right')
    return float((cum[hi] - cum[lo]).sum())


def _ms_over(run, span, count):
    if run.trace is None:
        return None
    found, index = read_trace(run.trace)
    n = len(found.get(count, ()))
    if not n or span not in found:
        return None
    spent = kernel_s(index, found[span])
    return 1e3 * spent / n if spent else None


def per_call_ms(run, span):
    """Device ms of ``span``'s kernels over the calls, counted as the
    drive's root spans (``run.drive.root_span``) in the trace."""
    return _ms_over(run, span, run.drive.root_span)


def per_span_ms(run, span):
    """Device ms of ``span``'s kernels over the count of its own spans (an
    evaluation of a part that a call runs many times)."""
    return _ms_over(run, span, span)


def innermost_span(trace, t):
    """The deepest program span that was open on the host at time ``t``,
    or None: of the intervals holding ``t``, the one that started last, or
    of two that started together the one that ended first (spans nest by
    call)."""
    found = read_trace(trace)[0]
    best, best_key = None, None
    for name, intervals in found.items():
        ivs = sorted(intervals)
        i = bisect.bisect_right(ivs, (t, float('inf'))) - 1
        # intervals of one name do not nest: the last start at or before
        # t is the only one of this name that may hold it
        if i < 0 or ivs[i][1] < t:
            continue
        key = (ivs[i][0], -ivs[i][1])     # a tie in start: the shorter
        if best is None or key > best_key:
            best, best_key = name, key
    return best
