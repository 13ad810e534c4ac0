"""The program's own spans in a traced window: the names the benchmark
reads (the program's ``utils/profiling.py SPANS`` holds each), the device
time of the kernels launched inside a span, and the span the host was in
at a given time.

The program keeps each span it opened under a capture in
``utils/profiling.py RECORDED``, on the clock of the profiler's events;
``program_spans`` takes those of the traced window. A kernel belongs to a
span when the host runtime call that launched it (``Trace.launches``, by
correlation id) lies inside one of the span's intervals. The backward pass
launches from autograd's own thread while the main thread is inside
``gradtts.train.backward``, so matching by time covers it. A program
without these spans (an older checkout) records none: every reader then
returns None.
"""

import bisect

import numpy as np

# the roots: one a call of each drive
ROOTS = {'synth': 'gradtts.synthesize', 'nbest': 'gradtts.score',
         'train': 'gradtts.train_step'}
ENCODER = 'gradtts.encoder'
ALIGN = 'gradtts.align'
UNET = 'gradtts.unet'
K1_TANGENT = 'gradtts.unet.k1_tangent'
BACKWARD = 'gradtts.train.backward'
OPTIMIZER = 'gradtts.train.optimizer'
# every span the readers take: those the metrics read, and the rest for
# the breakdown by span (innermost_span)
NAMES = (*ROOTS.values(), ENCODER, ALIGN, 'gradtts.decoder',
         'gradtts.likelihood', UNET, 'gradtts.unet.embed',
         'gradtts.unet.resnet', 'gradtts.unet.attention',
         'gradtts.unet.resample', 'gradtts.unet.out', K1_TANGENT,
         'gradtts.train.forward', BACKWARD, OPTIMIZER, 'gradtts.vocoder')


_read = [None, None]     # the trace last read, and its spans and index


def program_spans(trace):
    """{name: [(start, end), ...]} in seconds of the program's spans (of
    ``NAMES``) open during the trace's launches, or {} where the program
    recorded none or its record no longer reaches back to the window's
    start."""
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
        if name in NAMES and b >= lo and a <= hi:
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
    time in [start, end] of one, as ``Trace.span_kernel_s`` reads a span),
    found by bisection: O((kernels + intervals) log kernels). ``index``:
    ``launch_index(trace)``."""
    at, cum = index
    ivs = np.array(_union(intervals), np.float64)
    if not len(ivs):
        return 0.0
    lo = np.searchsorted(at, ivs[:, 0], 'left')
    hi = np.searchsorted(at, ivs[:, 1], 'right')
    return float((cum[hi] - cum[lo]).sum())


def per_call_ms(run, span, drive):
    """Device ms of ``span``'s kernels over the calls of ``drive`` ('synth',
    'nbest' or 'train'), counted as its root spans in the trace."""
    if run.trace is None:
        return None
    found, index = read_trace(run.trace)
    calls = len(found.get(ROOTS[drive], ()))
    if not calls or span not in found:
        return None
    spent = kernel_s(index, found[span])
    return 1e3 * spent / calls if spent else None


def unet_ms(run):
    """Device ms of an evaluation of the score U-Net: the kernels in
    ``gradtts.unet`` over the count of its spans."""
    if run.trace is None:
        return None
    found, index = read_trace(run.trace)
    if not found.get(UNET):
        return None
    spent = kernel_s(index, found[UNET])
    return 1e3 * spent / len(found[UNET]) if spent else None


def innermost_span(trace, t):
    """The deepest program span (of ``NAMES``) that was open on the host at
    time ``t``, or None: of the intervals holding ``t``, the one that
    started last, or of two that started together the one that ended
    first (spans nest by call)."""
    found = read_trace(trace)[0]
    best, best_key = None, None
    for name in NAMES:
        ivs = sorted(found.get(name, []))
        i = bisect.bisect_right(ivs, (t, float('inf'))) - 1
        # intervals of one name do not nest: the last start at or before
        # t is the only one of this name that may hold it
        if i < 0 or ivs[i][1] < t:
            continue
        key = (ivs[i][0], -ivs[i][1])     # a tie in start: the shorter
        if best is None or key > best_key:
            best, best_key = name, key
    return best
