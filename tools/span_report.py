"""One traced run of a benchmark cell, split by the program's spans: where
each kernel's launch lay (stage, U-Net sub-span, inside K1's tangent or
not), the counts of the spans a call, the top-level spans' share of the
device time, the longest idle gaps named by the span the host was in, and
the idle time summed by that span, the Python garbage collections that
ran on the host while the card idled, and the seconds that reading the
spans takes.

    python3 tools/span_report.py --workload W --seed N [--seconds 10]
        [--root CHECKOUT] [--out spans_W.json]

Runs ``benchmark.run.run_cell`` of the checkout ``--root`` (default: this
repository) with ``--trace 1`` and keeps the ``Trace`` its harness reads
(the reading is wrapped, not changed). Prints the harness's result line,
then one JSON object of the tables, which ``--out`` also receives. Needs a
GPU, as the harness does.
"""

import argparse
import gc
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel classes of the tables, by the kernel's full name
CLASSES = {
    'elementwise_128_4': re.compile(r'elementwise_kernel<128, ?4\b'),
    'elementwise': re.compile(r'elementwise'),
    'cf32_gemm': re.compile(r'gemm_cf32'),
    'fft_other': re.compile(r'fft|complex|region_transform', re.I),
    'conv3x3': re.compile(r'conv3x3'),
}
K1_TANGENT = 'gradtts.unet.k1_tangent'
STAGE_OF = ('gradtts.encoder', 'gradtts.align', 'gradtts.decoder',
            'gradtts.likelihood', 'gradtts.train.forward',
            'gradtts.train.backward', 'gradtts.train.optimizer')


def chains(trace, found):
    """{correlation id: (open span names, outermost first)} of every
    kernel whose launch the trace holds: a sweep over the launches in time
    order with the stack of spans open at each (``found``: the program's
    spans, ``benchmark/spans.py program_spans``)."""
    ivs = sorted(((a, b, n) for n, v in found.items() for a, b in v),
                 key=lambda v: (v[0], -v[1]))
    launches = sorted((trace.launches[c][1], c) for c in trace.kernel_corr
                      if c in trace.launches)
    out, stack, j = {}, [], 0
    for t, c in launches:
        while j < len(ivs) and ivs[j][0] <= t:
            while stack and stack[-1][1] < ivs[j][0]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[c] = tuple(v[2] for v in stack)
    return out


def group_of(chain):
    """(stage, innermost U-Net span, in K1's tangent) of a launch's
    chain."""
    if not chain:
        return ('(no span)', '', False)
    stage = next((n for n in chain if n in STAGE_OF), chain[0])
    parts = [n for n in chain
             if n.startswith('gradtts.unet') and n != K1_TANGENT]
    return (stage, parts[-1] if parts else '', K1_TANGENT in chain)


def tables(trace, spans, collections=()):
    """The breakdown of one traced window (``spans``: the benchmark's
    ``benchmark/spans.py`` module; ``collections``: the host's garbage
    collections, (generation, start s, end s))."""
    found, index = spans.read_trace(trace)
    roots = [r for r in spans.ROOTS.values() if r in found]
    calls = sum(len(found[r]) for r in roots)
    per_call = 1.0 / calls if calls else float('nan')
    by_chain = chains(trace, found)
    groups = {}
    for c, (name, s, e) in trace.kernel_corr.items():
        key = group_of(by_chain.get(c, ())) if c in by_chain \
            else ('(launch not traced)', '', False)
        g = groups.setdefault(key, dict(launches=0, ms=0.0,
                                        **{k: 0.0 for k in CLASSES}))
        g['launches'] += 1
        g['ms'] += 1e3 * (e - s)
        for k, pat in CLASSES.items():
            if pat.search(name):
                g[k] += 1e3 * (e - s)
    rows = [dict(stage=k[0], part=k[1], k1_tangent=k[2],
                 **{f: v * per_call for f, v in g.items()})
            for k, g in sorted(groups.items(), key=lambda kv: -kv[1]['ms'])]
    kernel_ms = 1e3 * sum(e - s for _, s, e in trace.kernels)
    top = roots + (['gradtts.vocoder'] if 'gradtts.vocoder' in found
                   else [])
    top_ms = 1e3 * spans.kernel_s(index, [iv for n in top for iv in found[n]])
    counts = {n: len(found[n]) * per_call for n in spans.NAMES
              if n in found}
    unlinked = {}
    for c, (name, s, e) in trace.kernel_corr.items():
        if c not in trace.launches:
            unlinked[name[:64]] = unlinked.get(name[:64], 0.0) \
                + 1e3 * (e - s) / trace.calls
    return {
        'calls_traced': trace.calls, 'root_spans': calls,
        'calls_per_s_traced': trace.calls / trace.window_s,
        'window_s': trace.window_s, 'busy_s': trace.busy_s(),
        'kernels': len(trace.kernels), 'linked': trace.linked(),
        'spans_per_call': counts,
        'kernel_ms_per_call': kernel_ms * per_call,
        'top_level_ms_per_call': top_ms * per_call,
        'top_level_share': top_ms / kernel_ms if kernel_ms else None,
        'stage_ms_per_call': {
            n: 1e3 * spans.kernel_s(index, found[n]) * per_call
            for n in spans.NAMES if n in found},
        'groups_per_call': rows,
        'unlinked_ms_per_call': unlinked,
        **idle_gaps(trace, spans, by_chain, collections),
    }


def idle_gaps(trace, spans, by_chain, collections=(), top=10):
    """The longest gaps between device operations (``idle_gaps``): seconds,
    the span the host was in as the gap began, the one that launched the
    operation that ended it, and the garbage collections (generation, ms)
    that ran on the host between the gap's start and that launch. Beside
    them, every gap's idle time summed by the span the host was in as it
    began (``idle_ms_by_span``), and the idle time of the gaps that such a
    collection overlapped (``idle_ms_in_gc``), with the collections' time
    inside the window by generation (``gc_ms_by_generation``)."""
    corr_of = {(n, s): c for c, (n, s, _) in trace.kernel_corr.items()}
    gaps, end, prev = [], None, None
    ops = sorted(trace.device_ops, key=lambda o: o[1])
    for name, s, e in ops:
        if end is not None and s > end:
            gaps.append((s - end, end, prev, name, corr_of.get((name, s))))
        if end is None or e > end:
            end, prev = e, name
    gaps.sort(key=lambda g: -g[0])

    def host_until(at, corr):
        launch = trace.launches.get(corr)
        return launch[1] if launch else at

    def collected(a, b):
        return [(g, 1e3 * (e - s)) for g, s, e in collections
                if s < b and e > a]

    by_span, in_gc = {}, 0.0
    for gap, at, _, _, corr in gaps:
        name = spans.innermost_span(trace, at) or '(no span)'
        by_span[name] = by_span.get(name, 0.0) + 1e3 * gap
        if collected(at, max(host_until(at, corr), at + gap)):
            in_gc += 1e3 * gap
    lo, hi = (ops[0][1], end) if ops else (0.0, 0.0)
    gc_ms = {}
    for g, s, e in collections:
        if s < hi and e > lo:
            gc_ms[g] = gc_ms.get(g, 0.0) + 1e3 * (min(e, hi) - max(s, lo))
    out = []
    for gap, at, before, after, corr in gaps[:top]:
        launch = trace.launches.get(corr)
        out.append({
            'gap_ms': 1e3 * gap,
            'span_at_gap': spans.innermost_span(trace, at),
            'launching_span': (spans.innermost_span(trace, launch[1])
                               if launch else None),
            'launch_chain': list(by_chain.get(corr, ())),
            'before': before[:64], 'after': after[:64],
            'host_call': launch[0] if launch else None,
            'gc': collected(at, host_until(at, corr))})
    return {'idle_gaps': out,
            'idle_ms_by_span': dict(sorted(by_span.items(),
                                           key=lambda kv: -kv[1])),
            'idle_ms_in_gc': in_gc, 'gc_ms_by_generation': gc_ms}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, default=10.0)
    p.add_argument('--root', default=ROOT)
    p.add_argument('--out')
    args = p.parse_args(argv)
    out = os.path.abspath(args.out) if args.out else None
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    from benchmark import run, spans, trace as trace_mod

    kept, timing = {}, {}
    read = trace_mod.read

    def keeping(prof, window_s, calls, spans=()):
        t0 = time.perf_counter()
        kept['trace'] = read(prof, window_s, calls, spans=spans)
        timing['read_trace_s'] = time.perf_counter() - t0
        return kept['trace']

    trace_mod.read = keeping
    collections, started = [], {}

    def on_gc(phase, info):
        # on the profiler's clock (Unix time, as the program's spans)
        if phase == 'start':
            started['t'] = time.time_ns()
        elif 't' in started:
            collections.append((info['generation'], started.pop('t') * 1e-9,
                                time.time_ns() * 1e-9))

    gc.callbacks.append(on_gc)
    try:
        result = run.run_cell(args.workload, args.seed, args.seconds,
                              trace=True)
    finally:
        gc.callbacks.remove(on_gc)
    print(json.dumps({k: v for k, v in result.items()
                      if k != 'diagnostics'}), flush=True)
    trace = kept['trace']
    manifest = run.load_manifest()
    readers = [m['name'] for m in run.cell_metrics(manifest, args.workload,
                                                   'per_layer')
               if m.get('source') == 'program_span']
    spans._read[:] = [None, None]     # read the spans afresh, as one run does
    t0 = time.perf_counter()
    runs = run.Run(None, 0, 0.0, 0.0, {}, trace)
    for name in readers:
        run.metric_reader(name)(runs)
    timing['span_readers_s'] = time.perf_counter() - t0
    report = {'workload': args.workload, 'seed': args.seed,
              'root': root, 'timing': timing,
              **tables(trace, spans, collections)}
    text = json.dumps(report)
    print(text, flush=True)
    if out:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, 'w') as f:
            f.write(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
