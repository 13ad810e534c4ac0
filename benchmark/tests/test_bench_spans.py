"""The readers of the program's spans (``benchmark/spans.py``) on synthetic
traces and synthetic records of the program's spans: the bisection
against the brute-force sum, the counts they divide by (the drive's root
span, or the span's own), the innermost open span, the names against the
program's, and the harness's other readings unchanged by the program's
spans (CPU)."""

import collections
import random
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import counting, drives, readers, run, spans
from benchmark import trace as trace_mod
from benchmark.drives import gradtts
from benchmark.traffic import load_traffic
from gradtts_tpu_torch.utils import profiling

SPAN_METRICS = ('encoder_ms.synth', 'encoder_ms.nbest', 'encoder_ms.train',
                'align_ms.nbest', 'align_ms.train', 'unet_ms.synth',
                'unet_ms.nbest', 'unet_ms.train', 'k1_tangent_ms.nbest',
                'backward_ms.train', 'optimizer_ms.train',
                'vocoder_ms.synth')
NS = 1_000_000_000
SCORING = SimpleNamespace(root_span=gradtts.SCORE)


def brute_kernel_s(tr, intervals):
    """Device seconds of the kernels whose launch lies inside one of
    ``intervals``, kernel by kernel."""
    total = 0.0
    for corr, (_, s, e) in tr.kernel_corr.items():
        host = tr.launches.get(corr)
        if host and any(a <= host[1] <= b for a, b in intervals):
            total += e - s
    return total


def metric_drive(name):
    """The drive class of the first cell that reports metric ``name``."""
    manifest = run.load_manifest()
    metric = next(m for m in manifest['per_layer'] if m['name'] == name)
    cell = next(w for w in manifest['workloads']
                if w['name'] == metric['workloads'][0])
    return drives.load(load_traffic(cell['traffic'])['drive'])


@pytest.fixture
def record(monkeypatch):
    """The program's record of captured spans, empty, for a test to fill
    with (name, start ns, end ns)."""
    kept = collections.deque(maxlen=profiling.RECORDED.maxlen)
    monkeypatch.setattr(profiling, 'RECORDED', kept)
    return kept


def nested_trace(record, seed=0, calls=3, unets=4):
    """(trace, {name: intervals}) of ``calls`` score calls, each an
    encoder, an alignment and a likelihood of ``unets`` U-Net spans with
    sub-spans and K1 tangents, and kernels launched inside, between and
    outside every span (some with no launch in the trace). The spans go
    to ``record`` as the program keeps them, and to the dict in seconds
    for ``brute_kernel_s``."""
    rng = random.Random(seed)
    tr = trace_mod.Trace(window_s=calls * 1.0, calls=calls)
    opened = {}

    def open_span(name, a, b):
        a, b = round(a * NS), round(b * NS)
        record.append((name, a, b))
        opened.setdefault(name, []).append((a * 1e-9, b * 1e-9))

    for k in range(calls):
        t0 = 100.0 + k * 1.0 + 0.01
        open_span('gradtts.score', t0, t0 + 0.9)
        open_span('gradtts.encoder', t0 + 0.01, t0 + 0.1)
        open_span('gradtts.align', t0 + 0.1, t0 + 0.15)
        open_span('gradtts.likelihood', t0 + 0.2, t0 + 0.85)
        for u in range(unets):
            a = t0 + 0.2 + u * 0.16
            open_span('gradtts.unet', a, a + 0.15)
            for j in range(5):
                s = a + 0.005 + j * 0.028
                open_span('gradtts.unet.resnet', s, s + 0.025)
                open_span('gradtts.unet.k1_tangent', s + 0.01, s + 0.02)
    corr = 0
    for _ in range(4000):
        at = 100.0 + rng.uniform(-0.2, calls * 1.0 + 0.2)
        start = at + rng.uniform(1e-6, 1e-3)
        dur = rng.uniform(1e-6, 1e-4)
        tr.kernel_corr[corr] = (f'kernel_{rng.randrange(8)}', start,
                                start + dur)
        if rng.random() < 0.95:
            tr.launches[corr] = ('cudaLaunchKernel', at)
        corr += 1
    # launches on a span's very edges belong to it
    for name in ('gradtts.unet', 'gradtts.encoder'):
        for a, b in opened[name][:2]:
            for at in (a, b):
                tr.kernel_corr[corr] = ('edge', at + 1e-3, at + 2e-3)
                tr.launches[corr] = ('cudaLaunchKernel', at)
                corr += 1
    tr.kernels = sorted(tr.kernel_corr.values(), key=lambda k: k[1])
    tr.device_ops = list(tr.kernels)
    return tr, opened


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_bisection_matches_the_brute_force_sum(record, seed):
    tr, opened = nested_trace(record, seed)
    found, index = spans.read_trace(tr)
    assert found == opened
    for name in opened:
        want = brute_kernel_s(tr, opened[name])
        assert want > 0
        assert spans.kernel_s(index, found[name]) == pytest.approx(
            want, rel=1e-12)
    assert spans.kernel_s(index, found.get('gradtts.vocoder', [])) == 0.0


def test_overlapping_intervals_of_one_name_count_a_kernel_once():
    tr = trace_mod.Trace(1.0, 1)
    tr.kernel_corr = {0: ('k', 0.5, 0.6), 1: ('k', 0.7, 0.75)}
    tr.launches = {0: ('cudaLaunchKernel', 0.3),
                   1: ('cudaLaunchKernel', 0.45)}
    ivs = [(0.2, 0.4), (0.25, 0.5)]
    assert spans.kernel_s(spans.launch_index(tr), ivs) == pytest.approx(0.15)
    assert brute_kernel_s(tr, ivs) == pytest.approx(0.15)


def test_only_the_windows_spans_are_read(monkeypatch, record):
    """Spans the program recorded under an earlier capture are left out;
    every span of the window is read, whatever its name (a span that the
    program adds is readable at once); a record that has dropped spans
    from the window's start gives no spans at all."""
    old = [('gradtts.score', 1 * NS, 2 * NS), ('gradtts.unet', NS, NS + 5)]
    record.extend(old)
    tr, opened = nested_trace(record, calls=1, unets=1)
    other = (100 * NS + 5, 100 * NS + 6)
    record.append(('gradtts.other', *other))
    found = spans.program_spans(tr)
    assert found == dict(opened, **{'gradtts.other': [
        (other[0] * 1e-9, other[1] * 1e-9)]})
    assert len(found['gradtts.score']) == 1
    full = collections.deque(list(record)[len(old) + 1:],
                             maxlen=len(record) - len(old) - 1)
    monkeypatch.setattr(profiling, 'RECORDED', full)
    assert spans.program_spans(tr) == {}


def test_unet_ms_divides_by_the_span_count_and_the_rest_by_the_roots(
        record):
    tr, opened = nested_trace(record, calls=3, unets=4)
    r = SimpleNamespace(trace=tr, drive=SCORING)
    assert len(opened['gradtts.unet']) == 12
    assert spans.per_span_ms(r, gradtts.UNET) == pytest.approx(
        1e3 * brute_kernel_s(tr, opened['gradtts.unet']) / 12)
    assert spans.per_call_ms(r, gradtts.ENCODER) == pytest.approx(
        1e3 * brute_kernel_s(tr, opened['gradtts.encoder']) / 3)
    # the drive's roots in the trace, not the harness's call count
    tr.calls = 7
    assert spans.per_call_ms(r, gradtts.K1_TANGENT) == pytest.approx(
        1e3 * brute_kernel_s(tr, opened['gradtts.unet.k1_tangent']) / 3)
    # another drive's root is not in the trace
    r.drive = SimpleNamespace(root_span=gradtts.SYNTHESIZE)
    assert spans.per_call_ms(r, gradtts.ENCODER) is None


def test_metric_files_read_their_spans(record):
    """Each span metric reads its span over the root span of the drive of
    its cells (``BENCHMARK.json``'s ``workloads``)."""
    tr, _ = nested_trace(record)
    scores = [(a, b) for n, a, b in record if n == 'gradtts.score']
    aligns = [(a, b) for n, a, b in record if n == 'gradtts.align']
    for root in (gradtts.SYNTHESIZE, gradtts.TRAIN_STEP):
        record.extend((root, a, b) for a, b in scores)
    for name in (gradtts.BACKWARD, gradtts.OPTIMIZER, gradtts.VOCODER):
        record.extend((name, a, b) for a, b in aligns)
    for name in SPAN_METRICS:
        drive = metric_drive(name)
        r = SimpleNamespace(trace=tr, drive=drive)
        value = run.metric_reader(name)(r)
        assert value is not None and value > 0, name
        if name.startswith(('encoder_ms', 'vocoder_ms')):
            span = (gradtts.ENCODER if name.startswith('encoder')
                    else gradtts.VOCODER)
            want = brute_kernel_s(tr, [
                (a * 1e-9, b * 1e-9) for n, a, b in record if n == span])
            assert value == pytest.approx(1e3 * want / 3), name


@pytest.mark.parametrize('program', ['no-record', 'empty-record'])
def test_readers_return_none_without_the_programs_spans(monkeypatch, record,
                                                        program):
    """An older program keeps no record of its spans, or records none; an
    untraced run has no trace: every span metric is then left out, and
    nothing raises."""
    tr, _ = nested_trace(record)
    if program == 'no-record':
        monkeypatch.delattr(profiling, 'RECORDED')
    else:
        record.clear()
    for trace in (tr, None):
        for name in SPAN_METRICS:
            r = SimpleNamespace(trace=trace, drive=metric_drive(name))
            assert run.metric_reader(name)(r) is None, name


def test_innermost_span_is_the_deepest_open(record):
    record.extend([('gradtts.train.forward', 105 * NS, 106 * NS),
                   ('gradtts.encoder', 105 * NS, 105 * NS + NS // 2)])
    tr, _ = nested_trace(record, calls=1, unets=2)
    tr.launches[-1] = ('cudaLaunchKernel', 106.0)
    t0 = 100.01
    assert spans.innermost_span(tr, t0 - 0.005) is None
    assert spans.innermost_span(tr, t0 + 0.05) == 'gradtts.encoder'
    assert spans.innermost_span(tr, t0 + 0.17) == 'gradtts.score'
    assert spans.innermost_span(tr, t0 + 0.201) == 'gradtts.unet'
    assert spans.innermost_span(tr, t0 + 0.2 + 0.005 + 0.002) == \
        'gradtts.unet.resnet'
    assert spans.innermost_span(tr, t0 + 0.2 + 0.005 + 0.015) == \
        'gradtts.unet.k1_tangent'
    assert spans.innermost_span(tr, t0 + 0.2 + 0.16 + 0.005 + 0.015) == \
        'gradtts.unet.k1_tangent'
    assert spans.innermost_span(tr, t0 + 0.86) == 'gradtts.score'
    # a parent and a child that start together: the child, which ends first
    assert spans.innermost_span(tr, 105.0) == 'gradtts.encoder'
    assert spans.innermost_span(tr, 105.7) == 'gradtts.train.forward'


def test_names_are_the_programs():
    """A rename in the program breaks this test, not a metric: every span
    name that the Grad-TTS drives and their metric files read, and every
    drive's root, is one of the program's."""
    names = [v for k, v in vars(gradtts).items()
             if k.isupper() and isinstance(v, str)
             and v.startswith('gradtts.')]
    assert len(names) == len(set(names)) == 10
    assert set(names) <= set(profiling.SPANS)
    for traffic in ('synth-b32', 'generate-b32', 'nbest-b50', 'train-b128'):
        root = drives.load(load_traffic(traffic)['drive']).root_span
        assert root in names


class _Event:
    """A kineto event as ``trace.read`` reads it: with its activity type,
    or, as some torch builds give it, without one (``read`` then sorts it
    by device and name)."""

    def __init__(self, name, kind, start, dur, corr, device):
        self._v = (name, kind, start, dur, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        return self._v[5]


class _TypedEvent(_Event):
    def activity_type(self):
        return self._v[1]


PROGRAM_SPANS = (('gradtts.synthesize', 0, 6_000_000),
                 ('gradtts.encoder', 100_000, 900_000),
                 ('gradtts.unet', 1_000_000, 3_000_000),
                 ('gradtts.unet.resnet', 1_100_000, 1_900_000),
                 ('gradtts.vocoder', 6_600_000, 8_900_000))


def fake_profile(typed, program_spans, annotations=False, seed=0):
    """Two calls of launches and kernels (hand kernels and others), a copy
    and, with ``program_spans``, the program's spans: host events
    (``cpu_op``), as ``profiling.span`` opens them, or with
    ``annotations`` user annotations with device-side copies, as kineto
    records a ``record_function``."""
    rng = random.Random(seed)
    ev = _TypedEvent if typed else _Event
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    evs, corr = [], 1
    names = ['gn_apply_kernel<float, 64>', 'la_stats_kernel<float>',
             'void at::native::elementwise_kernel<128, 4>', 'sm80_xmma_gemm']
    for k in range(2):
        base = k * 10_000_000
        for name, a, b in PROGRAM_SPANS if program_spans else ():
            if annotations:
                evs.append(ev(name, 'user_annotation', base + a, b - a, 0,
                              cpu))
                evs.append(ev(name, 'gpu_user_annotation', base + a + 5000,
                              b - a, 0, gpu))
            else:
                evs.append(ev(name, 'cpu_op', base + a, b - a, 0, cpu))
        for _ in range(300):
            at = base + rng.randrange(0, 9_500_000)
            evs.append(ev('cudaLaunchKernel', 'cuda_runtime', at, 3000, corr,
                          cpu))
            evs.append(ev(rng.choice(names), 'kernel',
                          at + rng.randrange(5000, 80_000),
                          rng.randrange(1000, 30_000), corr, gpu))
            corr += 1
        evs.append(ev('Memcpy DtoD', 'gpu_memcpy', base + 9_600_000, 20_000,
                      corr, gpu))
        corr += 1
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


def other_readings(tr):
    drive = SimpleNamespace(kernel_bound_per_call=lambda: {'K1': 1e-5,
                                                           'K2': 2e-5},
                            kernel_families=counting.KERNEL_FAMILIES)
    r = SimpleNamespace(trace=tr, drive=drive)
    return (readers.launches_per_call(r), readers.kernel_roofline(r),
            tr.busy_s(), tr.by_name(), tr.idle_gaps(), tr.linked(),
            tr.kernels, tr.device_ops)


@pytest.mark.parametrize('typed', [True, False],
                         ids=['activity-type', 'device-and-name'])
def test_other_readings_unchanged_by_the_programs_spans(typed):
    """The harness reads a window without the program's spans (an older
    program) and one with them alike: the same launches, roofline, busy
    time and breakdown. The program's spans are host events, so none is
    counted as a device operation, also where events carry no activity
    type; a user annotation's device-side copy would be, there."""
    parent = trace_mod.read(fake_profile(typed, False), 0.02, 2)
    change = trace_mod.read(fake_profile(typed, True), 0.02, 2)
    want = other_readings(parent)
    assert other_readings(change) == want
    assert want[0] == 300 and want[1] > 0
    annotated = other_readings(trace_mod.read(
        fake_profile(typed, True, annotations=True), 0.02, 2))
    assert (annotated == want) if typed else (annotated[0] == want[0] + 5)


def test_kernel_roofline_counts_the_bound_of_each_family_that_ran():
    """A family's bound enters the numerator only where one of its entries
    (the drive's ``kernel_families``) ran; every hand kernel's time enters
    the denominator. conv3x3 is a family of its own."""
    tr = trace_mod.Trace(1.0, 2)
    tr.kernels = [('(anonymous namespace)::conv3x3_kernel(float const*)',
                   0.0, 0.3),
                  ('void la_stats_kernel<float, 64>(float const*)', 0.3, 0.4),
                  ('void at::native::elementwise_kernel<128, 4>()', 0.4, 0.9)]
    bounds = {'conv3x3': 0.1, 'K2': 0.02, 'K6': 5.0}
    drive = SimpleNamespace(kernel_bound_per_call=lambda: bounds,
                            kernel_families=counting.KERNEL_FAMILIES)
    r = SimpleNamespace(trace=tr, drive=drive)
    assert readers.kernel_roofline(r) == pytest.approx(100 * 0.12 * 2 / 0.4)
    # a drive whose families leave conv3x3 out: its time, not its bound
    drive.kernel_families = {'K2': ('la_stats_kernel',),
                             'K6': ('la_jvp_stats_kernel',)}
    del bounds['conv3x3']
    assert readers.kernel_roofline(r) == pytest.approx(100 * 0.02 * 2 / 0.4)
