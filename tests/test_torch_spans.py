"""The program's spans (``utils.profiling.span``, ``SPANS``): off without a
profiler, nested by call under one, counted where the work happens, and
leaving every output as it is. CPU at a tiny width; JAX-free, so the
``cuda`` test also runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

from collections import Counter
from typing import NamedTuple, Optional

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from gradtts_tpu_torch.models.tts import GradTTS, synthesize
from gradtts_tpu_torch.nbest.scoring import score_batch
from gradtts_tpu_torch.train.state import make_optimizer, train_step
from gradtts_tpu_torch.utils import profiling

TINY = dict(n_enc_channels=32, filter_channels=64, filter_channels_dp=16,
            n_heads=2, n_enc_layers=2, n_feats=80, dec_dim=16)
N_VOCAB = 148
# sub-spans of one U-Net evaluation: 3 down levels of 2 ResnetBlocks, an
# attention and a resample; the middle's 2 and 1; 2 up levels as the down
# ones; the embedding and the output
UNET_PARTS = Counter({'gradtts.unet.resnet': 12, 'gradtts.unet.attention': 6,
                      'gradtts.unet.resample': 5, 'gradtts.unet.embed': 1,
                      'gradtts.unet.out': 1})
K1_PER_UNET = 25            # every Block: 2 a ResnetBlock, and final_block


class Span(NamedTuple):
    name: str
    start: int              # ns
    end: int
    parent: Optional[int]   # index of the span open when it started


def spans_of(prof):
    """The program's spans of a finished profile, in start order, each with
    its parent: the innermost span of its thread still open at its start."""
    evs = sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
          e.start_thread_id())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith('gradtts.')
         and e.device_type() == DeviceType.CPU),
        key=lambda s: (s[1], -s[2]))
    out, stacks = [], {}
    for name, a, b, tid in evs:
        stack = stacks.setdefault(tid, [])
        while stack and out[stack[-1]].end <= a:
            stack.pop()
        out.append(Span(name, a, b, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def host_events(prof):
    """(name, start ns) of the capture's host events other than the
    program's spans: operators and runtime calls (kernel launches)."""
    return [(e.name(), e.start_ns())
            for e in prof.profiler.kineto_results.events()
            if not e.name().startswith('gradtts.')
            and e.device_type() == DeviceType.CPU]


def check_recorded(spans, recorded, events):
    """The program's record of the capture's spans holds each span once,
    its interval enclosing the capture's own, and assigns every host event
    (a launch among them) to the spans the capture's intervals do."""
    assert sorted(n for n, _, _ in recorded) == sorted(s.name for s in spans)
    for name in {s.name for s in spans}:
        mine = sorted((a, b) for n, a, b in recorded if n == name)
        theirs = sorted((s.start, s.end) for s in spans if s.name == name)
        for (a, b), (c, d) in zip(mine, theirs):
            assert a <= c and d <= b, (name, (a, b), (c, d))
        inside = [[e for e in events if any(a <= e[1] <= b for a, b in ivs)]
                  for ivs in (mine, theirs)]
        assert inside[0] == inside[1], name


def traced(fn, device='cpu'):
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    first = len(profiling.RECORDED)
    with profile(activities=activities) as prof:
        out = fn()
    spans = spans_of(prof)
    assert {s.name for s in spans} <= set(profiling.SPANS)
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
    check_recorded(spans, list(profiling.RECORDED)[first:], host_events(prof))
    return out, spans


def children(spans, i):
    return [s for s in spans if s.parent == i]


def indices(spans, name):
    return [i for i, s in enumerate(spans) if s.name == name]


def roots(spans):
    return [s.name for s in spans if s.parent is None]


def ancestor(spans, i, name):
    """Index of the nearest span named ``name`` above span ``i``."""
    i = spans[i].parent
    while i is not None and spans[i].name != name:
        i = spans[i].parent
    return i


def check_unets(spans, count):
    unets = indices(spans, 'gradtts.unet')
    assert len(unets) == count
    for i in unets:
        assert Counter(s.name for s in children(spans, i)) == UNET_PARTS
    return unets


def tiny_model(seed=0, device='cpu'):
    torch.manual_seed(seed)
    with torch.device(device):
        return GradTTS(N_VOCAB, **TINY)


def text(device='cpu', seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(1, N_VOCAB, (3, 12), generator=g)
    x_lengths = torch.tensor([12, 9, 5])
    return x.to(device), x_lengths.to(device)


def mels(device='cpu', seed=2):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((3, 64, 80), generator=g)
    y_lengths = torch.tensor([64, 48, 40])
    return y.to(device), y_lengths.to(device)


def run_synthesize(model, sampler='euler'):
    x, x_lengths = text()
    noise = torch.randn((3, 64, 80),
                        generator=torch.Generator().manual_seed(3))
    return synthesize(model, x, x_lengths, 3, 64, noise=noise,
                      sampler=sampler)


def run_score(model, n_euler=2, device='cpu'):
    x, x_lengths = text(device)
    y, y_lengths = mels(device)
    eps = torch.randint(0, 2, y.shape,
                        generator=torch.Generator().manual_seed(4)) * 2. - 1
    return score_batch(model, x, x_lengths, y, y_lengths, n_euler=n_euler,
                       epsilon=eps.to(device))


def run_train(model, optimizer):
    x, x_lengths = text()
    y, y_lengths = mels()
    batch = {'x': x, 'x_lengths': x_lengths, 'y': y, 'y_lengths': y_lengths}
    return train_step(model, optimizer, batch, 32, 1.0,
                      torch.Generator().manual_seed(5))


def test_span_off_opens_no_event_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f'an event {name!r} with no profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(profiling, '_RecordFunctionFast', refuse)
    assert not torch._C._autograd._profiler_enabled()
    first = list(profiling.RECORDED)
    for name in profiling.SPANS:
        with profiling.span(name):
            pass
    model = tiny_model().eval()
    res = run_synthesize(model)
    assert torch.isfinite(res.decoder_outputs).all()
    run_score(model, n_euler=1)
    assert list(profiling.RECORDED) == first


def test_span_on_is_a_host_event_with_its_interval_recorded():
    """Under a capture a span is one host event (no device-side copy, as a
    ``record_function``'s user annotation has) and one interval in
    ``RECORDED`` that encloses it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span('gradtts.unet'):
            torch.ones(3).sum()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == 'gradtts.unet']
    assert len(evs) == 1 and evs[0].device_type() == DeviceType.CPU
    if hasattr(evs[0], 'activity_type'):
        assert evs[0].activity_type() == 'cpu_op'
    name, a, b = profiling.RECORDED[-1]
    assert name == 'gradtts.unet'
    assert a <= evs[0].start_ns() <= evs[0].start_ns() \
        + evs[0].duration_ns() <= b
    assert profiling.span('gradtts.unet') is profiling.span('gradtts.align')


def test_span_names_are_the_programs():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert all(n.startswith('gradtts.') for n in profiling.SPANS)


def test_synthesize_spans_nest_by_call():
    _, spans = traced(lambda: run_synthesize(tiny_model().eval()))
    assert roots(spans) == ['gradtts.synthesize']
    assert [s.name for s in children(spans, 0)] == [
        'gradtts.encoder', 'gradtts.align', 'gradtts.decoder']
    unets = check_unets(spans, 3)
    decoder = indices(spans, 'gradtts.decoder')[0]
    assert all(spans[i].parent == decoder for i in unets)
    assert not indices(spans, 'gradtts.unet.k1_tangent')


def test_dpm_synthesis_spans_its_sampler_as_the_decoder():
    _, spans = traced(lambda: run_synthesize(tiny_model().eval(), 'dpm'))
    assert roots(spans) == ['gradtts.synthesize']
    decoder = indices(spans, 'gradtts.decoder')
    assert len(decoder) == 1
    assert [spans[i].parent for i in check_unets(spans, 3)] == decoder * 3


def test_euler_score_counts_one_unet_an_evaluation():
    """The U-Net spans are the evaluations (``nfe``), each a jvp inside
    the integrator; each holds K1's plain tangent once a Block (the rule
    runs on the CPU too, there on the plain forward)."""
    res, spans = traced(lambda: run_score(tiny_model().eval(), n_euler=3))
    assert res.nfe == 3
    assert roots(spans) == ['gradtts.score']
    assert [s.name for s in children(spans, 0)] == [
        'gradtts.encoder', 'gradtts.align', 'gradtts.likelihood']
    likelihood = indices(spans, 'gradtts.likelihood')[0]
    unets = check_unets(spans, res.nfe)
    assert all(spans[i].parent == likelihood for i in unets)
    tangents = indices(spans, 'gradtts.unet.k1_tangent')
    assert Counter(ancestor(spans, i, 'gradtts.unet') for i in tangents) \
        == {i: K1_PER_UNET for i in unets}


def test_train_step_spans_forward_backward_optimizer_in_turn():
    model = tiny_model().train()
    _, spans = traced(lambda: run_train(model,
                                        make_optimizer(model.parameters())))
    assert roots(spans) == ['gradtts.train_step']
    phases = children(spans, 0)
    assert [s.name for s in phases] == [
        'gradtts.train.forward', 'gradtts.train.backward',
        'gradtts.train.optimizer']
    assert all(a.end <= b.start for a, b in zip(phases, phases[1:]))
    forward = indices(spans, 'gradtts.train.forward')[0]
    assert [s.name for s in children(spans, forward)] == [
        'gradtts.encoder', 'gradtts.align', 'gradtts.unet']
    check_unets(spans, 1)


def test_vocoder_spans_its_call():
    cfg = HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                        upsample_initial_channel=16,
                        resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 3),))
    torch.manual_seed(0)
    vocoder = Generator(cfg)
    with torch.no_grad():
        _, spans = traced(lambda: vocoder(torch.randn(2, 8, 80)))
    assert [s.name for s in spans] == ['gradtts.vocoder']


def test_every_span_name_is_reached():
    """Each name of ``SPANS`` is opened by one of the paths above, so no
    name outlives the code that opened it."""
    model = tiny_model()
    seen = set()
    for fn in (lambda: run_synthesize(model.eval()),
               lambda: run_score(model.eval()),
               lambda: run_train(model.train(),
                                 make_optimizer(model.parameters())),
               lambda: Generator(HiFiGANConfig(
                   upsample_rates=(2,), upsample_kernel_sizes=(4,),
                   upsample_initial_channel=8, resblock_kernel_sizes=(3,),
                   resblock_dilation_sizes=((1,),)))(torch.randn(1, 4, 80))):
        seen |= {s.name for s in traced(fn)[1]}
    assert seen == set(profiling.SPANS)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(p, q) for p, q in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _synthesize():
    return run_synthesize(tiny_model().eval())


def _score():
    return run_score(tiny_model().eval())


def _train():
    model = tiny_model().train()
    optimizer = make_optimizer(model.parameters())
    metrics = run_train(model, optimizer)
    return metrics, dict(model.state_dict()), optimizer.state_dict()


@pytest.mark.parametrize('call', [_synthesize, _score, _train],
                         ids=['synthesize', 'score_batch', 'train_step'])
def test_outputs_bit_identical_under_the_profiler(call):
    assert _same(call(), traced(call)[0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: K1 and its tangent rule on the '
                    'card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_k1_tangent_spans_on_the_card(cuda):
    """On the card K1 runs as the CUDA kernel and its tangent through
    ``GroupNormMishFn.jvp``: once a Block of every evaluation, and the
    kernels of each evaluation are launched inside its span."""
    model = tiny_model(device=cuda).eval()
    res, spans = traced(lambda: run_score(model, n_euler=2, device=cuda),
                        cuda)
    torch.cuda.synchronize()
    unets = check_unets(spans, res.nfe)
    tangents = indices(spans, 'gradtts.unet.k1_tangent')
    assert Counter(ancestor(spans, i, 'gradtts.unet') for i in tangents) \
        == {i: K1_PER_UNET for i in unets}
