"""Profiling and timing: a profiler trace, device-synchronized timing and
throughput counters.

Counterpart of gradtts_tpu/utils/profiling.py (``trace`` :23,
``time_jitted`` :33, ``Throughput`` :57):

- ``trace(logdir)``: a ``torch.profiler`` capture of CPU activity, and of
  the card's kernels where a GPU is present, written to ``logdir`` as a
  TensorBoard trace (the PyTorch profiler plugin reads it);
- ``time_jitted(fn, *args)``: wall time of a call that ends when the
  device has finished its outputs, after warm-up calls;
- ``Throughput``: running audio-seconds a second (and items) counters, the
  RTF formula ``t * sr / (frames * hop)`` as a rate;
- ``span(name)``: the program's own spans at its stage boundaries, a
  host event of the capture while a profiler captures (``trace`` or any
  other ``torch.profiler.profile``) and nothing otherwise. Their names are
  ``SPANS``; ``RECORDED`` keeps each captured span's interval. A span's
  parent is the span open when it started.
"""

import collections
import contextlib
import logging
import os
import time
from typing import Callable, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import (ProfilerActivity, profile,
                            tensorboard_trace_handler)

log = logging.getLogger('gradtts_tpu_torch.profiling')

SPANS = (
    'gradtts.synthesize',       # models/tts.py synthesize: a call (root)
    'gradtts.score',            # nbest/scoring.py score_batch: a call (root)
    'gradtts.train_step',       # train/state.py train_step: a step (root)
    'gradtts.encoder',          # GradTTS.encode: text encoder, durations
    'gradtts.align',            # durations and path, or grid, MAS, crop; mu_y
    'gradtts.decoder',          # the sampler loop, Euler or DPM-Solver
    'gradtts.likelihood',       # likelihood/ode.py: Euler or Dormand-Prince
    'gradtts.unet',             # a score U-Net evaluation (jvp: both halves)
    'gradtts.unet.embed',       # time, speaker MLPs; inputs to channels-last
    'gradtts.unet.resnet',      # a ResnetBlock (an up level's first: its cat)
    'gradtts.unet.attention',   # a Residual(Rezero(LinearAttention)): K2 + K3
    'gradtts.unet.resample',    # a down-, up-sample or Identity, its mask ops
    'gradtts.unet.out',         # final_block and final_conv
    'gradtts.unet.k1_tangent',  # GroupNormMishFn.jvp: K1's plain tangent
    'gradtts.train.forward',    # train_step: the losses
    'gradtts.train.backward',   # train_step: .backward()
    'gradtts.train.optimizer',  # train_step: shared grads, clip, Adam
    'gradtts.vocoder',          # models/hifigan.py Generator.forward
)

_OFF = contextlib.nullcontext()
# (name, start ns, end ns) of the spans captured, the newest last, on the
# clock of the profiler's own events (Unix time): a reader that holds only
# a capture's device activity and launches assigns kernels to spans by it
RECORDED = collections.deque(maxlen=1 << 18)


class _Span:
    """A span under a capture: a host-only event of the capture (a
    ``cpu_op``, where a ``record_function`` would add a device-side copy
    that reads as device work where events carry no activity type) and its
    interval in ``RECORDED``, which encloses the event's."""

    __slots__ = ('name', 'event', 'start')

    def __init__(self, name):
        self.name = name
        self.event = _RecordFunctionFast(name)

    def __enter__(self):
        self.start = time.time_ns()
        self.event.__enter__()
        return self

    def __exit__(self, *exc):
        self.event.__exit__(*exc)
        RECORDED.append((self.name, self.start, time.time_ns()))
        return False


def span(name: str):
    """A host event of the capture named ``name``, with its interval kept
    in ``RECORDED``, while a ``torch.profiler`` capture is on; else one
    shared ``nullcontext`` (well under a microsecond, where a
    ``record_function`` costs its own ~10 us whether or not a profiler
    runs). ``name`` is one of ``SPANS``. A span launches nothing on the
    device and leaves the work it wraps as it is."""
    if torch._C._autograd._profiler_enabled():
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profiles the block into ``logdir`` and yields the
    ``torch.profiler.profile``, whose ``events()`` and ``key_averages()``
    the caller reads after the block. CUDA activity is recorded when
    ``torch.cuda.is_available()``. The trace is one Chrome-format
    ``{host}_{pid}.{ns}.pt.trace.json``, as ``tensorboard_trace_handler``
    names it for TensorBoard's profiler plugin; Perfetto's UI opens the
    same file. Where the JAX package prints a Perfetto link,
    ``create_perfetto_link`` logs the file's path."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
    if create_perfetto_link:
        path = max((os.path.join(logdir, n) for n in os.listdir(logdir)
                    if n.endswith('.pt.trace.json')), key=os.path.getmtime)
        log.info('Perfetto trace: %s (open it in the Perfetto UI)', path)


def _tensors(tree):
    """The tensors of a nest of tuples (NamedTuples too), lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Waits until every CUDA device that holds a tensor of ``tree`` has
    finished its queued work (``jax.block_until_ready``); returns
    ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def time_jitted(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                **kwargs) -> dict:
    """Median, mean and least wall seconds of ``fn(*args, **kwargs)`` over
    ``iters`` calls, each ended by :func:`block_until_ready` on its output,
    after ``warmup`` calls (at least one) that are not timed; and the last
    output. In the port the warm-up takes the kernels' build or load at
    first use and cuDNN's choice of algorithms, where the JAX package's
    takes the compile."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args, **kwargs)
    block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        'median_s': times[len(times) // 2],
        'mean_s': sum(times) / len(times),
        'min_s': times[0],
        'iters': iters,
        'last_output': out,
    }


class Throughput:
    """Running throughput counters for synthesis and training loops.

    audio-seconds a second is the headline metric; RTF is its reciprocal
    per utterance.
    """

    def __init__(self, sample_rate: int = 22050, hop_length: int = 256):
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.reset()

    def reset(self):
        self._t0: Optional[float] = None
        self.frames = 0
        self.items = 0
        self.elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError('Throughput.stop() before start()')
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None

    def add(self, frames: int, items: int = 1):
        self.frames += int(frames)
        self.items += items

    @property
    def audio_seconds(self) -> float:
        return self.frames * self.hop_length / self.sample_rate

    @property
    def audio_sec_per_sec(self) -> float:
        return self.audio_seconds / self.elapsed if self.elapsed else 0.0

    @property
    def rtf(self) -> float:
        """Real-time factor: synthesis seconds per audio second."""
        return self.elapsed / self.audio_seconds if self.frames else 0.0

    def summary(self) -> dict:
        return {
            'items': self.items,
            'audio_seconds': self.audio_seconds,
            'elapsed_s': self.elapsed,
            'audio_sec_per_sec': self.audio_sec_per_sec,
            'rtf': self.rtf,
        }
