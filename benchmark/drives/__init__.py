"""The drives: how a traffic mix's calls reach the program, what work they
complete, and how the check holds the window's outputs to the reference.

A traffic file names its drive (``"drive"``): the module
``drives/<drive>.py``, which exports ``Drive``, a subclass of
:class:`Drive`. Those here: ``synthesize`` (text to mel, ``models/tts.py
synthesize``), ``generate`` (the same, then the HiFi-GAN generator of
``models/hifigan.py``), ``score`` (n-best likelihood, ``nbest/scoring.py
score_batch``) and ``train`` (``train/state.py train_step``), on the
Grad-TTS base of ``drives/gradtts.py``. A drive builds its reference from
the file under ``benchmark/reference/`` that the configuration's
``reference`` key names. The drives are the only modules of the benchmark
that import the program (``gradtts_tpu_torch``) to run it.
"""

import importlib
import os
import re

import numpy as np
import torch

from benchmark import counting
from benchmark.imports import REFERENCE_DIR

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
NAME = re.compile(r'^[A-Za-z0-9_]+$')


def load(name):
    """The ``Drive`` class of ``drives/<name>.py``."""
    if not NAME.match(name) \
            or not os.path.exists(os.path.join(HERE, f'{name}.py')):
        raise ValueError(f'no drive {name!r}: no file drives/{name}.py')
    drive = getattr(importlib.import_module(f'{__name__}.{name}'), 'Drive',
                    None)
    if not (isinstance(drive, type) and issubclass(drive, Drive)) \
            or drive is Drive:
        raise ValueError(f'drives/{name}.py exports no Drive')
    return drive


def load_reference(cfg):
    """The module of the reference file that the configuration's
    ``reference`` key names (relative to the checkout's root): a file
    directly under ``benchmark/reference/``, which the import check
    (``imports.reference_violations``) covers; any other path is
    refused."""
    path = os.path.normpath(os.path.join(ROOT, cfg['reference']))
    name = os.path.basename(path)[:-len('.py')]
    if os.path.dirname(path) != REFERENCE_DIR or not path.endswith('.py') \
            or not NAME.match(name) or not os.path.exists(path):
        raise ValueError(f'the reference {cfg["reference"]!r} is no file '
                         'of benchmark/reference/')
    return importlib.import_module(f'benchmark.reference.{name}')


class Drive:
    """One cell's program state and calls.

    The harness calls ``setup(sizes)`` (``sizes``: configuration keys set
    in CPU tests only), then ``call(k)`` for k = 0, 1, ..., then
    ``work(calls)``, the metric readers (``flops_per_call``,
    ``kernel_bound_per_call``, ``peak_flops``), ``release()`` and
    ``check()``, which returns {number: value} for the limits. The control
    (``control.py``) calls ``prepare()``, ``reference_model()``,
    ``low_precision(model, on)`` and ``fill_from_reference(model, what)``,
    then ``check()``.

    ``min_calls``: calls the window makes whatever its length (the check's
    sample lies among them); ``diagnostics``: numbers the check reads
    beside those it compares; ``root_span``: the program's span that one
    call opens once (the span readers' divisor); ``kernel_families``:
    {family: CUDA entry names} of the program's hand kernels, the keys of
    ``kernel_bound_per_call``; ``trains``: whether the reference runs in
    train mode; ``faults``: what the control takes beside ``'control'``;
    ``released``: the program's state that ``release`` frees."""
    min_calls = 1
    diagnostics = {}
    root_span = None
    kernel_families = counting.KERNEL_FAMILIES
    trains = False
    faults = ()
    released = ('model', 'optimizer')

    def __init__(self, cfg, tr, seed, device):
        self.cfg, self.tr, self.device = cfg, tr, device
        self.dtype = getattr(torch, cfg['precision'])
        host = np.random.default_rng(seed)
        self.weight_seed, self.input_seed, self.draw_seed = (
            int(v) for v in host.integers(0, 2 ** 62, 3))
        self.rng = np.random.default_rng(int(host.integers(0, 2 ** 62)))
        self.ref = load_reference(cfg)

    def peak_flops(self):
        return counting.PEAK_FLOPS[self.cfg['precision']]

    def release(self):
        for name in self.released:
            self.__dict__.pop(name, None)

    def low_precision(self, model, on):
        """Switches the control's arithmetic (the nearest precision below
        the configuration's) on or off on the reference ``model``."""
        raise NotImplementedError(f'{type(self).__name__} has no control')
