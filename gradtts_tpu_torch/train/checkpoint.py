"""Training checkpoints: ``ckpt/step_{:08d}.pt``, a dict with the step and
a trainer's payload, so a resumed run continues exactly.

Counterpart of gradtts_tpu/train/checkpoint.py (Orbax directories there).
Each file is written to a temporary name and renamed, so a crash while
saving never leaves a partial latest checkpoint. In a multi-process run
rank 0 writes and every rank restores the same latest file. The acoustic trainer
(``train.loop``) stores 'model' (a reference-layout ``state_dict``, which
``utils.convert.load_checkpoint`` and so ``cli.inference`` read),
'optimizer' and 'generator' (the random generator's state); the vocoder
trainer (``train.vocoder``) stores 'generator' (a plain-weight HiFi-GAN
``state_dict``, which ``cli.inference --vocoder`` reads), 'mpd', 'msd',
both optimizers and their LR schedules.

The JAX package's orbax directories are read by
``utils.io.read_orbax_checkpoint``.
"""

import os
import re
import tempfile
from typing import Optional

import torch

from gradtts_tpu_torch.parallel.mesh import multihost_barrier, world

_NAME = re.compile(r'^step_(\d{8})\.pt$')


def save_checkpoint(ckpt_dir: str, step: int, payload: dict) -> str:
    """Writes ``{'step': step, **payload}`` to ``ckpt_dir/step_{step}.pt``
    atomically and returns its path. In a multi-process run (the ranks
    hold equal states) rank 0 writes it and every rank then waits at a
    barrier, so that none reads the directory before the file is in
    place (the multihost save of the JAX package, :22)."""
    path = os.path.join(ckpt_dir, f'step_{step:08d}.pt')
    if world()[0] == 0:
        _write(path, {'step': step, **payload})
    multihost_barrier(f'checkpoint {path}')
    return path


def _write(path: str, payload: dict) -> None:
    ckpt_dir = os.path.dirname(path)
    os.makedirs(ckpt_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.tmp', dir=ckpt_dir)
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(n for n in os.listdir(ckpt_dir) if _NAME.match(n))
    return os.path.join(ckpt_dir, names[-1]) if names else None


def restore_checkpoint(ckpt_dir: str, path: Optional[str] = None):
    """The payload dict of the latest (or the given) checkpoint, tensors on
    the CPU, or None when there is none."""
    path = path or latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    return torch.load(path, map_location='cpu', weights_only=True)
