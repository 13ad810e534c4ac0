"""Counts the ATen operations that one call of each path of the
PyTorch/CUDA port dispatches, in one or more checkouts of the repo: the
host's share of the work, which the acoustic paths are bound by.

    python3 tools/port_ops.py CHECKOUT [CHECKOUT ...]

Runs on the CPU at a tiny size (ljspeech text and mel widths, a 2-layer
32-channel encoder and a 16-channel U-Net, B 2, 64 frames, 4 steps, ReZero
gains 0.5): a 4-step Euler synthesis, a `compute_loss` with its backward,
and a 4-step `score_batch`. Each checkout runs in a process of its own.
Prints one JSON line per checkout: the op count per path, which does not
depend on the device or the widths, and the CPU's median ms of 10 calls
(a CPU time, not the GPU's).
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.tts import GradTTS, compute_loss, synthesize
from gradtts_tpu_torch.nbest.scoring import score_batch

torch.set_num_threads(1)
cfg = get_config('ljspeech')
torch.manual_seed(0)
model = GradTTS(cfg.n_vocab, 32, 64, 16, 2, 2, 3, 4, 80, 16).eval()
with torch.no_grad():
    for name, p in model.named_parameters():
        if name.endswith('.g'):
            p.fill_(0.5)
x = torch.randint(1, cfg.n_vocab, (2, 16))
x_lengths = torch.tensor([16, 12])
y = torch.randn(2, 64, 80)
y_lengths = torch.tensor([64, 48])
noise, eps = torch.randn(2, 64, 80), torch.randn(2, 64, 80)


class Count(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        Count.n += 1
        return func(*args, **(kwargs or {}))


def train():
    loss = compute_loss(model, x, x_lengths, y, y_lengths, out_size=32,
                        generator=torch.Generator().manual_seed(0))
    (loss.dur_loss + loss.prior_loss + loss.diff_loss).backward()


paths = {
    'synth': lambda: synthesize(model, x, x_lengths, 4, 64, noise=noise),
    'train': train,
    'likelihood': lambda: score_batch(model, x, x_lengths, y, y_lengths,
                                      n_euler=4, epsilon=eps)}
out = {}
for name, fn in paths.items():
    fn()
    Count.n = 0
    with Count():
        fn()
    out[name + '_ops'] = Count.n
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    out[name + '_cpu_ms'] = statistics.median(times) * 1e3
print(json.dumps(out))
'''


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, '-c', CHILD],
                              cwd=os.path.abspath(tree), capture_output=True,
                              text=True, timeout=1200,
                              env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
        if proc.returncode != 0:
            raise SystemExit(f'{tree}: exited {proc.returncode}\n'
                             f'{proc.stderr[-3000:]}')
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({'checkout': tree, **line}), flush=True)


if __name__ == '__main__':
    main()
