"""Two checkouts of the PyTorch/CUDA port against each other on one GPU, in
turns: synthesis audio-s/s and device-busy ms, the train step's time and
device-busy ms, the likelihood call's time and device-busy ms, and the
device ms of K1, K2-K7 and MAS on the paths that launch them.

    python3 tools/port_turns.py PARENT_DIR CHANGE_DIR [--order pccp]

Each turn is a fresh process in one checkout that builds that checkout's
kernels (its ``chip_smoke.phase_build``), then runs its
``chip_smoke.phase_synth`` (bf16 synthesis, B 8 x 768 frames, 10 steps),
its in-process train step (``phase_train_step``, or ``phase_train`` in a
checkout that predates it: B 16, 172-frame crops, bf16 compute) and
``chip_smoke.phase_likelihood`` (bf16 ``score_batch``, B 8 x 512 frames,
10 Euler steps) on the seeded ljspeech weights. ``--order`` names
the checkouts in turn (p: parent, c: change; default parent, change,
change, parent). Prints one JSON line per turn and a summary last. Needs a
GPU; the checkouts' build outputs land in their own ``build/``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r'''
import json, os, sys
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.tts import GradTTS
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
device = torch.device('cuda')
card = sys.argv[1]
cs.phase_build()
cs.phase_synth(device, card)
if hasattr(cs, 'phase_train_step'):
    cs.phase_train_step(device, card)
else:
    cs.phase_train(device, card)
os.makedirs(cs.WORK, exist_ok=True)
ckpt = os.path.join(cs.WORK, 'ljspeech_seeded.pt')
torch.save(cs.seeded_state_dict(GradTTS.from_config(get_config('ljspeech')),
                                 seed=0), ckpt)
cs.phase_likelihood(device, card, ckpt)
'''


def _turn(tree, card):
    """Runs CHILD in ``tree``; returns its synth, train and likelihood
    lines."""
    proc = subprocess.run([sys.executable, '-c', CHILD, card], cwd=tree,
                          capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise SystemExit(f'{tree}: exited {proc.returncode}\n'
                         f'{proc.stderr[-3000:]}')
    lines = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith('{'):
            d = json.loads(ln)
            lines[d.get('phase')] = d
    return lines['synth'], lines['train'], lines['likelihood']


def _ms(line, *kernels):
    """Device ms of the named hand kernels in a phase's profile (a kernel
    a checkout does not have counts 0)."""
    return sum(line['kernel_ms'].get(k, 0.0) for k in kernels)


K1 = ('gn_stats_kernel', 'gn_apply_kernel')
K4 = ('la_bwd1_kernel', 'la_bwd1_tc_kernel')
K5 = ('la_bwd2_kernel', 'la_bwd2_dx_kernel', 'la_bwd2_dw_kernel')
MAS = ('mas_kernel', 'mas_dp_kernel', 'mas_path_kernel')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('parent')
    ap.add_argument('change')
    ap.add_argument('--order', default='pccp')
    args = ap.parse_args()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    trees = {'p': os.path.abspath(args.parent),
             'c': os.path.abspath(args.change)}
    runs = {'p': [], 'c': []}
    for i, which in enumerate(args.order):
        synth, train, lik = _turn(trees[which], card)
        row = {'turn': i, 'tree': 'parent' if which == 'p' else 'change',
               'card': card,
               'synth_audio_s_per_s': synth['audio_s_per_s'],
               'synth_s_per_call': synth['seconds_per_call'],
               'synth_device_busy_ms': synth['device_busy_ms'],
               'synth_device_idle_share': synth['device_idle_share'],
               'synth_device_kernels': synth['device_kernels'],
               'synth_k1_ms': _ms(synth, *K1),
               'synth_k2_ms': synth['kernel_ms']['la_stats_kernel'],
               'synth_k3_ms': synth['kernel_ms']['la_apply_kernel'],
               'train_s_per_step': train['seconds_per_step'],
               'train_audio_s_trained_per_s': train['audio_s_trained_per_s'],
               'train_device_busy_ms': train['device_busy_ms'],
               'train_device_idle_share': train['device_idle_share'],
               'train_k1_ms': _ms(train, *K1),
               'train_k4_ms': _ms(train, *K4),
               'train_k5_ms': _ms(train, *K5),
               'train_mas_ms': _ms(train, *MAS),
               'lik_s_per_call': lik['seconds_per_call'],
               'lik_hypotheses_per_s': lik['hypotheses_per_s'],
               'lik_device_busy_ms': lik['device_busy_ms'],
               'lik_k1_ms': _ms(lik, *K1),
               'lik_k2_ms': lik['kernel_ms']['la_stats_kernel'],
               'lik_k3_ms': lik['kernel_ms']['la_apply_kernel'],
               'lik_k6_ms': lik['kernel_ms']['la_jvp_stats_kernel'],
               'lik_k7_ms': lik['kernel_ms']['la_jvp_apply_kernel'],
               'lik_mas_ms': _ms(lik, *MAS)}
        runs[which].append(row)
        print(json.dumps(row), flush=True)
    summary = {'card': card, 'order': args.order}
    for which, name in (('p', 'parent'), ('c', 'change')):
        for key in ('synth_audio_s_per_s', 'synth_device_busy_ms',
                    'synth_k1_ms', 'train_s_per_step',
                    'train_device_busy_ms', 'train_k4_ms', 'train_k5_ms',
                    'train_mas_ms', 'lik_s_per_call', 'lik_device_busy_ms',
                    'lik_k1_ms', 'lik_k6_ms', 'lik_k7_ms', 'lik_mas_ms'):
            vals = [r[key] for r in runs[which]]
            if vals:
                summary[f'{name}_{key}_median'] = statistics.median(vals)
    print(json.dumps(summary), flush=True)


if __name__ == '__main__':
    main()
