"""The control of the output check, and the planted faults: the plain
reference put in the program's place, then held to the same check as a
run of the program.

    python3 -m benchmark.control --workload NAME \
        --what program|control|<fault> --seeds S [S ...]

``program`` runs the cell's program as a run of the harness does, with
the shortest window (the calls the check samples), for the readings the
limits are set from: many seeds in one process. ``control`` computes in
the nearest precision below the configuration's, as the cell's drive
switches it (``Drive.low_precision``: for Grad-TTS fp8 operands,
``reference/lowp.py``, for a bf16 configuration and TF32 for an f32 one).
A fault is one of the drive's ``faults`` (the ``train`` drive's
``half_batch`` steps on the first half of each batch's rows, the losses
the mean over them). Prints one JSON line a seed with the numbers the
check compares, their limits and ``correct``, which a sound control or
fault leaves false. Runs on the GPU; the benchmark's own runs never run
it.
"""

import argparse
import json
import sys

import torch

from benchmark import drives
from benchmark.run import judge, load_cell, run_cell


def control_run(workload, seed, what='control', device='cuda', sizes=None,
                traffic_sizes=None, manifest=None):
    """{'compared': {name: {'value', 'limit'}}, 'correct'} of the control
    (or the fault ``what``) on ``seed``."""
    _, cfg, tr, limits = load_cell(workload, sizes, traffic_sizes, manifest)
    drive = drives.load(tr['drive'])(cfg, tr, seed, device)
    if what != 'control' and what not in drive.faults:
        raise ValueError(f'{what!r} is no fault of the {tr["drive"]!r} '
                         f'drive (its faults: {drive.faults})')
    drive.prepare()
    model = drive.reference_model().train(drive.trains)
    drive.low_precision(model, what == 'control')
    try:
        drive.fill_from_reference(model, what)
    finally:
        drive.low_precision(model, False)
    compared, correct = judge(drive.check(), limits)
    return {'seed': seed, 'what': what, 'compared': compared,
            'correct': correct, 'diagnostics': drive.diagnostics}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--what', default='control',
                   help="'program', 'control' or one of the drive's faults")
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('benchmark.control: no CUDA device', file=sys.stderr)
        return 2
    for seed in args.seeds:
        if args.what == 'program':
            res = run_cell(args.workload, seed, 0.0)
            res = {'seed': seed, 'what': 'program', **{
                k: res[k] for k in ('compared', 'correct', 'attempted',
                                    'metrics', 'diagnostics')}}
        else:
            res = control_run(args.workload, seed, args.what)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
