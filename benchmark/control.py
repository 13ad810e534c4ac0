"""The control of the output check, and the planted faults: the plain
reference put in the program's place, then held to the same check as a
run of the program.

    python3 -m benchmark.control --workload NAME \
        --what program|control|half_batch --seeds S [S ...]

``program`` runs the cell's program as a run of the harness does, with
the shortest window (the calls the check samples), for the readings the
limits are set from: many seeds in one process. ``control`` computes in the nearest precision below the configuration's:
fp8 operands (``reference/lowp.py``) for a bf16 configuration, TF32 for an
f32 one. ``half_batch`` (training) steps on the first half of each
batch's rows, the losses the mean over them. Prints one JSON line a seed
with the numbers the check compares, their limits and ``correct``, which
a sound control or fault leaves false. Runs on the GPU; the benchmark's
own runs never run it.
"""

import argparse
import json
import sys

import torch

from benchmark.drives import DRIVES, Generate, Score, Train
from benchmark.reference import gradtts as ref
from benchmark.run import load_json, load_manifest, run_cell
from benchmark.traffic import load_traffic


def _low_precision(model, cfg, on):
    if cfg['precision'] == 'bfloat16':
        ref.set_precision(model, 'fp8' if on else None)
    else:
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on


def _fill(drive, model, what):
    """Puts the reference's outputs where the check reads the program's."""
    tr = drive.tr
    if isinstance(drive, Train):
        batches = drive.inputs[:drive.checked_steps]
        if what == 'half_batch':
            batches = [{k: v[:len(v) // 2] for k, v in b.items()}
                       for b in batches]
        drive.losses, drive.first_grad, drive.change, drive.encoded = \
            ref.train_steps(model, batches, drive.draw_seed, drive.device,
                            drive.checked_steps)
        return
    if what != 'control':
        raise ValueError(f'{what!r} is a training fault')
    with torch.no_grad():
        if isinstance(drive, Score):
            c = drive.inputs[drive.keep]
            drive.kept = (c, ref.likelihood(
                model, c['x'], c['x_lengths'], c['y'], c['y_lengths'],
                c['epsilon'], tr['euler_steps'], c.get('spk')))
            return
        for k in drive.keep:
            b = drive.inputs[k % len(drive.inputs)]
            res = ref.synthesize(model, b['x'], b['x_lengths'],
                                 tr['euler_steps'], tr['frame_budget'],
                                 tr['temperature'], b['noise'], b.get('spk'))
            wav = None
            if isinstance(drive, Generate):
                voc = drive.ref_vocoder.to(drive.device)
                voc.load_state_dict(drive.vocoder_state(), strict=True)
                wav = voc(res.decoder_outputs)
            drive.kept[k] = (b, res, wav)


def control_run(workload, seed, what='control', device='cuda', sizes=None,
                traffic_sizes=None, manifest=None):
    """{'compared': {name: {'value', 'limit'}}, 'correct'} of the control
    (or the fault ``what``) on ``seed``."""
    manifest = manifest or load_manifest()
    cell = next(w for w in manifest['workloads'] if w['name'] == workload)
    cfg = dict(load_json('configs', f"{cell['config']}.json"), **(sizes or {}))
    tr = dict(load_traffic(cell['traffic']), **(traffic_sizes or {}))
    limits = load_json('limits', f'{workload}.json')
    drive = DRIVES[tr['drive']](cfg, tr, seed, device)
    drive.prepare()
    model = drive.reference_model()
    model.train(isinstance(drive, Train))
    _low_precision(model, cfg, what == 'control')
    try:
        _fill(drive, model, what)
    finally:
        _low_precision(model, cfg, False)
    numbers = drive.check()
    compared = {k: {'value': v, 'limit': limits.get(k)}
                for k, v in numbers.items()}
    return {'seed': seed, 'what': what, 'compared': compared,
            'correct': all(c['limit'] is not None and c['value'] <= c['limit']
                           for c in compared.values()),
            'diagnostics': drive.diagnostics}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--what', choices=('program', 'control', 'half_batch'),
                   default='control')
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
