"""n-best rescoring CLI: score / compile / rescore / sweep / results.

Counterpart of gradtts_tpu/cli/nbest.py (same subcommands and flags), which
replaces the reference's hydra entry scripts (n_best_list_experiment.py,
get_score_parallel.py + submit_score.sh, compile_scores.py,
n_best_list_evaluate.py, analyse_scores.py and its optuna sweep):

  python -m gradtts_tpu_torch.cli.nbest score --n-best L.pkl \
      --checkpoint CKPT --filelist dev.txt --out-dir scores/e330 \
      [--preset ljspeech] [-N 100] [--n-euler 10] [--shard k/K] \
      [--batch-size 8] [--cpu] [--set key=value ...]
  python -m gradtts_tpu_torch.cli.nbest compile --directory scores/e330 \
      -I 507 -N 100 --out diffusion_scores/e330.npy
  python -m gradtts_tpu_torch.cli.nbest rescore --n-best L.pkl \
      --diff-scores diffusion_scores/e330.npy -n 10 \
      [--weight diffusion_score=-0.001 ...] [--out result.yaml]
  python -m gradtts_tpu_torch.cli.nbest sweep --n-best L.pkl \
      --diff-scores e330.npy -n 10 --trials 500 [--out result.yaml]

``score`` runs on the GPU unless ``--cpu`` is given, and fails without a
GPU otherwise. Its default preset is the JAX CLI's ``tedlium-spk``, whose
filelist lines are ``wav|text|speaker_id`` (any preset with ``n_spks > 1``
reads them so). ``--out`` (YAML) and ``results`` (pandas) import their
libraries where they are used.
"""

import argparse
import json
import os
import time


def _add_common(p):
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU instead of the GPU')
    p.add_argument('--seed', type=int, default=1)


def cmd_score(args):
    from gradtts_tpu_torch.cli.inference import (parse_overrides,
                                                 resolve_device)
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.data.dataset import (TextMelDataset,
                                                TextMelSpeakerDataset)
    from gradtts_tpu_torch.models.tts import GradTTS
    from gradtts_tpu_torch.nbest import NBestList, NBestScorer, score_n_best
    from gradtts_tpu_torch.utils.convert import load_checkpoint

    device = resolve_device(args.cpu)
    cfg = get_config(args.preset, **parse_overrides(args.set))
    model = GradTTS.from_config(cfg)
    model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
    model = model.to(device).eval()
    d = cfg.data
    ds_cls = TextMelSpeakerDataset if cfg.n_spks > 1 else TextMelDataset
    dataset = ds_cls(args.filelist, d.cmudict_path, add_blank=d.add_blank,
                     n_fft=d.n_fft, n_mels=d.n_feats,
                     sample_rate=d.sample_rate, hop_length=d.hop_length,
                     win_length=d.win_length, f_min=d.f_min, f_max=d.f_max,
                     shuffle=False)
    n_best = NBestList.from_pickle(args.n_best)
    shard = None
    if args.shard:
        k, K = args.shard.split('/')
        shard = (int(k), int(K))
    scorer = NBestScorer(model, n_euler=args.n_euler,
                         batch_size=args.batch_size,
                         x_buckets=d.x_buckets, y_buckets=d.y_buckets)
    t0 = time.perf_counter()

    def progress(done, total):
        print(f'scored {done}/{total} pairs '
              f'({time.perf_counter() - t0:.1f} s)', flush=True)

    n = score_n_best(scorer, dataset, n_best, args.N, args.out_dir,
                     name=args.name, seed=args.seed, shard=shard,
                     resume=not args.no_resume, progress=progress)
    print(f'scored {n} (utterance, hypothesis) pairs -> {args.out_dir}')


def cmd_compile(args):
    from gradtts_tpu_torch.nbest import compile_scores
    scores = compile_scores(args.directory, args.I, args.N, args.out)
    print(f'compiled [{args.I}, {args.N}] score matrix '
          f'(nonzero {int((scores != 0).sum())}) -> {args.out}')


def _parse_weights(pairs):
    from gradtts_tpu_torch.nbest import SCORE_NAMES
    weights = {name: 0.0 for name in SCORE_NAMES}
    for kv in pairs or []:
        k, v = kv.split('=', 1)
        if k not in weights:
            raise SystemExit(f'unknown score name {k!r}; one of {SCORE_NAMES}')
        weights[k] = float(v)
    return weights


def _rescoring_setup(args):
    import numpy as np
    from gradtts_tpu_torch.nbest import NBestList
    n_best = NBestList.from_pickle(args.n_best)
    if args.diff_scores:
        diff = np.load(args.diff_scores).reshape((len(n_best), -1))
        n_best.set_diffusion_scores(diff[:, :args.n], args.n)
    return n_best


def _dump_result(out, path):
    import yaml
    with open(path, 'w') as f:
        yaml.dump(out, f)
    print(f'wrote {path}')


def cmd_rescore(args):
    from gradtts_tpu_torch.nbest import rescoring_wer
    n_best = _rescoring_setup(args)
    weights = _parse_weights(args.weight)
    out = dict(weights)
    out['wer'] = float(rescoring_wer(n_best, weights, args.n))
    if args.diff_scores:
        out['diff_config'] = os.path.basename(args.diff_scores).rsplit(
            '.', 1)[0]
    print(json.dumps(out, indent=2))
    if args.out:
        _dump_result(out, args.out)


def cmd_sweep(args):
    from gradtts_tpu_torch.nbest import (DEFAULT_SPACE, refine,
                                         rescoring_wer, tpe_minimize)
    n_best = _rescoring_setup(args)
    features = n_best.feature_matrix(args.n)

    def objective(weights):
        return rescoring_wer(n_best, weights, args.n, features=features)

    res = tpe_minimize(objective, DEFAULT_SPACE, n_trials=args.trials,
                       seed=args.seed)
    best, best_wer = res.best_params, res.best_value
    if args.refine:
        best, best_wer = refine(objective, best, DEFAULT_SPACE)
    out = {k: float(v) for k, v in best.items()}
    out['wer'] = float(best_wer)
    print(json.dumps(out, indent=2))
    if args.out:
        _dump_result(out, args.out)


def cmd_results(args):
    """Collects the result.yaml files of sweep/rescore runs into one CSV
    sorted by WER (the reference's compile_results.py)."""
    import pandas as pd
    import yaml
    rows = []
    for root, _dirs, files in os.walk(args.directory):
        for filename in files:
            if filename.endswith('result.yaml'):
                with open(os.path.join(root, filename)) as f:
                    data = yaml.safe_load(f)
                if isinstance(data, dict):
                    rows.append(data)
    df = pd.DataFrame(rows).sort_values('wer')
    df.to_csv(args.out)
    print(f'{len(rows)} results -> {args.out}')
    if len(rows):
        print(df.head(5).to_string())


def main(argv=None):
    parser = argparse.ArgumentParser(prog='gradtts_tpu_torch.cli.nbest')
    sub = parser.add_subparsers(dest='cmd', required=True)

    p = sub.add_parser('score', help='diffusion-likelihood scoring')
    p.add_argument('--n-best', required=True)
    p.add_argument('--checkpoint', required=True,
                   help='reference .pt, a trainer ckpt/step_*.pt, or .npz')
    p.add_argument('--filelist', required=True)
    p.add_argument('--out-dir', required=True)
    p.add_argument('--preset', default='tedlium-spk')
    p.add_argument('-N', type=int, default=100)
    p.add_argument('--n-euler', type=int, default=10)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--name', default='scores')
    p.add_argument('--shard', default=None, help='k/K utterance sharding')
    p.add_argument('--no-resume', action='store_true')
    p.add_argument('--set', nargs='*', default=[],
                   help='dotted config overrides (must match training)')
    _add_common(p)
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser('compile', help='score shards -> [I,N] .npy')
    p.add_argument('--directory', required=True)
    p.add_argument('-I', type=int, required=True)
    p.add_argument('-N', type=int, required=True)
    p.add_argument('--out', required=True)
    p.set_defaults(fn=cmd_compile)

    p = sub.add_parser('rescore', help='linear rescoring WER')
    p.add_argument('--n-best', required=True)
    p.add_argument('--diff-scores', default=None)
    p.add_argument('-n', type=int, default=10)
    p.add_argument('--weight', nargs='*', default=[],
                   help='name=value pairs; unset names weigh 0')
    p.add_argument('--out', default=None)
    _add_common(p)
    p.set_defaults(fn=cmd_rescore)

    p = sub.add_parser('sweep', help='TPE weight search')
    p.add_argument('--n-best', required=True)
    p.add_argument('--diff-scores', default=None)
    p.add_argument('-n', type=int, default=10)
    p.add_argument('--trials', type=int, default=500)
    p.add_argument('--refine', action='store_true',
                   help='Nelder-Mead polish of the best TPE point')
    p.add_argument('--out', default=None)
    _add_common(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser('results', help='collect result.yaml files -> CSV')
    p.add_argument('--directory', required=True)
    p.add_argument('--out', default='results.csv')
    p.set_defaults(fn=cmd_results)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()
