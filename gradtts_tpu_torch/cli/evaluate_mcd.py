"""Standalone dir-vs-dir MCD CLI, host-side numpy.

Counterpart of gradtts_tpu/cli/evaluate_mcd.py (the same positional
arguments and flags) and of upstream eval/evaluate_mcd.py:240-328: each
generated wav is paired with the ground-truth wav whose name it contains,
``--nj`` worker processes score the pairs, and ``utt2mcd`` and
``mcd_avg_result.txt`` are written to ``--outdir`` (default: the
generated directory).

  python -m gradtts_tpu_torch.cli.evaluate_mcd GEN_DIR GT_DIR [--outdir DIR]
      [--mcep_dim D] [--mcep_alpha A] [--n_fft 1024] [--n_shift 256]
      [--nj 16] [--verbose 1] [--dsp-backend yin|world]
"""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Evaluate Mel-cepstrum distortion.')
    parser.add_argument('gen_wavdir_or_wavscp')
    parser.add_argument('gt_wavdir_or_wavscp')
    parser.add_argument('--outdir', default=None)
    parser.add_argument('--mcep_dim', default=None, type=int)
    parser.add_argument('--mcep_alpha', default=None, type=float)
    parser.add_argument('--n_fft', default=1024, type=int)
    parser.add_argument('--n_shift', default=256, type=int)
    parser.add_argument('--nj', default=16, type=int)
    parser.add_argument('--verbose', default=1, type=int)
    parser.add_argument('--dsp-backend', default='yin',
                        choices=['yin', 'world'],
                        help="'world' = SPTK mel-cepstral analysis (the "
                             'reference tool uses pysptk.mcep; falls back '
                             'to the built-in numpy implementation when '
                             "pysptk is absent); 'yin' = fast built-in "
                             'warped cepstrum')
    args = parser.parse_args(argv)

    level = (logging.DEBUG if args.verbose > 1
             else logging.INFO if args.verbose > 0 else logging.WARN)
    logging.basicConfig(
        level=level,
        format='%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s')

    from gradtts_tpu_torch.eval import evaluate_mcd_dirs
    mcd_dict = evaluate_mcd_dirs(
        args.gen_wavdir_or_wavscp, args.gt_wavdir_or_wavscp,
        outdir=args.outdir, nj=args.nj, n_fft=args.n_fft,
        n_shift=args.n_shift, mcep_dim=args.mcep_dim,
        mcep_alpha=args.mcep_alpha, backend=args.dsp_backend)
    import numpy as np
    values = np.array(list(mcd_dict.values()))
    print(f'Average: {values.mean():.4f} ± {values.std():.4f}')


if __name__ == '__main__':
    main()
