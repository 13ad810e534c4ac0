"""Directory-vs-directory MCD evaluation with a process pool.

Behavioral parity target: upstream eval/evaluate_mcd.py:121-328 —
same pairing rule (ground-truth basename contained in the generated
path), same mcep settings table per sampling rate, same Kaldi-style
``utt2mcd`` + ``mcd_avg_result.txt`` outputs, same nj-way
multiprocessing fan-out.

The port's own copy of gradtts_tpu/eval/mcd_tool.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

import logging
import multiprocessing as mp
import os
from typing import Dict, List, Optional

import numpy as np

from gradtts_tpu_torch.data.dataset import load_wav
from gradtts_tpu_torch.eval.dsp import (
    basename_noext, best_mcep_params, find_files, resample,
)
from gradtts_tpu_torch.eval.dtw import align
from gradtts_tpu_torch.eval.mcep import mcep_from_waveform
from gradtts_tpu_torch.eval.metrics import MCD_CONST

log = logging.getLogger('gradtts_tpu_torch.eval.mcd')


def _resolve_files(dir_or_scp: str) -> List[str]:
    """Directory -> recursive wav list; file -> Kaldi wav.scp
    (``utt path`` lines; command pipes unsupported, parity:
    evaluate_mcd.py:265-275)."""
    if os.path.isdir(dir_or_scp):
        return sorted(find_files(dir_or_scp))
    with open(dir_or_scp) as f:
        files = [line.strip().split(None, 1)[1] for line in f if line.strip()]
    if files and files[0].endswith('|'):
        raise ValueError('Not supported wav.scp format.')
    return files


def mcd_for_pair(gen_path: str, gt_path: str, n_fft=1024, n_shift=256,
                 mcep_dim: Optional[int] = None,
                 mcep_alpha: Optional[float] = None,
                 backend: str = 'yin') -> float:
    """MCD for one wav pair.  ``backend='yin'`` uses the fast built-in
    warped cepstrum; ``'world'`` uses SPTK mel-cepstral analysis — the
    reference tool's extractor (evaluate_mcd.py:48-100, pysptk.mcep) —
    through pysptk when installed, else eval/worldnp.py."""
    gen_x, gen_fs = load_wav(gen_path)
    gt_x, gt_fs = load_wav(gt_path)
    fs = gen_fs
    if gt_fs != gen_fs:
        gt_x = resample(gt_x, gt_fs, gen_fs)
    if mcep_dim is None or mcep_alpha is None:
        mcep_dim, mcep_alpha = best_mcep_params(fs)
    if backend == 'world':
        from gradtts_tpu_torch.eval.world import sptk_mcep
        gen_mcep = sptk_mcep(gen_x, fs, n_fft, n_shift, mcep_dim,
                             mcep_alpha)
        gt_mcep = sptk_mcep(gt_x, fs, n_fft, n_shift, mcep_dim, mcep_alpha)
    elif backend == 'yin':
        gen_mcep = mcep_from_waveform(gen_x, fs, n_fft, n_shift, mcep_dim,
                                      mcep_alpha)
        gt_mcep = mcep_from_waveform(gt_x, fs, n_fft, n_shift, mcep_dim,
                                     mcep_alpha)
    else:
        raise ValueError(f'unknown MCD DSP backend {backend!r}')
    g, t = align(gen_mcep, gt_mcep)
    diff2sum = np.sum((g - t) ** 2, axis=1)
    return float(np.mean(MCD_CONST * np.sqrt(2.0 * diff2sum)))


def _worker(file_list, gt_files, kwargs, mcd_dict):
    for gen_path in file_list:
        matches = [p for p in gt_files if basename_noext(p) in gen_path]
        assert len(matches) == 1, \
            f'{gen_path}: expected exactly one ground-truth match, got {matches}'
        gt_path = matches[0]
        value = mcd_for_pair(gen_path, gt_path, **kwargs)
        log.info('%s %.4f', basename_noext(gt_path), value)
        mcd_dict[basename_noext(gt_path)] = value


def evaluate_mcd_dirs(gen_dir_or_scp: str, gt_dir_or_scp: str,
                      outdir: Optional[str] = None, nj: int = 16,
                      n_fft: int = 1024, n_shift: int = 256,
                      mcep_dim: Optional[int] = None,
                      mcep_alpha: Optional[float] = None,
                      backend: str = 'yin') -> Dict[str, float]:
    """Returns {utt_id: mcd}; writes utt2mcd + mcd_avg_result.txt."""
    gen_files = _resolve_files(gen_dir_or_scp)
    gt_files = _resolve_files(gt_dir_or_scp)
    if len(gen_files) == 0:
        raise FileNotFoundError('Not found any generated audio files.')
    if len(gen_files) > len(gt_files):
        raise ValueError(
            f'#groundtruth files are less than #generated files '
            f'(#gen={len(gen_files)} vs. #gt={len(gt_files)}).')

    kwargs = dict(n_fft=n_fft, n_shift=n_shift, mcep_dim=mcep_dim,
                  mcep_alpha=mcep_alpha, backend=backend)
    chunks = [c.tolist() for c in np.array_split(gen_files, nj) if len(c)]

    if nj <= 1 or len(gen_files) == 1:
        mcd_dict: Dict[str, float] = {}
        for chunk in chunks:
            _worker(chunk, gt_files, kwargs, mcd_dict)
    else:
        with mp.Manager() as manager:
            shared = manager.dict()
            procs = [mp.Process(target=_worker,
                                args=(chunk, gt_files, kwargs, shared))
                     for chunk in chunks]
            for p in procs:
                p.start()
            for p in procs:
                p.join()
            mcd_dict = dict(shared)

    values = np.array(list(mcd_dict.values()))
    mean_mcd, std_mcd = float(values.mean()), float(values.std())
    log.info('Average: %.4f +- %.4f', mean_mcd, std_mcd)

    if outdir is None:
        outdir = gen_dir_or_scp if os.path.isdir(gen_dir_or_scp) \
            else os.path.dirname(gen_dir_or_scp)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, 'utt2mcd'), 'w') as f:
        for utt_id in sorted(mcd_dict):
            f.write(f'{utt_id} {mcd_dict[utt_id]:.4f}\n')
    with open(os.path.join(outdir, 'mcd_avg_result.txt'), 'w') as f:
        f.write(f'#utterances: {len(gen_files)}\n')
        f.write(f'Average: {mean_mcd:.4f} ± {std_mcd:.4f}')
    return mcd_dict
