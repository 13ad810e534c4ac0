"""Likelihood smoke check: bits per dimension of real speech under a
checkpoint, on the GPU.

Counterpart of gradtts_tpu/cli/playground.py: the first ``--n-utterances``
utterances of a filelist (``wav|text``, or ``wav|text|speaker_id`` for a
preset with a speaker table) are scored under their true transcription
with the probability-flow likelihood (``NBestScorer.score_items``, one
utterance a batch), ``--repeats`` times with fresh Hutchinson probes from
one generator seeded with ``--seed``, and one line an utterance prints the
mean score, its spread and the bits per dimension, mean score / (frames x
n_feats) / ln 2. ``--n-euler 0`` selects the adaptive Dormand-Prince
solver. Runs on ``cuda`` unless ``--cpu`` is given, and fails when no GPU
is present without it.

Usage:
  python -m gradtts_tpu_torch.cli.playground --checkpoint CKPT \
      --filelist F [--preset ljspeech] [--n-utterances 3] [--n-euler 10] \
      [--repeats 3] [--cpu]
"""

import argparse

import numpy as np
import torch

from gradtts_tpu_torch.cli.inference import resolve_device
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.data.dataset import (TextMelDataset,
                                            TextMelSpeakerDataset)
from gradtts_tpu_torch.models.tts import GradTTS
from gradtts_tpu_torch.nbest.scoring import NBestScorer
from gradtts_tpu_torch.utils.convert import load_checkpoint


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--checkpoint', required=True)
    parser.add_argument('--filelist', required=True)
    parser.add_argument('--preset', default='ljspeech')
    parser.add_argument('--n-utterances', type=int, default=3)
    parser.add_argument('--n-euler', type=int, default=10,
                        help='0 selects the adaptive Dormand-Prince solver')
    parser.add_argument('--repeats', type=int, default=3,
                        help='Hutchinson probes averaged per utterance')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the GPU')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    cfg = get_config(args.preset)
    device = resolve_device(args.cpu)

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

    scorer = NBestScorer(model, n_euler=args.n_euler, batch_size=1)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    print('Calculating likelihood')
    for i in range(min(args.n_utterances, len(dataset))):
        item = dataset[i]
        scores = [float(scorer.score_items([item], generator)[0])
                  for _ in range(args.repeats)]
        n_frames = item['y'].shape[0]
        # bits-per-dim normalization of the negative log-likelihood
        bpd = np.mean(scores) / (n_frames * d.n_feats) / np.log(2)
        print(f'utt {i}: score={np.mean(scores):.1f} '
              f'(std {np.std(scores):.1f} over {args.repeats} probes), '
              f'{bpd:.3f} bpd')
    print("That's a nice likelihood!")


if __name__ == '__main__':
    main()
