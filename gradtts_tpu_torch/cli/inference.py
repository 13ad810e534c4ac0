"""Synthesis CLI: text file -> mel files + RTF print, on the GPU.

Counterpart of gradtts_tpu/cli/inference.py (same flags, temperature 1.5,
per-text bucketing, RTF = t * sr / (frames * hop)). Runs on ``cuda`` unless
``--cpu`` is given, and fails when no GPU is present without it. Writes
``mel_{i}.npy`` ([frames, n_feats]) for the i-th text.

Usage:
  python -m gradtts_tpu_torch.cli.inference -f texts.txt -c ckpt.pt -o out \
      [--preset ljspeech] [-t 10] [--bf16] [--cpu]
"""

import argparse
import ast
import os
import time

import numpy as np
import torch

from gradtts_tpu_torch.config import (bucket_length, fix_len_compatibility,
                                      get_config)
from gradtts_tpu_torch.models.tts import (GradTTS, set_compute_dtype,
                                          synthesize)
from gradtts_tpu_torch.text import CMUDict, intersperse_blank, text_to_sequence
from gradtts_tpu_torch.text.symbols import symbols
from gradtts_tpu_torch.utils.convert import load_checkpoint

def parse_overrides(pairs) -> dict:
    """``key=value`` strings -> {key: value}, values read as Python
    literals where they parse."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split('=', 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    return overrides


def resolve_device(cpu: bool) -> torch.device:
    """``cuda`` unless the CPU is asked for; raises without a GPU."""
    if cpu:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass --cpu to run '
                           'on the CPU')
    return torch.device('cuda')


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-f', '--file', required=True,
                        help='path to a file with texts to synthesize')
    parser.add_argument('-c', '--checkpoint', required=True,
                        help='Grad-TTS checkpoint (reference .pt, a trainer '
                             'ckpt/step_*.pt, or .npz)')
    parser.add_argument('-t', '--timesteps', type=int, default=10)
    parser.add_argument('-s', '--speaker_id', type=int, default=None)
    parser.add_argument('-o', '--output', required=True)
    parser.add_argument('--preset', default='ljspeech')
    parser.add_argument('--temperature', type=float, default=1.5)
    parser.add_argument('--length-scale', type=float, default=1.0)
    parser.add_argument('--stoc', action='store_true')
    parser.add_argument('--sampler', default='euler', choices=('euler', 'dpm'))
    parser.add_argument('--vocoder', default=None)
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the GPU')
    parser.add_argument('--bf16', action='store_true',
                        help='bfloat16 compute in the encoder trunk and the '
                             'U-Net (float32 norms and output heads)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--set', nargs='*', default=[],
                        help='dotted config overrides (must match training)')
    args = parser.parse_args(argv)
    # flags of the JAX CLI whose paths are not ported yet
    for asked, what in [
            (args.speaker_id is not None, '-s (multi-speaker presets)'),
            (args.stoc, '--stoc (the SDE sampler branch)'),
            (args.sampler != 'euler', '--sampler dpm'),
            (args.vocoder is not None, '--vocoder (HiFi-GAN)')]:
        if asked:
            parser.error(f'{what} is not ported to gradtts_tpu_torch yet; '
                         'use python -m gradtts_tpu.cli.inference')
    device = resolve_device(args.cpu)

    cfg = get_config(args.preset, **parse_overrides(args.set))

    print('Initializing Grad-TTS...')
    model = GradTTS.from_config(cfg)
    model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
    print(f'Number of parameters: '
          f'{sum(p.numel() for p in model.parameters())}')
    model = model.to(device).eval()
    if args.bf16:
        set_compute_dtype(model, torch.bfloat16)

    with open(args.file, encoding='utf-8') as f:
        texts = [line.strip() for line in f if line.strip()]
    cmu = CMUDict(cfg.data.cmudict_path)
    os.makedirs(args.output, exist_ok=True)
    sr, hop = cfg.data.sample_rate, cfg.data.hop_length
    generator = torch.Generator(device=device).manual_seed(args.seed)

    for i, text in enumerate(texts):
        ids = intersperse_blank(text_to_sequence(text, dictionary=cmu),
                                len(symbols))
        x = torch.zeros((1, bucket_length(len(ids), cfg.data.x_buckets)),
                        dtype=torch.long)
        x[0, :len(ids)] = torch.tensor(ids)
        y_budget = fix_len_compatibility(
            bucket_length(10 * len(ids), cfg.data.y_buckets))
        t0 = time.perf_counter()
        res = synthesize(model, x.to(device),
                         torch.tensor([len(ids)], device=device),
                         n_timesteps=args.timesteps, y_max_length=y_budget,
                         temperature=args.temperature,
                         length_scale=args.length_scale, generator=generator)
        frames = int(res.y_lengths[0])
        mel = res.decoder_outputs[0, :frames].cpu().numpy()
        dt = time.perf_counter() - t0
        print(f'Synthesizing {i} text... Grad-TTS RTF: '
              f'{dt * sr / (frames * hop)}')
        np.save(os.path.join(args.output, f'mel_{i}.npy'), mel)
    print(f'Done. Check out the `{args.output}` folder for samples.')


if __name__ == '__main__':
    main()
