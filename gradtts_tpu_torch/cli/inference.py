"""Synthesis CLI: text file -> mel files (-> waveforms with HiFi-GAN) + RTF
print, on the GPU.

Counterpart of gradtts_tpu/cli/inference.py (same flags, temperature 1.5,
per-text bucketing, RTF = t * sr / (frames * hop)). Runs on ``cuda`` unless
``--cpu`` is given, and fails when no GPU is present without it; the
vocoder runs on the same device. Writes ``mel_{i}.npy`` ([frames,
n_feats]) for the i-th text and, with ``--vocoder``, ``sample_{i}.wav``
(int16 after a clip to [-1, 1], at the preset's sample rate).

``-s`` picks a speaker id of a multi-speaker preset (required there). A
reference ``.pt`` checkpoint of such a preset whose encoder reads the
speaker (the upstream wiring) is recognized and built so. ``--vocoder``
takes a reference HiFi-GAN ``.pt`` (its ``generator`` key) and
``--vocoder-config`` its JSON; without one the V1 config. Not ported: a
vocoder checkpoint directory of the JAX package (orbax).

Usage:
  python -m gradtts_tpu_torch.cli.inference -f texts.txt -c ckpt.pt -o out \
      [--preset ljspeech] [-t 10] [-s SPK] [--stoc] [--sampler dpm] \
      [--vocoder hifigan.pt [--vocoder-config cfg.json]] [--bf16] [--cpu]
"""

import argparse
import ast
import dataclasses
import os
import time

import numpy as np
import torch
from scipy.io import wavfile

from gradtts_tpu_torch.config import (bucket_length, fix_len_compatibility,
                                      get_config)
from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from gradtts_tpu_torch.models.tts import (GradTTS, set_compute_dtype,
                                          synthesize)
from gradtts_tpu_torch.text import CMUDict, intersperse_blank, text_to_sequence
from gradtts_tpu_torch.text.symbols import symbols
from gradtts_tpu_torch.utils.convert import (detect_encoder_speaker,
                                             load_checkpoint,
                                             load_hifigan_state_dict)

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
    parser.add_argument('--vocoder', default=None,
                        help='HiFi-GAN checkpoint (reference .pt with a '
                             '"generator" key); mels only if unset')
    parser.add_argument('--vocoder-config', default=None,
                        help='HiFi-GAN config JSON (default: V1)')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the GPU')
    parser.add_argument('--bf16', action='store_true',
                        help='bfloat16 compute in the encoder trunk, the '
                             'U-Net and the vocoder (float32 parameters, '
                             'norms and output heads)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--set', nargs='*', default=[],
                        help='dotted config overrides (must match training)')
    args = parser.parse_args(argv)
    if args.vocoder and os.path.isdir(args.vocoder):
        parser.error('a vocoder checkpoint directory (orbax) is not ported '
                     'to gradtts_tpu_torch yet; pass a reference .pt')
    cfg = get_config(args.preset, **parse_overrides(args.set))
    if args.speaker_id is not None and cfg.n_spks <= 1:
        parser.error(f'-s: preset {cfg.name!r} is not multispeaker')
    if args.speaker_id is None and cfg.n_spks > 1:
        parser.error(f'preset {cfg.name!r} has {cfg.n_spks} speakers: pass '
                     '-s SPEAKER_ID')
    device = resolve_device(args.cpu)

    print('Initializing Grad-TTS...')
    state_dict = load_checkpoint(args.checkpoint)
    # upstream multi-speaker checkpoints feed the speaker to the encoder
    if args.checkpoint.endswith(('.pt', '.pth')) and cfg.n_spks > 1 \
            and detect_encoder_speaker(state_dict,
                                       cfg.encoder.n_enc_channels):
        print('Detected upstream encoder-side speaker wiring')
        cfg = dataclasses.replace(cfg, encoder_speaker=True)
    model = GradTTS.from_config(cfg)
    model.load_state_dict(state_dict, strict=True)
    print(f'Number of parameters: '
          f'{sum(p.numel() for p in model.parameters())}')
    model = model.to(device).eval()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    set_compute_dtype(model, dtype)

    vocoder = None
    if args.vocoder:
        print('Initializing HiFi-GAN...')
        vcfg = HiFiGANConfig.from_json(args.vocoder_config) \
            if args.vocoder_config else HiFiGANConfig()
        vocoder = Generator(vcfg)
        sd = torch.load(args.vocoder, map_location='cpu', weights_only=True)
        vocoder.load_state_dict(load_hifigan_state_dict(sd['generator'],
                                                        vcfg), strict=True)
        vocoder = vocoder.to(device).eval()
        vocoder.compute_dtype = dtype

    with open(args.file, encoding='utf-8') as f:
        texts = [line.strip() for line in f if line.strip()]
    cmu = CMUDict(cfg.data.cmudict_path)
    os.makedirs(args.output, exist_ok=True)
    sr, hop = cfg.data.sample_rate, cfg.data.hop_length
    generator = torch.Generator(device=device).manual_seed(args.seed)
    spk = None
    if args.speaker_id is not None:
        spk = torch.tensor([args.speaker_id], device=device)

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
                         length_scale=args.length_scale, generator=generator,
                         stoc=args.stoc, spk=spk, sampler=args.sampler)
        frames = int(res.y_lengths[0])
        mel = res.decoder_outputs[0, :frames]
        dt = time.perf_counter() - t0
        print(f'Synthesizing {i} text... Grad-TTS RTF: '
              f'{dt * sr / (frames * hop)}')
        np.save(os.path.join(args.output, f'mel_{i}.npy'), mel.cpu().numpy())
        if vocoder is not None:
            with torch.no_grad():
                wav = vocoder(mel[None])[0].clamp(-1, 1).cpu().numpy()
            wavfile.write(os.path.join(args.output, f'sample_{i}.wav'), sr,
                          (wav * 32767).astype(np.int16))
    print(f'Done. Check out the `{args.output}` folder for samples.')


if __name__ == '__main__':
    main()
