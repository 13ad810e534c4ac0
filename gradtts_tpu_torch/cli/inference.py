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
speaker (the upstream wiring) is recognized and built so. ``-c`` takes a
reference ``.pt``, a trainer's ``ckpt/step_*.pt``, a ``.npz`` param tree or
an orbax checkpoint directory of the JAX package's acoustic trainer.
``--vocoder`` takes a reference HiFi-GAN ``.pt`` (its ``generator`` key) or
an orbax directory of the JAX package's vocoder trainer (its generator's
params), and ``--vocoder-config`` its JSON; without one the V1 config. An
orbax directory is read with tensorstore (``utils.io
.read_orbax_checkpoint``), a host-side package.

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
                                             load_vocoder_checkpoint)

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


def text_inputs(text: str, cmu: CMUDict, cfg):
    """A text as the synthesis CLIs feed it: (token ids [1, bucket] int64,
    zero-padded to the preset's text bucket; their count; the frame
    budget, the mel bucket of 10 frames a token)."""
    ids = intersperse_blank(text_to_sequence(text, dictionary=cmu),
                            len(symbols))
    x = torch.zeros((1, bucket_length(len(ids), cfg.data.x_buckets)),
                    dtype=torch.long)
    x[0, :len(ids)] = torch.tensor(ids)
    y_budget = fix_len_compatibility(
        bucket_length(10 * len(ids), cfg.data.y_buckets))
    return x, len(ids), y_budget


def load_vocoder(path, config_path, device) -> Generator:
    """The HiFi-GAN generator of ``path`` (:func:`utils.convert
    .load_vocoder_checkpoint`) with the config of the JSON at
    ``config_path`` (V1 where None), on ``device``, in eval mode."""
    vcfg = HiFiGANConfig.from_json(config_path) if config_path \
        else HiFiGANConfig()
    vocoder = Generator(vcfg)
    vocoder.load_state_dict(load_vocoder_checkpoint(path, vcfg), strict=True)
    return vocoder.to(device).eval()


def vocode(vocoder, mel) -> np.ndarray:
    """The vocoder's waveform of ``mel`` [frames, n_feats] as int16 after a
    clip to [-1, 1]."""
    with torch.no_grad():
        wav = vocoder(mel[None])[0].clamp(-1, 1).cpu().numpy()
    return (wav * 32767).astype(np.int16)


def write_wav(vocoder, mel, path: str, sample_rate: int) -> None:
    """:func:`vocode` of ``mel`` written to ``path``."""
    wavfile.write(path, sample_rate, vocode(vocoder, mel))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-f', '--file', required=True,
                        help='path to a file with texts to synthesize')
    parser.add_argument('-c', '--checkpoint', required=True,
                        help='Grad-TTS checkpoint (reference .pt, a trainer '
                             'ckpt/step_*.pt, .npz, or an orbax directory)')
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
                             '"generator" key, or an orbax directory of the '
                             'vocoder trainer); mels only if unset')
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
        vocoder = load_vocoder(args.vocoder, args.vocoder_config, device)
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
        x, n_ids, y_budget = text_inputs(text, cmu, cfg)
        t0 = time.perf_counter()
        res = synthesize(model, x.to(device),
                         torch.tensor([n_ids], device=device),
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
            write_wav(vocoder, mel, os.path.join(args.output,
                                                 f'sample_{i}.wav'), sr)
    print(f'Done. Check out the `{args.output}` folder for samples.')


if __name__ == '__main__':
    main()
