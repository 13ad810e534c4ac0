"""Objective evaluation CLI: synthesize a preset's test split and score it
against the recorded audio, on the GPU.

Counterpart of gradtts_tpu/cli/evaluate.py (the same flags, and
``--set`` dotted config overrides, which the JAX CLI lacks). For each of
the first ``--n-utterances`` items of the split (in the dataset's
shuffled order): ``--timesteps`` (50) Euler steps at temperature 1.5 with
a frame budget of twice the item's reference frames plus 8, bucketed
(``utterance_budget``), HiFi-GAN, a clip to [-1, 1], then log-F0 RMSE,
MCD, GPE, VDE and FFE against the item's wav (``eval.evaluate_pair``,
host-side numpy). Prints one line per utterance (the metrics, then the
seconds of synthesis, vocoder and DSP on the host clock) and ``MEAN:``
with the mean of each metric as JSON; with ``--out-dir`` it also writes
``eval_{i}.wav`` (int16) and ``metrics.json``.

The noise of utterance i is one standard normal draw [1, budget,
n_feats] from a generator seeded with ``--seed``, drawn utterance by
utterance. The JAX CLI splits a ``jax.random`` key instead, so the two
CLIs draw other noise; ``evaluate_utterance`` takes the noise as an input.

``--checkpoint`` takes what ``utils.convert.load_checkpoint`` takes (a
reference ``.pt``, a trainer's ``ckpt/step_*.pt``, a ``.npz`` param tree
or an orbax directory of the JAX acoustic trainer); ``--vocoder`` a
HiFi-GAN ``.pt`` or an orbax directory of the JAX vocoder trainer, whose
generator (``params['gen']``) is read. Without ``--vocoder-config`` the
vocoder is HiFi-GAN V1, as the JAX CLI falls back to when its default
config path is absent. f32 compute throughout. Runs on ``cuda`` unless
``--cpu`` is given, and fails when no GPU is present without it.

Usage:
  python -m gradtts_tpu_torch.cli.evaluate --checkpoint CKPT \
      --vocoder HIFIGAN [--vocoder-config cfg.json] [--preset ljspeech] \
      [--n-utterances 50] [--timesteps 50] [--speaker-id N] \
      [--dsp-backend auto|yin|world] [--out-dir DIR] [--cpu] \
      [--set data.test_filelist_path=list.txt ...]
"""

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch
from scipy.io import wavfile

from gradtts_tpu_torch.cli.inference import (load_vocoder, parse_overrides,
                                             resolve_device)
from gradtts_tpu_torch.config import (bucket_length, fix_len_compatibility,
                                      get_config)
from gradtts_tpu_torch.data.dataset import dataset_from_config, load_wav
from gradtts_tpu_torch.eval import evaluate_pair
from gradtts_tpu_torch.models.tts import (GradTTS, set_compute_dtype,
                                          synthesize)
from gradtts_tpu_torch.utils.convert import load_checkpoint


class UtteranceResult(NamedTuple):
    mel: torch.Tensor         # [frames, n_feats], on the model's device
    waveform: np.ndarray      # [frames * hop] f32, clipped to [-1, 1]
    metrics: dict             # log_f0_rmse, mcd, gpe, vde, ffe
    seconds: dict             # synthesis, vocoder, dsp (host clock)


def utterance_budget(frames: int, y_buckets) -> int:
    """The frame budget of an utterance whose reference mel has ``frames``
    frames: the bucket of 2 * frames + 8, a multiple of 4."""
    return fix_len_compatibility(bucket_length(2 * frames + 8, y_buckets))


def utterance_speaker(item: dict, n_spks: int, speaker_id, device):
    """The speaker input of ``item``: ``speaker_id`` [1] when given, else
    the item's id [1] for a speaker table (``n_spks > 1``) or its vector
    [1, D] (``n_spks == -1``), else None."""
    if speaker_id is not None:
        return torch.tensor([speaker_id], device=device)
    if 'spk' in item and n_spks > 1:
        return torch.as_tensor(item['spk'], device=device).reshape(1)
    if 'spk' in item and n_spks == -1:
        return torch.as_tensor(item['spk'], device=device)[None]
    return None


def evaluate_utterance(model: GradTTS, vocoder, item: dict, ref_wav,
                       sample_rate: int, noise, n_timesteps: int = 50,
                       temperature: float = 1.5, spk=None,
                       dsp_backend: str = 'auto') -> UtteranceResult:
    """One utterance of the JAX CLI's loop (gradtts_tpu/cli/evaluate.py
    :86-116) with its noise an input: ``item['x']`` synthesized with
    ``noise`` [1, budget, n_feats] (the budget is its length), the mel's
    frames vocoded, the waveform clipped to [-1, 1] and scored against
    ``ref_wav`` at ``sample_rate``. Runs on the model's device; the
    metrics on the host."""
    device = noise.device
    x = torch.as_tensor(item['x'], device=device).long()[None]
    x_lengths = torch.tensor([x.shape[1]], device=device)
    t0 = time.perf_counter()
    res = synthesize(model, x, x_lengths, n_timesteps, noise.shape[1],
                     temperature=temperature, noise=noise, spk=spk)
    frames = int(res.y_lengths[0])            # waits for the sampler
    mel = res.decoder_outputs[0, :frames]
    t1 = time.perf_counter()
    with torch.no_grad():
        wav = vocoder(mel[None])[0].cpu().numpy()
    wav = np.clip(wav, -1, 1)
    t2 = time.perf_counter()
    metrics = evaluate_pair(wav, ref_wav, sample_rate, backend=dsp_backend)
    t3 = time.perf_counter()
    return UtteranceResult(mel, wav, metrics, {
        'synthesis': t1 - t0, 'vocoder': t2 - t1, 'dsp': t3 - t2})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--checkpoint', required=True)
    parser.add_argument('--vocoder', required=True,
                        help='HiFi-GAN checkpoint (.pt with a "generator" '
                             'key, or an orbax directory of the vocoder '
                             'trainer)')
    parser.add_argument('--vocoder-config', default=None,
                        help='HiFi-GAN config JSON (default: V1)')
    parser.add_argument('--preset', default='ljspeech')
    parser.add_argument('--split', default='test')
    parser.add_argument('--n-utterances', type=int, default=50)
    parser.add_argument('--timesteps', type=int, default=50)
    parser.add_argument('--temperature', type=float, default=1.5)
    parser.add_argument('--speaker-id', type=int, default=None)
    parser.add_argument('--out-dir', default=None,
                        help='also write wavs + per-utt metrics here')
    parser.add_argument('--dsp-backend', default='auto',
                        choices=['auto', 'yin', 'world'],
                        help="feature extractors: 'world' = WORLD harvest + "
                             'CheapTrick + SPTK mcep (reference-comparable '
                             'numbers; uses pyworld/pysptk when installed, '
                             'else the built-in numpy implementations of '
                             "the same algorithms); 'yin' = fast built-in "
                             "DSP; 'auto' picks pyworld-world when "
                             "importable, else 'yin'")
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the GPU')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--set', nargs='*', default=[],
                        help='dotted config overrides (must match training)')
    args = parser.parse_args(argv)
    device = resolve_device(args.cpu)

    cfg = get_config(args.preset, **parse_overrides(args.set))
    model = GradTTS.from_config(cfg)
    model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
    model = model.to(device).eval()
    set_compute_dtype(model, torch.float32)   # the JAX CLI's f32
    vocoder = load_vocoder(args.vocoder, args.vocoder_config, device)

    dataset = dataset_from_config(cfg, args.split)
    n = min(args.n_utterances, len(dataset))
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    rows = []
    for i in range(n):
        item = dataset[i]
        ref_wav, fs = load_wav(dataset.filepaths_and_text[i][0])
        budget = utterance_budget(item['y'].shape[0], cfg.data.y_buckets)
        noise = torch.randn((1, budget, cfg.data.n_feats),
                            generator=generator, device=device)
        res = evaluate_utterance(
            model, vocoder, item, ref_wav, fs, noise,
            n_timesteps=args.timesteps, temperature=args.temperature,
            spk=utterance_speaker(item, cfg.n_spks, args.speaker_id, device),
            dsp_backend=args.dsp_backend)
        rows.append(res.metrics)
        print(f'[{i + 1}/{n}] ' + ' '.join(
            f'{k}={v:.4f}' for k, v in res.metrics.items()) + ' | ' +
            ' '.join(f'{k}_s={v:.4f}' for k, v in res.seconds.items()),
            flush=True)
        if args.out_dir:
            wavfile.write(os.path.join(args.out_dir, f'eval_{i}.wav'), fs,
                          (res.waveform * 32767).astype(np.int16))

    means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    print('MEAN:', json.dumps(means))
    if args.out_dir:
        with open(os.path.join(args.out_dir, 'metrics.json'), 'w') as f:
            json.dump({'per_utt': rows, 'mean': means}, f, indent=2)


if __name__ == '__main__':
    main()
