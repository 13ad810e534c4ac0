"""Batch test-set synthesis CLI, on the GPU.

Counterpart of gradtts_tpu/cli/generate.py (the same flags). Synthesizes
every utterance of a preset's split (default ``tedlium``, whose speaker
vectors come from ``data.test_spk_path``) in batches of ``--batch-size``,
in the loader's shuffled order (``--seed``). The tail batch is padded to
the batch size with copies of its last row, and only its real rows are
written. A batch's frame budget is twice its mel bucket, at least 64 and a
multiple of 4; its noise is one standard normal draw [batch size, budget,
n_feats] from a generator seeded with ``--seed`` (the same seed gives the
same output, but not the JAX package's numbers, drawn by ``jax.random``).

Writes ``OUT/{batch}/{j}.wav`` (int16 after a clip to [-1, 1], at the
preset's sample rate) with ``--vocoder`` (a reference HiFi-GAN ``.pt`` or
an orbax directory of the JAX vocoder trainer), else ``OUT/{batch}/{j}.npy``
mels [frames, n_feats]; ``--plots`` adds ``{j}_gen.png`` and ``{j}_ref.png``
(matplotlib, imported only then). Prints one line per batch. Runs on
``cuda`` unless ``--cpu`` is given, and fails when no GPU is present
without it. ``--mesh-data`` other than 1 (data-parallel synthesis over
several devices) is not ported and is refused.

Usage:
  python -m gradtts_tpu_torch.cli.generate -o OUT -c CKPT [-t 10] \
      [--preset tedlium] [--split test] [--batch-size 8] \
      [--vocoder hifigan.pt|DIR [--vocoder-config cfg.json]] \
      [--sampler euler|dpm] [--plots] [--cpu] [--set key=value ...]
"""

import argparse
import os
import time

import numpy as np
import torch

from gradtts_tpu_torch.cli.inference import (load_vocoder, parse_overrides,
                                             resolve_device, write_wav)
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.data.dataset import (BatchCollate, DataLoader,
                                            dataset_from_config)
from gradtts_tpu_torch.models.tts import GradTTS, synthesize
from gradtts_tpu_torch.utils.convert import load_checkpoint


def pad_batch(batch: dict, batch_size: int):
    """(``batch`` with its rows padded to ``batch_size`` by copies of its
    last row, its number of real rows)."""
    n_real = batch['x'].shape[0]
    if n_real < batch_size:
        batch = {k: np.concatenate([v, np.repeat(v[-1:], batch_size - n_real,
                                                 axis=0)])
                 for k, v in batch.items()}
    return batch, n_real


def frame_budget(batch: dict) -> int:
    """Twice the batch's mel bucket, at least 64, rounded up to 4."""
    y_budget = max(int(2 * batch['y'].shape[1]), 64)
    return y_budget + (-y_budget) % 4


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-o', '--output_dir', required=True)
    parser.add_argument('-c', '--checkpoint', required=True)
    parser.add_argument('-t', '--timesteps', type=int, default=10)
    parser.add_argument('--preset', default='tedlium')
    parser.add_argument('--split', default='test')
    parser.add_argument('--vocoder', default=None)
    parser.add_argument('--vocoder-config', default=None)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--mesh-data', type=int, default=1,
                        help='devices to shard each batch over; only 1 is '
                             'ported')
    parser.add_argument('--temperature', type=float, default=1.5)
    parser.add_argument('--sampler', default='euler',
                        choices=['euler', 'dpm'])
    parser.add_argument('--plots', action='store_true',
                        help='save generated/reference mel heatmaps')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the GPU')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--set', nargs='*', default=[],
                        help='dotted config overrides (must match training)')
    args = parser.parse_args(argv)
    if args.mesh_data != 1:
        parser.error(f'--mesh-data {args.mesh_data}: data-parallel '
                     'synthesis over several devices is not ported to '
                     'gradtts_tpu_torch yet; use --mesh-data 1')
    cfg = get_config(args.preset, **parse_overrides(args.set))
    device = resolve_device(args.cpu)

    model = GradTTS.from_config(cfg)
    model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
    model = model.to(device).eval()
    vocoder = None
    if args.vocoder:
        vocoder = load_vocoder(args.vocoder, args.vocoder_config, device)
    if args.plots:
        from gradtts_tpu_torch.utils.plotting import save_plot

    loader = DataLoader(dataset_from_config(cfg, args.split), args.batch_size,
                        BatchCollate(cfg.data.x_buckets, cfg.data.y_buckets),
                        shuffle=True, seed=args.seed, drop_last=False)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    sr, hop = cfg.data.sample_rate, cfg.data.hop_length
    for i, batch in enumerate(loader):
        t0 = time.perf_counter()
        batch, n_real = pad_batch(batch, args.batch_size)
        y_budget = frame_budget(batch)
        noise = torch.randn((args.batch_size, y_budget, cfg.data.n_feats),
                            generator=generator, device=device)
        spk = (torch.from_numpy(batch['spk']).to(device) if 'spk' in batch
               else None)
        x, x_lengths = (torch.from_numpy(batch[k]).long().to(device)
                        for k in ('x', 'x_lengths'))
        res = synthesize(model, x, x_lengths, args.timesteps, y_budget,
                         temperature=args.temperature, noise=noise, spk=spk,
                         sampler=args.sampler)
        lengths = res.y_lengths.tolist()
        out_dir = os.path.join(args.output_dir, str(i))
        os.makedirs(out_dir, exist_ok=True)
        for j in range(n_real):
            mel = res.decoder_outputs[j, :lengths[j]]              # [T, F]
            if vocoder is not None:
                write_wav(vocoder, mel, os.path.join(out_dir, f'{j}.wav'), sr)
            else:
                np.save(os.path.join(out_dir, f'{j}.npy'), mel.cpu().numpy())
            if args.plots:
                ref_len = int(batch['y_lengths'][j])
                save_plot(mel.cpu().numpy().T,
                          os.path.join(out_dir, f'{j}_gen.png'))
                save_plot(batch['y'][j, :ref_len].T,
                          os.path.join(out_dir, f'{j}_ref.png'))
        audio_s = sum(lengths[:n_real]) * hop / sr
        dt = time.perf_counter() - t0
        print(f'batch {i}: {n_real} utterances, {audio_s:.2f} s of audio in '
              f'{dt:.3f} s ({audio_s / dt:.1f} audio-s/s)', flush=True)
    print(f'Done. Check out the `{args.output_dir}` folder.')


if __name__ == '__main__':
    main()
