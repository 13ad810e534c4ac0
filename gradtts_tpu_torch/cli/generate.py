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
without it.

Data-parallel synthesis (:100-170) runs one process a GPU under torchrun,
``--mesh-data`` the process count W (or -1): every rank loads the split in
the same order and draws each batch's noise at the global shape from the
same generator, then synthesizes its contiguous block of ``--batch-size /
W`` rows (and vocodes them); rank 0 gathers the outputs and writes the
files that one process writes. In one process ``--mesh-data`` other than
1 or -1 is refused:

  torchrun --standalone --nproc-per-node W -m gradtts_tpu_torch.cli.generate \
      --mesh-data W -o OUT -c CKPT [...]

Usage:
  python -m gradtts_tpu_torch.cli.generate -o OUT -c CKPT [-t 10] \
      [--preset tedlium] [--split test] [--batch-size 8] [--mesh-data W] \
      [--vocoder hifigan.pt|DIR [--vocoder-config cfg.json]] \
      [--sampler euler|dpm] [--plots] [--cpu] [--set key=value ...]
"""

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from scipy.io import wavfile

from gradtts_tpu_torch.cli.inference import (load_vocoder, parse_overrides,
                                             resolve_device, vocode)
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.data.dataset import (BatchCollate, DataLoader,
                                            dataset_from_config)
from gradtts_tpu_torch.models.tts import GradTTS, synthesize
from gradtts_tpu_torch.parallel.mesh import (initialize_distributed,
                                             make_mesh, replicated,
                                             shard_batch, world)
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
                        help='processes to shard each batch over (one a '
                             'GPU, launched by torchrun); -1: all')
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
    device = resolve_device(args.cpu)
    initialize_distributed(device=device)
    rank, ranks = world()
    if args.mesh_data not in (-1, ranks):
        parser.error(f'--mesh-data {args.mesh_data} needs as many processes, '
                     f'one a GPU, and this run has {ranks}: launch with '
                     f'torchrun --nproc-per-node {args.mesh_data}')
    if args.batch_size % ranks:
        parser.error(f'--batch-size {args.batch_size} not divisible by '
                     f'data-mesh size {ranks}')
    cfg = get_config(args.preset, **parse_overrides(args.set))

    model = GradTTS.from_config(cfg)
    model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
    model = model.to(device).eval()
    mesh = None
    if dist.is_initialized():
        mesh = make_mesh(ranks, 1, device_type=device.type)
        replicated(mesh, model)
    vocoder = None
    if args.vocoder:
        vocoder = load_vocoder(args.vocoder, args.vocoder_config, device)
    if args.plots and rank == 0:
        from gradtts_tpu_torch.utils.plotting import save_plot

    loader = DataLoader(dataset_from_config(cfg, args.split), args.batch_size,
                        BatchCollate(cfg.data.x_buckets, cfg.data.y_buckets),
                        shuffle=True, seed=args.seed, drop_last=False)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    sr, hop = cfg.data.sample_rate, cfg.data.hop_length
    rows = args.batch_size // ranks       # this rank's: [first, first + rows)
    first = rank * rows
    for i, batch in enumerate(loader):
        t0 = time.perf_counter()
        batch, n_real = pad_batch(batch, args.batch_size)
        y_budget = frame_budget(batch)
        # one draw at the global shape on every rank: the same seed gives
        # the same output at any mesh size
        noise = torch.randn((args.batch_size, y_budget, cfg.data.n_feats),
                            generator=generator, device=device)
        inputs = {k: batch[k] for k in ('x', 'x_lengths', 'spk')
                  if k in batch}
        inputs = ({k: torch.from_numpy(v).to(device)
                   for k, v in inputs.items()} if mesh is None
                  else shard_batch(mesh, inputs))
        res = synthesize(model, inputs['x'].long(),
                         inputs['x_lengths'].long(), args.timesteps,
                         y_budget, temperature=args.temperature,
                         noise=noise[first:first + rows],
                         spk=inputs.get('spk'), sampler=args.sampler)
        lengths = res.y_lengths.tolist()
        outs = []                           # (mel, wav or None) a real row
        for j in range(min(rows, n_real - first)):
            mel = res.decoder_outputs[j, :lengths[j]]              # [T, F]
            outs.append((mel.cpu().numpy(), None if vocoder is None
                         else vocode(vocoder, mel)))
        if mesh is not None:
            # gloo carries no gather of CUDA tensors: host objects
            parts = [None] * ranks if rank == 0 else None
            dist.gather_object(outs, parts, dst=0)
            outs = [o for part in parts or [] for o in part]
        if rank != 0:
            continue
        out_dir = os.path.join(args.output_dir, str(i))
        os.makedirs(out_dir, exist_ok=True)
        for j, (mel, wav) in enumerate(outs):
            if wav is not None:
                wavfile.write(os.path.join(out_dir, f'{j}.wav'), sr, wav)
            else:
                np.save(os.path.join(out_dir, f'{j}.npy'), mel)
            if args.plots:
                ref_len = int(batch['y_lengths'][j])
                save_plot(mel.T, os.path.join(out_dir, f'{j}_gen.png'))
                save_plot(batch['y'][j, :ref_len].T,
                          os.path.join(out_dir, f'{j}_ref.png'))
        audio_s = sum(mel.shape[0] for mel, _ in outs) * hop / sr
        dt = time.perf_counter() - t0
        print(f'batch {i}: {n_real} utterances, {audio_s:.2f} s of audio in '
              f'{dt:.3f} s ({audio_s / dt:.1f} audio-s/s)', flush=True)
    if rank == 0:
        print(f'Done. Check out the `{args.output_dir}` folder.')


if __name__ == '__main__':
    main()
