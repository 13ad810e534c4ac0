"""HiFi-GAN training and fine-tuning CLI, on the GPU.

Counterpart of gradtts_tpu/cli/train_vocoder.py (the same flags, plus
``--cpu``). Trains the generator (V1 unless ``--config`` names a
``hifigan-config.json``) with the multi-period and multi-scale
discriminators on ``name|text`` filelists of wavs in ``--input-wavs-dir``,
and writes ``train.log``, TensorBoard scalars and ``ckpt/step_*.pt`` under
``--log-dir``: every ``--save-every`` epochs and at the end. A rerun
resumes from the latest checkpoint unless ``--no-resume`` is given.
``cli.inference --vocoder`` reads a checkpoint as it is. Runs on ``cuda``
unless ``--cpu`` is given, and fails when no GPU is present without it.

Usage:
  python -m gradtts_tpu_torch.cli.train_vocoder --input-wavs-dir wavs
      --input-training-file train.txt --log-dir logs/hifigan
      [--config hifigan-config.json] [--fine-tuning --base-mels-path mels/]
      [--init-generator hifigan.pt|DIR] [--batch-size 16] [--epochs 100]
      [--max-steps N] [--no-resume] [--cpu]
"""

import argparse
import logging
import os
import time

from gradtts_tpu_torch.cli.inference import resolve_device
from gradtts_tpu_torch.data.dataset import DataLoader
from gradtts_tpu_torch.data.vocoder_dataset import (VocoderBatchCollate,
                                                    VocoderMelDataset,
                                                    vocoder_filelists)
from gradtts_tpu_torch.models.hifigan import HiFiGANConfig
from gradtts_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from gradtts_tpu_torch.train.loop import MetricsLogger, batch_to
from gradtts_tpu_torch.train.vocoder import (METRICS, init_vocoder_state,
                                             make_vocoder_train_step)
from gradtts_tpu_torch.utils.convert import load_vocoder_checkpoint

log = logging.getLogger('gradtts_tpu_torch.train_vocoder')


def vocoder_loader(dataset, batch_size, seed):
    """A shuffled loader of ``dataset`` that caches no item: items are
    random crops drawn anew on each call, and a cached one would repeat
    its first epoch's crop in every later epoch."""
    return DataLoader(dataset, batch_size, VocoderBatchCollate(),
                      shuffle=True, seed=seed, cache_bytes=0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--input-wavs-dir', required=True)
    parser.add_argument('--input-training-file', required=True)
    parser.add_argument('--input-validation-file', default=None)
    parser.add_argument('--log-dir', required=True)
    parser.add_argument('--config', default=None,
                        help='hifigan-config.json (defaults to V1 22.05 kHz)')
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--segment-size', type=int, default=None,
                        help='defaults to the config JSON value (8192)')
    parser.add_argument('--epochs', type=int, default=100)
    parser.add_argument('--max-steps', type=int, default=None)
    parser.add_argument('--learning-rate', type=float, default=None,
                        help='defaults to the config JSON value')
    parser.add_argument('--lr-decay', type=float, default=None,
                        help='defaults to the config JSON value')
    parser.add_argument('--save-every', type=int, default=5,
                        help='checkpoint every N epochs')
    parser.add_argument('--fine-tuning', action='store_true')
    parser.add_argument('--base-mels-path', default=None,
                        help='precomputed generator mels (<stem>.npy)')
    parser.add_argument('--init-generator', default=None,
                        help='HiFi-GAN checkpoint to fine-tune from: a '
                             'reference .pt, or an orbax directory of the '
                             'JAX vocoder trainer')
    parser.add_argument('--seed', type=int, default=1234)
    parser.add_argument('--no-resume', action='store_true')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the GPU')
    args = parser.parse_args(argv)
    device = resolve_device(args.cpu)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')

    cfg = HiFiGANConfig.from_json(args.config) if args.config \
        else HiFiGANConfig()
    segment_size = args.segment_size or cfg.segment_size
    train_files, _ = vocoder_filelists(
        args.input_training_file,
        args.input_validation_file or args.input_training_file,
        args.input_wavs_dir)
    # the config's mel settings, so the dataset, the loss mel and the
    # generator's samples a frame agree
    dataset = VocoderMelDataset(
        train_files, segment_size=segment_size, n_fft=cfg.n_fft,
        num_mels=cfg.num_mels, hop_size=cfg.hop_size, win_size=cfg.win_size,
        sampling_rate=cfg.sampling_rate, fmin=cfg.fmin, fmax=cfg.fmax,
        fmax_loss=cfg.fmax_loss, seed=args.seed,
        fine_tuning=args.fine_tuning, base_mels_path=args.base_mels_path)
    loader = vocoder_loader(dataset, args.batch_size, args.seed)

    ckpt_dir = os.path.join(args.log_dir, 'ckpt')
    payload = None if args.no_resume else restore_checkpoint(ckpt_dir)
    generator_state = None
    if args.init_generator and payload is None:
        generator_state = load_vocoder_checkpoint(args.init_generator, cfg)
        log.info('initialized generator from %s', args.init_generator)
    state = init_vocoder_state(
        cfg, device, steps_per_epoch=max(len(loader), 1), seed=args.seed,
        generator_state=generator_state, learning_rate=args.learning_rate,
        lr_decay=args.lr_decay)
    if payload is not None:
        state.load_payload(payload)
        log.info('resumed from step %d', state.step)
    start_step = last_saved = state.step

    step_fn = make_vocoder_train_step(cfg)
    metrics_log = MetricsLogger(args.log_dir, METRICS)
    try:
        for epoch in range(args.epochs):
            t0 = time.time()
            done = False
            for batch in loader:
                metrics = step_fn(state, batch_to(batch, device))
                metrics_log.add(state.step, metrics)
                done = (args.max_steps is not None
                        and state.step - start_step >= args.max_steps)
                if done:
                    break
            metrics_log.end_epoch(epoch, time.time() - t0)
            if (epoch + 1) % args.save_every == 0 or done:
                save_checkpoint(ckpt_dir, state.step, state.payload())
                last_saved = state.step
            if done:
                break
        if state.step > last_saved:
            save_checkpoint(ckpt_dir, state.step, state.payload())
    finally:
        metrics_log.close()
    return state


if __name__ == '__main__':
    main()
