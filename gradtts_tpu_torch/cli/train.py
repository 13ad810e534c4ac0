"""Training CLI, on the GPU.

Counterpart of gradtts_tpu/cli/train.py (the same flags). Trains the
preset's model on its filelist (``wav|text`` lines; ``wav|text|speaker_id``
for a preset with a speaker table; a speaker-vector matrix in
``data.train_spk_path`` for ``n_spks == -1``) and writes
``train.log``, TensorBoard scalars and ``ckpt/step_*.pt`` under the log
directory; a rerun resumes from the latest checkpoint. The epoch-end
synthesis previews (PNGs and TensorBoard images, ``train.loop``) are on,
as in the JAX CLI; they need matplotlib, and ``--no-previews`` turns them
off on a machine without it (the JAX trainer's
``synthesis_every_epoch=False``). Runs on ``cuda`` unless ``--cpu`` is
given, and fails when no GPU is present without it.

Data-parallel training runs one process a GPU under torchrun, which names
each process's rank; ``--batch-size`` is the global batch, split over the
W processes:

  torchrun --standalone --nproc-per-node W -m gradtts_tpu_torch.cli.train \
      --mesh-data W --preset ljspeech [...]

Tensor parallelism splits the weights over a 'model' axis of M processes
(``--mesh-model M``, the JAX rule of gradtts_tpu/parallel/mesh.py:140):
D x M processes form a D x M mesh, each data row of M ranks takes the same
block of the global batch and each rank holds its block of every split
weight and of its Adam moments:

  torchrun --standalone --nproc-per-node 4 -m gradtts_tpu_torch.cli.train \
      --mesh-data 2 --mesh-model 2 --preset ljspeech [...]

``--mesh-model`` must divide the process count and ``--mesh-data`` must
be the process count over it (or -1, its default in the config). The
checkpoints are written in the one-process layout.

Usage:
  python -m gradtts_tpu_torch.cli.train --preset ljspeech [--log-dir DIR]
      [--epochs N] [--max-steps N] [--batch-size B] [--mesh-data D]
      [--mesh-model M] [--no-resume] [--no-previews] [--cpu]
      [--set key=value ...]
"""

import argparse
import logging

from gradtts_tpu_torch.cli.inference import parse_overrides, resolve_device
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.parallel.mesh import initialize_distributed, world
from gradtts_tpu_torch.train.loop import train


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--preset', default='ljspeech')
    parser.add_argument('--log-dir', default=None)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--max-steps', type=int, default=None)
    parser.add_argument('--batch-size', type=int, default=None)
    parser.add_argument('--mesh-data', type=int, default=None)
    parser.add_argument('--mesh-model', type=int, default=None)
    parser.add_argument('--no-resume', action='store_true')
    parser.add_argument('--no-previews', action='store_true',
                        help='write no synthesis previews (needs no '
                             'matplotlib)')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the GPU')
    parser.add_argument('--set', nargs='*', default=[],
                        help='dotted config overrides, e.g. '
                             'train.learning_rate=2e-4')
    args = parser.parse_args(argv)
    device = resolve_device(args.cpu)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')
    # a torchrun launch joins its process group (a no-op in one process)
    if initialize_distributed(device=device):
        logging.getLogger('gradtts_tpu_torch.train').info(
            'distributed: process %d/%d', *world())
    overrides = parse_overrides(args.set)
    if args.batch_size is not None:
        overrides['train.batch_size'] = args.batch_size
    if args.mesh_data is not None:
        overrides['train.mesh_data'] = args.mesh_data
    if args.mesh_model is not None:
        overrides['train.mesh_model'] = args.mesh_model
    cfg = get_config(args.preset, **overrides)
    return train(cfg, n_epochs=args.epochs, max_steps=args.max_steps,
                 log_dir=args.log_dir, resume=not args.no_resume,
                 device=device, synthesis_every_epoch=not args.no_previews)


if __name__ == '__main__':
    main()
