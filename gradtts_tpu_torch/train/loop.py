"""The training loop: epochs over the data loader, the train step on the
device, metrics fetched in batches, per-epoch log line, synthesis
previews, checkpoints and resume.

Counterpart of gradtts_tpu/train/loop.py:93-368 for one device. The
parameters and the Adam state are f32 on the device; the forward runs in
bf16 where the JAX package does when ``train.use_bf16_compute`` is set.
The metrics stay on the device and are fetched every ``FLUSH_EVERY`` steps
in one copy, never per step. TensorBoard scalars (the reference's names)
are written when ``torch.utils.tensorboard`` imports. The dataset is the
preset's (``dataset_from_config``: speaker ids or vectors where it has
speakers), and a batch's ``spk`` goes to ``compute_loss``. The mels come
from the device (``DataLoader(device_mel=True)``) when
``train.device_mel`` is True, or is None and the trainer runs on a GPU in
one process, as the JAX package's auto rule picks them on its
accelerator (:128-131); else from the host's numpy workers.
``train.remat_estimator`` recomputes the U-Net's forward in the backward
(``compute_loss(remat=True)``).

Previews (:264-317, 371-394): with ``synthesis_every_epoch`` (the default)
and a dataset of at least ``train.test_size`` items, ``test_size`` of them
(``sample_test_batch``) are plotted once as ``original_{i}.png``, and every
``save_every`` epochs they are synthesized (50 Euler steps) and written as
``generated_enc_{i}.png``, ``generated_dec_{i}.png`` and
``alignment_{i}.png`` and as TensorBoard images. The plots need
matplotlib, a host-side package: where it is missing, ``train`` raises
before the first step.

Data parallelism (:104-346): where this process belongs to a process
group (``parallel.mesh.initialize_distributed``; ``torchrun
--nproc-per-node W``), ``train`` builds the ('data', 'model') mesh over
the W ranks, wraps the model in ``DistributedDataParallel`` over 'data',
and each rank's loader takes its contiguous block of every global batch
of ``train.batch_size`` (``DataLoader(shard=(rank, W))``, global-batch
shapes on every rank). A step then equals one process's step on the
global batch (``train.state.train_step``: the draws at the global shape,
the losses normalized by the global counts). Rank 0 alone writes the
logs, the previews and the checkpoints; every rank resumes from the same
file.

Tensor parallelism (:104, 163-166): with ``train.mesh_model`` M above 1
the W ranks form a (W / M) x M mesh. Every rank builds the full model
from ``train.seed`` (and loads a checkpoint whole), then keeps its block
of each weight that the JAX rule splits (``parallel.mesh.shard_model``);
the optimizer holds Adam's moments of those blocks. DDP runs over the
'data' axis and the loader's rows follow the 'data' coordinate, so the
M ranks of a 'model' group take the same rows. Checkpoints and previews
gather the blocks: the checkpoint is written in the one-process layout
(``cli.inference -c`` and a run under any M resume from it), and rank 0
synthesizes the previews from the full weights.
"""

import logging
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from gradtts_tpu_torch.config import GradTTSConfig
from gradtts_tpu_torch.data.dataset import (BatchCollate, DataLoader,
                                            dataset_from_config)
from gradtts_tpu_torch.models.tts import (GradTTS, set_compute_dtype,
                                          synthesize)
from gradtts_tpu_torch.parallel.mesh import make_mesh, shard_model, world
from gradtts_tpu_torch.parallel.tensor import (full_optimizer_state,
                                               full_state_dict,
                                               optimizer_state_blocks,
                                               split_parameters)
from gradtts_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from gradtts_tpu_torch.train.state import METRICS, make_optimizer, train_step

log = logging.getLogger('gradtts_tpu_torch.train')
FLUSH_EVERY = 50       # steps between fetches of the metrics to the host


class MetricsLogger:
    """TensorBoard scalars (when available) and the ``train.log`` text
    file in ``log_dir``. ``add`` keeps a step's metrics (0-d tensors) on
    the device and fetches them ``FLUSH_EVERY`` steps at a time in one
    copy; ``end_epoch`` fetches the rest and writes the epoch's means.
    With ``enabled`` False (the ranks other than 0) it writes no file and
    still returns the means."""

    def __init__(self, log_dir, names, enabled: bool = True):
        self._tb = self._txt = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=log_dir)
            except ImportError:          # tensorboard is not installed
                pass
            self._txt = open(os.path.join(log_dir, 'train.log'), 'a')
        self.names = tuple(names)
        self._pending, self._epoch = [], []

    def scalars(self, metrics: dict, step: int):
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, global_step=step)

    def images(self, images: dict, step: int):
        """HWC uint8 arrays as TensorBoard images."""
        if self._tb is not None:
            for k, v in images.items():
                self._tb.add_image(k, v, global_step=step, dataformats='HWC')

    def text(self, msg: str):
        if self._txt is not None:
            self._txt.write(msg + '\n')
            self._txt.flush()

    def add(self, step: int, metrics: dict):
        self._pending.append((step, metrics))
        if len(self._pending) >= FLUSH_EVERY:
            self._flush()

    def _flush(self):
        if not self._pending:
            return
        values = torch.stack([torch.stack([m[k] for k in self.names])
                              for _, m in self._pending]).cpu().numpy()
        for (at_step, _), row in zip(self._pending, values):
            host = dict(zip(self.names, row.tolist()))
            self._epoch.append(host)
            self.scalars(host, at_step)
        self._pending.clear()

    def end_epoch(self, epoch: int, seconds: float) -> Optional[dict]:
        """The means of the epoch's metrics, logged and written to
        ``train.log``; None when the epoch had no step."""
        self._flush()
        if not self._epoch:
            return None
        means = {k: float(np.mean([m[k] for m in self._epoch]))
                 for k in self.names}
        self._epoch = []
        msg = (f'epoch {epoch}: ' + ', '.join(
            f'{k}={v:.4f}' for k, v in means.items()) + f' ({seconds:.1f}s)')
        log.info(msg)
        self.text(msg)
        return means

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._txt is not None:
            self._txt.close()


class TrainResult(NamedTuple):
    step: int
    model: GradTTS
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    metrics: dict        # the last epoch's means, the same on every rank


def batch_to(batch: dict, device) -> dict:
    """A collated batch as tensors on ``device``: ids, lengths and speaker
    ids int64, mels and speaker vectors f32. A field that is a tensor
    already (the device mels) moves as it is."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        out[k] = (t if t.is_floating_point() else t.long()).to(
            device, non_blocking=True)
    return out


def check_ported(cfg: GradTTSConfig) -> None:
    """Raises ValueError at a mesh the port cannot honour
    (``gradtts_tpu/train/loop.py:104``, ``make_mesh``'s reasons): the
    mesh is the process group's W ranks, one GPU each, so
    ``train.mesh_model`` M must divide W and ``train.mesh_data`` must be
    W / M or -1."""
    t = cfg.train
    ranks = world()[1]
    if t.mesh_model < 1 or ranks % t.mesh_model:
        raise ValueError(
            f'train.mesh_model={t.mesh_model}: the model axis must divide '
            f'the process count {ranks} (one process a GPU): launch with '
            f'torchrun --nproc-per-node a multiple of {t.mesh_model}')
    if t.mesh_data not in (-1, ranks // t.mesh_model):
        need = t.mesh_data * t.mesh_model
        raise ValueError(
            f'train.mesh_data={t.mesh_data} with train.mesh_model='
            f'{t.mesh_model} needs {need} processes, one a GPU, and this '
            f'run has {ranks} (mesh {t.mesh_data}x{t.mesh_model} != {ranks} '
            f'devices): launch with torchrun --nproc-per-node {need} (or '
            'set train.mesh_data=-1)')


def use_device_mel(cfg: GradTTSConfig, device) -> bool:
    """``train.device_mel``, or where it is None, whether ``device`` is a
    GPU and this is the only process."""
    if cfg.train.device_mel is not None:
        return bool(cfg.train.device_mel)
    return torch.device(device).type == 'cuda' and world()[1] == 1


def preview_budget(n_tokens: int) -> int:
    """The frame budget of a preview of ``n_tokens`` tokens (:386)."""
    return int(4 * max(32, 2 * n_tokens))


def synthesis_preview(cfg: GradTTSConfig, model: GradTTS, test_items,
                      n_timesteps: int = 50, noise=None):
    """Synthesis of held-out items (:371-394) on the model's device, in
    eval mode: a list of (encoder mel [L, F], decoder mel [L, F],
    alignment [Tx, L]) numpy arrays, L the item's predicted frames.
    ``noise``: one standard normal draw [1, budget, n_feats] an item
    (budget :func:`preview_budget` of its tokens), or None: each drawn
    from a generator seeded 0, the same draw at every call, as the JAX
    package draws each from ``PRNGKey(0)``."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    out = []
    try:
        for i, item in enumerate(test_items):
            x = torch.from_numpy(np.asarray(item['x'])).long()[None]
            spk = None
            if 'spk' in item:       # an id [1], or a vector [D]
                spk = torch.from_numpy(np.asarray(item['spk']))
                spk = (spk[None] if spk.is_floating_point() else spk).to(
                    device)
            budget = preview_budget(x.shape[1])
            z = noise[i] if noise is not None else torch.randn(
                (1, budget, cfg.data.n_feats), device=device,
                generator=torch.Generator(device=device).manual_seed(0))
            res = synthesize(model, x.to(device),
                             torch.tensor([x.shape[1]], device=device),
                             n_timesteps, budget, noise=torch.as_tensor(
                                 z, device=device), spk=spk)
            n = int(res.y_lengths[0])
            out.append((res.encoder_outputs[0, :n].float().cpu().numpy(),
                        res.decoder_outputs[0, :n].float().cpu().numpy(),
                        res.attn[0, :, :n].float().cpu().numpy()))
    finally:
        model.train(was_training)
    return out


def _plotting():
    """The plotting module, or a RuntimeError where matplotlib is
    missing: previews are refused at start-up, never skipped."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            'the training previews need matplotlib, which this machine '
            'lacks: pass --no-previews to cli.train '
            '(synthesis_every_epoch=False)') from e
    from gradtts_tpu_torch.utils import plotting
    return plotting


def train(cfg: GradTTSConfig, n_epochs: Optional[int] = None,
          max_steps: Optional[int] = None, log_dir: Optional[str] = None,
          resume: bool = True, loader=None, device=None,
          synthesis_every_epoch: bool = True) -> TrainResult:
    """Trains per ``cfg`` on ``device`` (default ``cuda``, the current
    CUDA device) and returns the final step, model (this rank's blocks
    under tensor parallelism), optimizer, generator and the last epoch's
    mean metrics. ``loader`` (an iterable of collated
    batches, this rank's rows of each global batch in a multi-process run)
    replaces the dataset of ``cfg``, and with it the previews;
    ``max_steps`` bounds the steps of this call; ``synthesis_every_epoch``
    writes the previews (see the module's docstring). Settings the port
    cannot honour raise (:func:`check_ported`)."""
    check_ported(cfg)
    log_dir = log_dir or cfg.train.log_dir
    n_epochs = n_epochs if n_epochs is not None else cfg.train.n_epochs
    device = torch.device(device or 'cuda')
    lead = world()[0] == 0
    dtype = torch.bfloat16 if cfg.train.use_bf16_compute else torch.float32
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)      # the initial weights
        model = GradTTS.from_config(cfg)
    model = model.to(device).train()
    set_compute_dtype(model, dtype)
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed)

    start_step = 0
    ckpt_dir = os.path.join(log_dir, 'ckpt')
    payload = restore_checkpoint(ckpt_dir) if resume else None
    if payload is not None:
        model.load_state_dict(payload['model'])
    mesh = None
    if dist.is_initialized():
        mesh = make_mesh(cfg.train.mesh_data, cfg.train.mesh_model,
                         device_type=device.type)
        # every rank built the full model from the seed (or the full
        # checkpoint): its blocks are the one-process weights
        shard_model(model, mesh)
    optimizer = make_optimizer(model.parameters(), cfg.train.learning_rate)
    if payload is not None:
        optimizer.load_state_dict(optimizer_state_blocks(
            payload['optimizer'], optimizer, model))
        generator.set_state(payload['generator'])
        start_step = int(payload['step'])
        log.info('resumed from step %d', start_step)

    net, shard = model, None
    if mesh is not None:
        shard = (mesh.get_local_rank('data'), mesh.size(0))
        ids = None
        if device.type == 'cuda':
            ids = [device.index if device.index is not None
                   else torch.cuda.current_device()]
        # every parameter takes part in every step (the speaker MLP that
        # n_spks -1 never runs needs no grad), so no search for unused ones
        net = DistributedDataParallel(model, device_ids=ids,
                                      process_group=mesh.get_group('data'))
        log.info('data parallel: rank %d of %d', *shard)
        if mesh.size(1) > 1:
            log.info('tensor parallel: block %d of %d',
                     mesh.get_local_rank('model'), mesh.size(1))

    dataset = None
    if loader is None:
        device_mel = use_device_mel(cfg, device)
        log.info('input pipeline: %s mels', 'device' if device_mel
                 else 'host')
        dataset = dataset_from_config(cfg)
        loader = DataLoader(dataset, cfg.train.batch_size,
                            BatchCollate(cfg.data.x_buckets,
                                         cfg.data.y_buckets),
                            shuffle=True, seed=cfg.train.seed, shard=shard,
                            device_mel=device_mel, device=device)
    test_items = plotting = None
    if (lead and synthesis_every_epoch and dataset is not None
            and len(dataset) >= cfg.train.test_size):
        plotting = _plotting()
        test_items = dataset.sample_test_batch(cfg.train.test_size)
    metrics_log = MetricsLogger(log_dir, METRICS, enabled=lead)

    def log_previews(at_step, state_dict):
        preview = model
        if split_parameters(model):         # synthesize from the full weights
            preview = GradTTS.from_config(cfg)
            preview.load_state_dict(state_dict)
            preview = set_compute_dtype(preview.to(device), dtype)
        images = {}
        for i, (y_enc, y_dec, attn) in enumerate(
                synthesis_preview(cfg, preview, test_items)):
            for name, mat in (('generated_enc', y_enc.T),
                              ('generated_dec', y_dec.T),
                              ('alignment', attn)):
                images[f'image_{i}/{name}'] = plotting.plot_tensor(mat)
                plotting.save_plot(mat, os.path.join(log_dir,
                                                     f'{name}_{i}.png'))
        metrics_log.images(images, at_step)

    step, means = start_step, None
    try:
        if test_items is not None:
            metrics_log.images({
                f'image_{i}/ground_truth': plotting.plot_tensor(item['y'].T)
                for i, item in enumerate(test_items)}, 0)
            for i, item in enumerate(test_items):
                plotting.save_plot(item['y'].T, os.path.join(
                    log_dir, f'original_{i}.png'))
        for epoch in range(n_epochs):
            t0 = time.time()
            for batch in loader:
                metrics = train_step(net, optimizer, batch_to(batch, device),
                                     cfg.out_size, cfg.train.grad_clip_norm,
                                     generator, cfg.train.remat_estimator)
                step += 1
                metrics_log.add(step, metrics)
                if max_steps is not None and step - start_step >= max_steps:
                    break
            means = metrics_log.end_epoch(epoch, time.time() - t0)
            if means is None:
                raise ValueError(
                    'the training data gave no batch: check '
                    f'data.train_filelist_path '
                    f'({cfg.data.train_filelist_path!r}) and batch_size '
                    f'({cfg.train.batch_size}) against the dataset size')
            if (epoch + 1) % cfg.train.save_every == 0:
                # the one-process layout: every rank gathers the blocks
                state_dict = full_state_dict(model)
                if test_items is not None:
                    log_previews(step, state_dict)
                save_checkpoint(ckpt_dir, step, {
                    'model': state_dict,
                    'optimizer': full_optimizer_state(optimizer, model),
                    'generator': generator.get_state()})
            if max_steps is not None and step - start_step >= max_steps:
                break
    finally:
        metrics_log.close()
    return TrainResult(step, model, optimizer, generator, means)
