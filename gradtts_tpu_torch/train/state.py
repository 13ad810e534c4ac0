"""Optimizer, gradient clipping and one training step.

Counterpart of gradtts_tpu/train/state.py: Adam at 1e-4 (``torch.optim.Adam``
defaults equal ``optax.adam``'s: betas 0.9 and 0.999, eps 1e-8) and the
per-submodule clip of ``_subtree_clip`` (:25): the encoder's grads and the
U-Net's (``decoder.estimator``) are each clipped to a global norm of
``grad_clip_norm``. Every parameter and the Adam state stay f32 whatever
the compute dtype, as the JAX package keeps them; under tensor parallelism
each rank holds its blocks of both.
"""

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from gradtts_tpu_torch.models.layers import RowShard
from gradtts_tpu_torch.models.tts import GradTTS, loss_counts
from gradtts_tpu_torch.parallel.tensor import (share_replicated_grads,
                                               split_parameters)
from gradtts_tpu_torch.utils.profiling import span

METRICS = ('loss/total', 'loss/duration', 'loss/prior', 'loss/diffusion',
           'grad_norm/encoder', 'grad_norm/decoder')


def make_optimizer(params, learning_rate: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate)


def subtree_clip(model: GradTTS, max_norm: float):
    """Scales the grads of ``encoder`` and of ``decoder.estimator`` in place
    by min(1, max_norm / (norm + 1e-6)), each by its own global norm.
    Returns the two norms before clipping (0-d tensors). Where weights are
    split over the 'model' axis (``parallel.mesh.shard_model``), a norm
    is that of the whole model: the blocks' squared norms summed over the
    axis's ranks, plus the replicated parameters' counted once."""
    norms = []
    splits = split_parameters(model)
    for module in (model.encoder, model.decoder.estimator):
        params = [p for p in module.parameters() if p.grad is not None]
        blocks = [p.grad for p in params if id(p) in splits]
        if blocks:
            whole = [p.grad for p in params if id(p) not in splits]
            sq = torch.nn.utils.get_total_norm(blocks) ** 2
            dist.all_reduce(sq, group=next(iter(splits.values())).group)
            norm = (torch.nn.utils.get_total_norm(whole) ** 2 + sq).sqrt()
        else:
            norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        # scales by min(1, max_norm / (norm + 1e-6)), as _subtree_clip
        torch.nn.utils.clip_grads_with_norm_(params, max_norm, norm)
        norms.append(norm)
    return tuple(norms)


def train_step(model, optimizer, batch: dict, out_size,
               grad_clip_norm: float = 1.0, generator=None,
               remat: bool = False, draws=None) -> dict:
    """One step on ``batch`` ({'x', 'x_lengths', 'y', 'y_lengths'} and, for
    a model with speakers, 'spk', on the model's device): losses,
    backward, clip, Adam. The crop, the diffusion draws and (under
    ``train()``) the dropout masks come from ``generator``, except those
    of ``draws`` ({'offset', 't', 'z'}, :func:`compute_loss`'s inputs for
    these rows); ``remat`` recomputes the U-Net's forward in the backward.
    Returns the six metrics of the JAX step (:110-117) as 0-d tensors on
    the device, not fetched.

    ``model`` is a :class:`GradTTS` or a ``DistributedDataParallel`` of
    one over the 'data' axis, whose ranks hold the blocks of a global
    batch. There every rank draws at the global batch's shape from the
    same generator and keeps its rows (``RowShard``); the losses are this
    rank's sums over the global batch's counts (one ``all_reduce`` of
    :func:`loss_counts`), scaled by the rank count so that DDP's mean of
    the gradients is the gradient of the global losses, as under the JAX
    package's mesh; the clip sees those averaged gradients, so both norms
    and the parameters stay the same on every rank; and the losses
    reported are the global ones (an ``all_reduce`` of the three).

    Under tensor parallelism the module's weights are split over the
    'model' axis (``parallel.mesh.shard_model``) and DDP's group is the
    'data' axis: the ranks of one 'model' group hold the same rows, make
    the same draws and compute the same losses; the gradients of the
    parameters they hold whole are the first rank's on every rank
    (``share_replicated_grads``), the clip's norms are the whole model's
    (:func:`subtree_clip`), and Adam, elementwise, steps each rank's
    blocks as one process steps those elements."""
    with span('gradtts.train_step'):
        net, counts, ranks = model, None, 1
        if isinstance(model, DistributedDataParallel):
            net, group = model.module, model.process_group
            ranks = dist.get_world_size(group)
            generator = RowShard(generator, dist.get_rank(group), ranks)
            counts = loss_counts(batch['x_lengths'], batch['y_lengths'],
                                 batch['y'].shape[1], out_size)
            dist.all_reduce(counts, group=group)
        optimizer.zero_grad(set_to_none=True)
        with span('gradtts.train.forward'):
            res = model(batch['x'], batch['x_lengths'], batch['y'],
                        batch['y_lengths'], out_size=out_size,
                        generator=generator, spk=batch.get('spk'), remat=remat,
                        counts=counts, **(draws or {}))
            total = res.dur_loss + res.prior_loss + res.diff_loss
        with span('gradtts.train.backward'):
            (total if counts is None else total * ranks).backward()
        with span('gradtts.train.optimizer'):
            share_replicated_grads(net)
            enc_norm, dec_norm = subtree_clip(net, grad_clip_norm)
            optimizer.step()
        losses = (res.dur_loss, res.prior_loss, res.diff_loss)
        if counts is not None:
            losses = torch.stack(losses).detach()
            dist.all_reduce(losses, group=group)
            total = losses[0] + losses[1] + losses[2]
        values = (total, *losses, enc_norm, dec_norm)
        return {k: v.detach() for k, v in zip(METRICS, values)}
