"""Acoustic training: the program's ``train/state.py train_step``."""

import math

import torch

from benchmark import compare, counting
from benchmark.drives.gradtts import TRAIN_STEP, GradTTSDrive, unet_bounds


class Train(GradTTSDrive):
    """Acoustic training: set-up builds the model and Adam, runs the first
    three steps on three pool batches through the same call as the window
    (their losses, the first gradient as Adam holds it and the change of
    the parameters after the three are kept for the check), and the window
    steps on through the pool.

    While those three steps run, forward hooks keep what each step's
    encoder returned (mu_x) and the alignment the step trained on (after
    its crop). With random weights and mels the MAS of a bf16 encoder and
    of an f32 one part ways in about half the rows (near-ties), which
    would swamp every gap; so the reference aligns each step by its own
    log-prior grid and NumPy MAS on the program's mu_x, which ``mu_gap``
    holds to the reference's own mu_x of every step. ``align_gap`` counts
    the cells where the program's alignment leaves the reference's."""
    root_span = TRAIN_STEP
    trains = True
    faults = ('half_batch',)
    checked_steps = 3

    def prepare(self):
        super().prepare()
        self.encoded = None

    def setup(self, sizes):
        from gradtts_tpu_torch.train.state import make_optimizer
        self.model = self.program_model(sizes).train()
        self.optimizer = make_optimizer(self.model.parameters(),
                                        self.cfg['learning_rate'])
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.draw_seed)
        self.prepare()
        params = dict(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        self.losses, self.encoded = [], []
        hooks = [self.model.encoder.register_forward_hook(
                     lambda mod, args, out: self.encoded.append(
                         {'mu_x': out[0].detach().transpose(1, 2).clone()})),
                 self.model.register_forward_hook(
                     lambda mod, args, out: self.encoded[-1].update(
                         attn=out.attn.detach().clone()))]
        try:
            for k in range(self.checked_steps):
                m = self.step(self.inputs[k])
                self.losses.append(tuple(m[n] for n in (
                    'loss/duration', 'loss/prior', 'loss/diffusion')))
                if k == 0:
                    # Adam's first moment after one step is (1 - 0.9) g
                    self.first_grad = {
                        n: self.optimizer.state.get(p, {}).get(
                            'exp_avg', torch.zeros_like(p)) / 0.1
                        for n, p in params.items()}
        finally:
            for h in hooks:
                h.remove()
        self.change = {n: p.detach() - start[n] for n, p in params.items()}
        self.losses = [tuple(float(v) for v in ls) for ls in self.losses]

    def step(self, batch):
        from gradtts_tpu_torch.train.state import train_step
        return train_step(self.model, self.optimizer, batch,
                          self.cfg['out_size'], self.cfg['grad_clip_norm'],
                          self.gen)

    def call(self, k):
        self.step(self.inputs[(self.checked_steps + k) % len(self.inputs)])

    def work(self, calls):
        return {'utterances': calls * self.tr['batch']}

    def check(self):
        batches = self.inputs[:self.checked_steps]
        # a step that saw other rows than its batch's aligns nothing the
        # reference can follow: the reference then aligns for itself
        whole = len(self.encoded) == self.checked_steps and all(
            e['mu_x'].shape[0] == b['x'].shape[0]
            for e, b in zip(self.encoded, batches))
        ref = self.ref
        model = self.reference_model().train()
        losses, grad, change, records = ref.train_steps(
            model, batches, self.draw_seed, self.device, self.checked_steps,
            [e['mu_x'] for e in self.encoded] if whole else None)
        keep = compare.moving_leaves(grad)
        grads = compare.leaf_gaps(self.first_grad, grad, keep)
        changes = compare.leaf_gaps(self.change, change, keep)
        # the median leaf's first gradient separates from neither the
        # control nor the half batch (PERF.md): read, not compared
        self.diagnostics = {'loss_gap': compare.loss_gap(self.losses, losses),
                            'grad_gap': compare.median(grads),
                            'grad_worst': grads[-1],
                            'change_worst': changes[-1]}
        out = {'loss1_gap': compare.loss_gap(self.losses[:1], losses[:1]),
               'change_gap': compare.median(changes),
               'mu_gap': math.inf, 'align_gap': math.inf}
        if whole:
            out['mu_gap'] = max(
                compare.rel_max(e['mu_x'], r['mu_x'], ref.sequence_mask(
                    b['x_lengths'], b['x'].shape[1])[:, None])
                for e, r, b in zip(self.encoded, records, batches))
            out['align_gap'] = float(sum(
                (e['attn'] != r['attn']).sum()
                for e, r in zip(self.encoded, records)))
        return out

    def fill_from_reference(self, model, what):
        """The reference's three steps on the set-up's batches (with
        ``half_batch``, on the first half of each batch's rows, the losses
        the mean over them)."""
        batches = self.inputs[:self.checked_steps]
        if what == 'half_batch':
            batches = [{k: v[:len(v) // 2] for k, v in b.items()}
                       for b in batches]
        self.losses, self.first_grad, self.change, self.encoded = \
            self.ref.train_steps(model, batches, self.draw_seed, self.device,
                                 self.checked_steps)

    def flops_per_call(self):
        m = self.meta_reference()
        b = self.inputs[0]
        B, xb = b['x'].shape
        yb = b['y'].shape[1]
        return counting.encoder_flops(m, B, xb, train=True) \
            + counting.grid_flops(B, xb, yb, self.cfg['n_feats']) \
            + counting.unet_flops(m, B, self.cfg['out_size'], 'train')

    def kernel_bound_per_call(self):
        b = self.inputs[0]
        B, xb = b['x'].shape
        yb = b['y'].shape[1]
        out = unet_bounds(self.cfg, B, self.cfg['out_size'],
                          ('K2', 'K3', 'K4', 'K5'), 1)
        cells = int((b['x_lengths'].long() * b['y_lengths'].long()).sum())
        out['MAS'] = counting.bound_s(*counting.mas_work(B, xb, yb, cells))
        return out


Drive = Train
