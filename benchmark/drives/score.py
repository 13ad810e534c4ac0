"""n-best likelihood: the program's ``nbest/scoring.py score_batch``."""

import torch

from benchmark import compare, counting
from benchmark.drives.gradtts import (SAMPLE_ROWS, SCORE, GradTTSDrive,
                                      unet_bounds)


class Score(GradTTSDrive):
    """Closed-loop n-best rescoring: the list's calls back to back, again
    and again. The check compares the sampled rows (the longest hypothesis
    and seven drawn from the seed) of the window's first call: the
    integrator's z (the primal half of the jvp) by ``z_err``, and its
    tangent half by ``div_err``: the gap of delta_logp over the score
    U-Net's part of it (delta_logp less the linear term's exact part,
    ``linear_divergence`` of the reference), which K6, K7 and K1's tangent
    compute."""
    root_span = SCORE

    def prepare(self):
        super().prepare()
        self.keep, self.kept = 0, None

    def setup(self, sizes):
        self.prepare()
        self.model = self.program_model(sizes).eval()
        self.run(self.inputs[0], 2)

    def run(self, c, steps):
        from gradtts_tpu_torch.nbest.scoring import score_batch
        return score_batch(self.model, c['x'], c['x_lengths'], c['y'],
                           c['y_lengths'], n_euler=steps,
                           epsilon=c['epsilon'], spk=c.get('spk'))

    def call(self, k):
        c = self.inputs[k % len(self.inputs)]
        res = self.run(c, self.tr['euler_steps'])
        if k == self.keep:
            self.kept = (c, res)

    def work(self, calls):
        return {'hypotheses': calls * self.tr['batch']}

    def check(self):
        ref = self.ref
        c, res = self.kept
        lengths = c['x_lengths'].cpu().numpy()
        longest = int(lengths.argmax())
        rest = [i for i in range(len(lengths)) if i != longest]
        idx = [longest] + sorted(int(i) for i in self.rng.choice(
            rest, min(SAMPLE_ROWS, len(lengths)) - 1, False))
        idx = torch.tensor(idx, device=self.device)
        model = self.reference_model().eval()
        with torch.no_grad():
            want = ref.likelihood(
                model, c['x'][idx], c['x_lengths'][idx], c['y'][idx],
                c['y_lengths'][idx], c['epsilon'][idx],
                self.tr['euler_steps'], c['spk'][idx] if 'spk' in c else None)
        y_mask = ref.sequence_mask(c['y_lengths'][idx],
                                   c['y'].shape[1])[..., None]
        n = want.z[0].numel()
        unet = want.delta_logp - ref.linear_divergence(
            c['y_lengths'][idx], c['epsilon'][idx], self.tr['euler_steps'],
            self.cfg)
        self.diagnostics = {
            'score_err': compare.rel_range(res.score[idx], want.score),
            'prior_err': compare.rel_max(
                compare.event_part(res.prior_logp[idx], n),
                compare.event_part(want.prior_logp, n)),
            'unet_share': float(unet.abs().max()
                                / want.delta_logp.abs().max())}
        return {'z_err': compare.rel_max(res.z[idx], want.z, y_mask),
                'div_err': compare.gap_over(res.delta_logp[idx],
                                            want.delta_logp, unet)}

    def fill_from_reference(self, model, what):
        """The reference's likelihood of the kept call's rows."""
        c = self.inputs[self.keep]
        with torch.no_grad():
            self.kept = (c, self.ref.likelihood(
                model, c['x'], c['x_lengths'], c['y'], c['y_lengths'],
                c['epsilon'], self.tr['euler_steps'], c.get('spk')))

    def flops_per_call(self):
        m = self.meta_reference()
        c = self.inputs[0]
        B, xb = c['x'].shape
        T = c['y'].shape[1]
        return counting.encoder_flops(m, B, xb) \
            + counting.grid_flops(B, xb, T, self.cfg['n_feats']) \
            + self.tr['euler_steps'] * counting.unet_flops(m, B, T, 'jvp')

    def kernel_bound_per_call(self):
        c = self.inputs[0]
        B, xb = c['x'].shape
        T = c['y'].shape[1]
        out = unet_bounds(self.cfg, B, T, ('K2', 'K3', 'K6', 'K7'),
                          self.tr['euler_steps'], conv_passes=2)
        cells = int((c['x_lengths'] * c['y_lengths']).sum())
        out['MAS'] = counting.bound_s(*counting.mas_work(B, xb, T, cells))
        return out


Drive = Score
