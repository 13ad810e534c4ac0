"""The drives: how a traffic mix's calls reach the program, what work they
complete, and how the check holds the window's outputs to the reference.

A traffic file names its drive (``"drive"``): ``synthesize`` (text to mel,
``models/tts.py synthesize``), ``generate`` (the same, then the HiFi-GAN
generator of ``models/hifigan.py``), ``score`` (n-best likelihood,
``nbest/scoring.py score_batch``) or ``train`` (``train/state.py
train_step``). This is the only module of the benchmark that imports the
program (``gradtts_tpu_torch``).
"""

import math

import numpy as np
import torch

from benchmark import compare, counting, traffic, weights
from benchmark.reference import gradtts as ref
from benchmark.reference import hifigan as ref_voc

# configuration keys and where the program's preset holds each
PORT_KEYS = {
    'n_vocab': 'n_vocab', 'n_spks': 'n_spks', 'spk_emb_dim': 'spk_emb_dim',
    'n_enc_channels': 'encoder.n_enc_channels',
    'filter_channels': 'encoder.filter_channels',
    'filter_channels_dp': 'encoder.filter_channels_dp',
    'n_heads': 'encoder.n_heads', 'n_enc_layers': 'encoder.n_enc_layers',
    'enc_kernel': 'encoder.enc_kernel', 'window_size': 'encoder.window_size',
    'enc_dropout': 'encoder.enc_dropout', 'n_feats': 'data.n_feats',
    'sample_rate': 'data.sample_rate', 'hop_length': 'data.hop_length',
    'x_buckets': 'data.x_buckets', 'y_buckets': 'data.y_buckets',
    'dec_dim': 'decoder.dec_dim', 'beta_min': 'decoder.beta_min',
    'beta_max': 'decoder.beta_max', 'pe_scale': 'decoder.pe_scale',
    'learning_rate': 'train.learning_rate',
    'grad_clip_norm': 'train.grad_clip_norm', 'out_size': 'out_size',
}
VOCODER_SPAN = 'benchmark.vocoder'
SCORE_OUTPUT = ('decoder.estimator.final_conv.weight',
                'decoder.estimator.final_conv.bias')
SAMPLE_ROWS = 8


def _get(obj, path):
    for part in path.split('.'):
        obj = getattr(obj, part)
    return obj


def port_config(cfg, sizes):
    """The program's preset ``cfg['preset']`` with ``sizes`` (configuration
    keys, set in tests only) applied; raises if any configuration key
    differs from the preset's value."""
    from gradtts_tpu_torch.config import get_config
    over = {PORT_KEYS[k]: (tuple(v) if isinstance(v, list) else v)
            for k, v in sizes.items() if k in PORT_KEYS}
    pc = get_config(cfg['preset'], **over)
    diff = {k: (cfg[k], _get(pc, p)) for k, p in PORT_KEYS.items()
            if (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k])
            != _get(pc, p)}
    if diff:
        raise RuntimeError(f'the program\'s preset {cfg["preset"]!r} differs '
                           f'from the configuration file: {diff}')
    return pc


class Drive:
    """One cell's program state and calls. ``min_calls``: calls the window
    makes whatever its length (the check's sample lies among them);
    ``diagnostics``: numbers the check reads beside those it compares."""
    min_calls = 1
    diagnostics = {}

    def __init__(self, cfg, tr, seed, device):
        self.cfg, self.tr, self.device = cfg, tr, device
        self.dtype = getattr(torch, cfg['precision'])
        host = np.random.default_rng(seed)
        self.weight_seed, self.input_seed, self.draw_seed = (
            int(v) for v in host.integers(0, 2 ** 62, 3))
        self.rng = np.random.default_rng(int(host.integers(0, 2 ** 62)))
        self.reference = ref.GradTTS(cfg)

    def state_dict(self):
        """The seeded weights of both sides. A traffic's
        ``score_output_gain`` scales the score U-Net's output conv (see
        ``weights.py``)."""
        fixed = {'encoder.proj_w.proj.bias': self.cfg['duration_log_bias']}
        sd = weights.seeded_state_dict(weights.shapes_of(self.reference),
                                       self.weight_seed, self.device, fixed)
        gain = self.tr.get('score_output_gain', 1.0)
        for name in SCORE_OUTPUT:
            sd[name] *= gain
        return sd

    def program_model(self, sizes):
        from gradtts_tpu_torch.models.tts import GradTTS, set_compute_dtype
        with torch.device(self.device):
            model = GradTTS.from_config(port_config(self.cfg, sizes))
        model.load_state_dict(self.state_dict(), strict=True)
        return set_compute_dtype(model, self.dtype)

    def prepare(self):
        """The cell's inputs, from the seed (no program involved)."""
        self.inputs = traffic.make_inputs(self.tr, self.cfg, self.input_seed,
                                          self.device)

    def reference_model(self):
        model = self.reference.to(self.device)
        model.load_state_dict(self.state_dict(), strict=True)
        return model

    def peak_flops(self):
        return counting.PEAK_FLOPS[self.cfg['precision']]

    def meta_reference(self):
        return counting.meta_model(lambda: ref.GradTTS(self.cfg))

    def release(self):
        for name in ('model', 'optimizer', 'vocoder'):
            self.__dict__.pop(name, None)


class Synthesize(Drive):
    """Closed-loop batched synthesis: each call one batch of the pool, back
    to back. The check compares rows of two calls drawn from the seed among
    the first four, the longest row of each among them."""

    def prepare(self):
        super().prepare()
        self.keep = sorted(int(k) for k in self.rng.choice(4, 2, False))
        self.min_calls = self.keep[-1] + 1
        self.kept = {}
        self.frames = torch.zeros((), dtype=torch.long, device=self.device)

    def setup(self, sizes):
        self.prepare()
        self.model = self.program_model(sizes).eval()
        self.warm_up()

    def warm_up(self):
        self.run(self.inputs[0])

    def run(self, b):
        from gradtts_tpu_torch.models.tts import synthesize
        return synthesize(self.model, b['x'], b['x_lengths'],
                          self.tr['euler_steps'], self.tr['frame_budget'],
                          temperature=self.tr['temperature'],
                          noise=b['noise'], spk=b.get('spk'))

    def call(self, k):
        b = self.inputs[k % len(self.inputs)]
        res = self.run(b)
        self.frames += res.y_lengths.sum()
        if k in self.keep:
            self.kept[k] = (b, res, None)

    def work(self, calls):
        frames = int(self.frames)
        return {'audio_s': frames * self.cfg['hop_length']
                / self.cfg['sample_rate'], 'frames': frames,
                'rows': calls * self.tr['batch']}

    def rows(self, res):
        """The sampled rows of a call: the longest and seven drawn."""
        lengths = res.y_lengths.cpu().numpy()
        longest = int(lengths.argmax())
        rest = [i for i in range(len(lengths)) if i != longest]
        return [longest] + sorted(int(i) for i in self.rng.choice(
            rest, min(SAMPLE_ROWS, len(lengths)) - 1, False))

    def check(self):
        """The reference works out each sampled row's durations, path and
        mel prior from its own encoder, and its mel from that prior; the
        program's path is read only for ``dur_gap``. Gaps are taken over
        the frames that either side holds."""
        model = self.reference_model().eval()
        out = {'dur_gap': 0.0, 'mu_err': 0.0, 'mel_err': 0.0}
        budget = self.tr['frame_budget']
        for k in sorted(self.kept):
            b, res, wav = self.kept[k]
            idx = torch.tensor(self.rows(res), device=self.device)
            x, x_lengths = b['x'][idx], b['x_lengths'][idx]
            with torch.no_grad():
                mu_y, _, y_len, w = ref.mel_prior(model, x, x_lengths,
                                                  budget)
                y_mask = ref.sequence_mask(y_len, budget).float()[..., None]
                spk = model.speaker(b['spk'][idx]) if 'spk' in b else None
                mel = ref.euler_synthesis(model, mu_y, y_mask,
                                          b['noise'][idx],
                                          self.tr['euler_steps'],
                                          self.tr['temperature'], spk)
            either = torch.maximum(y_len, res.y_lengths[idx])
            frames = ref.sequence_mask(either, budget)[..., None]
            out['dur_gap'] = max(out['dur_gap'], compare.duration_gap(
                res.attn[idx].float(), w, x_lengths, budget))
            out['mu_err'] = max(out['mu_err'], compare.rel_max(
                res.encoder_outputs[idx], mu_y, frames))
            out['mel_err'] = max(out['mel_err'], compare.rel_max(
                res.decoder_outputs[idx], mel, frames))
            if wav is not None:
                out['wav_err'] = max(out.get('wav_err', 0.0),
                                     self.wave_err(wav[idx], mel, either))
        return out

    def flops_per_call(self):
        m = self.meta_reference()
        B, T = self.tr['batch'], self.tr['frame_budget']
        xb = int(self.inputs[0]['x'].shape[1])
        return counting.encoder_flops(m, B, xb) \
            + self.tr['euler_steps'] * counting.unet_flops(m, B, T)

    def kernel_bound_per_call(self):
        """{family: least seconds a call}."""
        return unet_bounds(self.cfg, self.tr['batch'],
                           self.tr['frame_budget'], ('K2', 'K3'),
                           self.tr['euler_steps'])


class Generate(Synthesize):
    """Synthesis as ``Synthesize``, then the HiFi-GAN V1 generator over the
    batch's mels at the frame budget (one shape), inside the benchmark's
    span ``benchmark.vocoder``. Audio counts each row's frames."""

    def prepare(self):
        super().prepare()
        self.ref_vocoder = ref_voc.Generator(self.cfg['vocoder'])

    def warm_up(self):
        from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
        with torch.device(self.device):
            self.vocoder = Generator(HiFiGANConfig.from_json(
                self.cfg['vocoder']))
        self.vocoder.load_state_dict(self.vocoder_state(), strict=True)
        self.vocoder.compute_dtype = self.dtype
        self.vocode(self.run(self.inputs[0]).decoder_outputs)

    def vocoder_state(self):
        return weights.seeded_state_dict(weights.shapes_of(self.ref_vocoder),
                                         self.weight_seed + 1, self.device)

    def vocode(self, mel):
        with torch.no_grad(), torch.profiler.record_function(VOCODER_SPAN):
            return self.vocoder(mel)

    def call(self, k):
        b = self.inputs[k % len(self.inputs)]
        res = self.run(b)
        wav = self.vocode(res.decoder_outputs)
        self.frames += res.y_lengths.sum()
        if k in self.keep:
            self.kept[k] = (b, res, wav)

    def wave_err(self, wav, mel, y_len):
        model = self.ref_vocoder.to(self.device)
        model.load_state_dict(self.vocoder_state(), strict=True)
        with torch.no_grad():
            want = model(mel)
        hop = want.shape[1] // mel.shape[1]
        mask = ref.sequence_mask(y_len * hop, want.shape[1])
        return compare.rel_max(wav, want, mask)

    def flops_per_call(self):
        meta = counting.meta_model(lambda: ref_voc.Generator(
            self.cfg['vocoder']))
        return super().flops_per_call() + counting.vocoder_flops(
            meta, self.tr['batch'], self.tr['frame_budget'],
            self.cfg['n_feats'])


class Score(Drive):
    """Closed-loop n-best rescoring: the list's calls back to back, again
    and again. The check compares the sampled rows (the longest hypothesis
    and seven drawn from the seed) of the window's first call: the
    integrator's z (the primal half of the jvp) by ``z_err``, and its
    tangent half by ``div_err``: the gap of delta_logp over the score
    U-Net's part of it (delta_logp less the linear term's exact part,
    ``ref.linear_divergence``), which K6, K7 and K1's tangent compute."""

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
                          self.tr['euler_steps'])
        cells = int((c['x_lengths'] * c['y_lengths']).sum())
        out['MAS'] = counting.bound_s(*counting.mas_work(B, xb, T, cells))
        return out


class Train(Drive):
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


def unet_bounds(cfg, B, T, attention, calls):
    """{family: least seconds} of ``calls`` U-Net passes at [B, T]."""
    out = {'K1': counting.kernel_bound_s((), B, cfg['n_feats'], T,
                                         cfg['dec_dim'], cfg['precision'],
                                         calls)}
    for k in attention:
        out[k] = counting.kernel_bound_s((k,), B, cfg['n_feats'], T,
                                         cfg['dec_dim'], cfg['precision'],
                                         calls) - out['K1']
    return out


DRIVES = {'synthesize': Synthesize, 'generate': Generate, 'score': Score,
          'train': Train}

