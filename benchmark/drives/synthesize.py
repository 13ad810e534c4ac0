"""Text to mel: the program's ``models/tts.py synthesize``."""

import torch

from benchmark import compare, counting
from benchmark.drives.gradtts import (SAMPLE_ROWS, SYNTHESIZE, GradTTSDrive,
                                      unet_bounds)


class Synthesize(GradTTSDrive):
    """Closed-loop batched synthesis: each call one batch of the pool, back
    to back. The check compares rows of two calls drawn from the seed among
    the first four, the longest row of each among them."""
    root_span = SYNTHESIZE

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
        ref = self.ref
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

    def fill_from_reference(self, model, what):
        """The reference's synthesis of each kept call's batch."""
        tr = self.tr
        with torch.no_grad():
            for k in self.keep:
                b = self.inputs[k % len(self.inputs)]
                res = self.ref.synthesize(
                    model, b['x'], b['x_lengths'], tr['euler_steps'],
                    tr['frame_budget'], tr['temperature'], b['noise'],
                    b.get('spk'))
                self.kept[k] = (b, res, self.reference_wave(res))

    def reference_wave(self, res):
        return None

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


Drive = Synthesize
