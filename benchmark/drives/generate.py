"""Text to waveform: synthesis as the ``synthesize`` drive, then the
program's HiFi-GAN generator (``models/hifigan.py``). The vocoder's
reference is ``reference/hifigan.py``, for the configuration's
``vocoder`` sizes."""

import torch

from benchmark import compare, counting, weights
from benchmark.drives.synthesize import Synthesize
from benchmark.reference import hifigan as ref_voc


class Generate(Synthesize):
    """Synthesis as ``Synthesize``, then the HiFi-GAN V1 generator over the
    batch's mels at the frame budget (one shape), which the program runs in
    its span ``gradtts.vocoder``. Audio counts each row's frames."""
    released = (*Synthesize.released, 'vocoder')

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
        with torch.no_grad():
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
        mask = self.ref.sequence_mask(y_len * hop, want.shape[1])
        return compare.rel_max(wav, want, mask)

    def reference_wave(self, res):
        voc = self.ref_vocoder.to(self.device)
        voc.load_state_dict(self.vocoder_state(), strict=True)
        return voc(res.decoder_outputs)

    def flops_per_call(self):
        meta = counting.meta_model(lambda: ref_voc.Generator(
            self.cfg['vocoder']))
        return super().flops_per_call() + counting.vocoder_flops(
            meta, self.tr['batch'], self.tr['frame_budget'],
            self.cfg['n_feats'])


Drive = Generate
