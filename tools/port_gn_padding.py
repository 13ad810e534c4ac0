"""How far the score U-Net's output moves with the precision of its
GroupNorm statistics, as a frame budget fills with padding.

    python3 tools/port_gn_padding.py

The reference's GroupNorm (gradtts_tpu/ops/pallas/groupnorm_mish.py:133,
copied by the port's ``groupnorm_mish_plain``) takes single-pass f32
statistics, E[x^2] - E[x]^2, over every frame of the budget, masked ones
included; a padded frame holds the convolution's bias. Runs on the CPU at
the port's tiny test widths (a 16-channel U-Net, weights drawn from a seed
as ``chip_smoke.seeded_state_dict`` draws them) and prints, for each
(budget T, real frames), the largest difference between the f32 U-Net and
the same U-Net whose GroupNorm statistics are two-pass f64, over the
largest output value. Both packages compute the f32 formula, so where it
moves this much, they part by as much as their summation orders differ.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import seeded_state_dict  # noqa: E402
from gradtts_tpu_torch.config import get_config  # noqa: E402
from gradtts_tpu_torch.models.tts import GradTTS  # noqa: E402
from gradtts_tpu_torch.ops import groupnorm_mish as gn  # noqa: E402

CASES = ((64, 64), (64, 33), (128, 33), (256, 33), (256, 200), (256, 256))


def groupnorm_mish_f64(x, mask, gamma, beta, groups=8, eps=1e-5):
    """The plain version with two-pass f64 statistics."""
    B, F, T, C = x.shape
    x64 = x.double().reshape(B, F * T, groups, C // groups)
    mean = x64.mean(dim=(1, 3), keepdim=True)
    var = ((x64 - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((x64 - mean) / torch.sqrt(var + eps)
         * gamma.double().reshape(1, 1, groups, -1)
         + beta.double().reshape(1, 1, groups, -1)).reshape(B, F, T, C)
    return (gn.mish_f32(y.float()) * mask.float()).to(x.dtype)


def main():
    torch.set_num_threads(1)
    cfg = get_config('ljspeech', **{'encoder.n_enc_channels': 32,
                                    'encoder.filter_channels': 64,
                                    'encoder.filter_channels_dp': 16,
                                    'encoder.n_enc_layers': 2,
                                    'decoder.dec_dim': 16})
    model = GradTTS.from_config(cfg)
    model.load_state_dict(seeded_state_dict(model, seed=0), strict=True)
    model.eval()
    rng = np.random.default_rng(0)
    plain = gn.groupnorm_mish_plain
    out = {}
    for t, real in CASES:
        mask = (np.arange(t) < real).astype(np.float32)[None]
        mu = rng.standard_normal((1, t, 80)).astype(np.float32) \
            * mask[..., None]
        x_t = (mu + rng.standard_normal((1, t, 80)).astype(np.float32)) \
            * mask[..., None]
        args = [torch.from_numpy(a) for a in
                (x_t, mask, mu, np.array([0.7], np.float32))]
        try:
            with torch.no_grad():
                gn.groupnorm_mish_plain = plain
                f32 = model.estimate(*args)
                gn.groupnorm_mish_plain = groupnorm_mish_f64
                f64 = model.estimate(*args)
        finally:
            gn.groupnorm_mish_plain = plain
        out[f'T {t}, {real} real'] = float((f32 - f64).abs().max()
                                           / f64.abs().max())
    print(json.dumps({'device': 'cpu', 'moved_of_largest': out}))


if __name__ == '__main__':
    main()
