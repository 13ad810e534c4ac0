"""GradTTS: the text-to-mel model and its synthesis.

Counterpart of gradtts_tpu/models/tts.py (``GradTTS`` :33, ``synthesize``
:145-211). Submodules ``encoder`` and ``decoder.estimator`` carry the
reference torch ``state_dict`` layout, so a reference ``.pt`` file loads
with ``load_state_dict(strict=True)``. Layouts at the public functions are
the JAX package's: text ids [B, Tx], mels [B, Ty, F].
"""

from typing import NamedTuple

import torch
from torch import nn

from gradtts_tpu_torch.config import GradTTSConfig
from gradtts_tpu_torch.models.diffusion import Diffusion, reverse_diffusion
from gradtts_tpu_torch.models.layers import ChannelLayerNorm
from gradtts_tpu_torch.models.text_encoder import TextEncoder
from gradtts_tpu_torch.ops.seq import generate_path, sequence_mask


class GradTTS(nn.Module):
    """Single-speaker GradTTS with the fork's wiring (no speaker input to the
    encoder). Other speaker set-ups are not ported yet."""

    def __init__(self, n_vocab: int, n_enc_channels: int = 192,
                 filter_channels: int = 768, filter_channels_dp: int = 256,
                 n_heads: int = 2, n_enc_layers: int = 6, enc_kernel: int = 3,
                 window_size: int = 4, n_feats: int = 80, dec_dim: int = 64,
                 beta_min: float = 0.05, beta_max: float = 20.0,
                 pe_scale: float = 1000.0):
        super().__init__()
        self.n_feats = n_feats
        self.encoder = TextEncoder(n_vocab, n_feats, n_enc_channels,
                                   filter_channels, filter_channels_dp,
                                   n_heads, n_enc_layers, enc_kernel,
                                   window_size)
        self.decoder = Diffusion(n_feats, dec_dim, beta_min, beta_max,
                                 pe_scale)

    @classmethod
    def from_config(cls, cfg: GradTTSConfig) -> 'GradTTS':
        if cfg.n_spks != 1 or cfg.encoder_speaker:
            raise NotImplementedError(
                f'preset {cfg.name!r}: n_spks={cfg.n_spks}, encoder_speaker='
                f'{cfg.encoder_speaker}; the port runs single-speaker models '
                'only so far')
        e, d = cfg.encoder, cfg.decoder
        return cls(cfg.n_vocab, e.n_enc_channels, e.filter_channels,
                   e.filter_channels_dp, e.n_heads, e.n_enc_layers,
                   e.enc_kernel, e.window_size, cfg.data.n_feats, d.dec_dim,
                   d.beta_min, d.beta_max, d.pe_scale)

    def encode(self, x, x_lengths):
        """-> f32 (mu_x [B, Tx, F], logw [B, Tx, 1], x_mask [B, Tx, 1])."""
        return self.encoder(x, x_lengths)

    def estimate(self, x_t, mask, mu, t):
        """Score estimate [B, Ty, F] (f32) for x_t, mu [B, Ty, F], mask
        [B, Ty], t [B]."""
        return self.decoder.estimator(x_t, mask, mu, t)


_F32_IN_COMPUTE = (nn.Linear, nn.GroupNorm, nn.Embedding, ChannelLayerNorm)


def set_compute_dtype(model: GradTTS, dtype: torch.dtype) -> GradTTS:
    """Casts in place the weights that the JAX package runs in its compute
    dtype: the convolutions of the encoder trunk and of the U-Net, and the
    U-Net's attention projections. Embeddings, norms, the time MLPs, the
    ReZero gains and the encoder's output heads stay f32, as there."""
    heads = {model.encoder.proj_m, *model.encoder.proj_w.modules()}
    for module in [*model.encoder.modules(), *model.decoder.modules()]:
        if module in heads or isinstance(module, _F32_IN_COMPUTE):
            continue
        for name, p in module.named_parameters(recurse=False):
            if name in ('weight', 'bias'):
                p.data = p.data.to(dtype)
    return model


class SynthesisResult(NamedTuple):
    encoder_outputs: torch.Tensor  # mu_y [B, Ty, F]
    decoder_outputs: torch.Tensor  # sampled mel [B, Ty, F]
    attn: torch.Tensor             # [B, Tx, Ty]
    y_lengths: torch.Tensor        # [B] int32 frame counts
    y_mask: torch.Tensor           # [B, Ty, 1]


@torch.no_grad()
def synthesize(model: GradTTS, x, x_lengths, n_timesteps: int,
               y_max_length: int, temperature: float = 1.0,
               length_scale: float = 1.0, noise=None,
               generator=None) -> SynthesisResult:
    """Text -> mel with the Euler ODE sampler (``synthesize`` :145).

    Runs on the device of the model and of ``x``. ``y_max_length`` is the
    padded frame budget (a multiple of 4); frames past the predicted length
    are masked. Fork quirk kept: ``length_scale`` multiplies the ceil'd
    durations, each sequence gets at least 1 and at most ``y_max_length``
    frames (:180-183). ``noise`` [B, y_max_length, F] is the standard normal
    draw; when None it is drawn from ``generator``.
    """
    mu_x, logw, x_mask = model.encode(x, x_lengths)
    w = torch.exp(logw[..., 0]) * x_mask[..., 0]                 # [B, Tx]
    w_ceil = torch.ceil(w) * length_scale
    y_lengths = torch.clamp(w_ceil.sum(dim=1), min=1.0)
    y_lengths = torch.clamp(y_lengths, max=y_max_length).to(torch.int32)

    y_mask = sequence_mask(y_lengths, y_max_length)[..., None].to(mu_x.dtype)
    attn_mask = x_mask[:, :, 0, None] * y_mask[:, None, :, 0]    # [B, Tx, Ty]
    attn = generate_path(w_ceil, attn_mask)
    mu_y = torch.einsum('bxy,bxf->byf', attn, mu_x)

    if noise is None:
        noise = torch.randn(mu_y.shape, generator=generator,
                            dtype=mu_y.dtype, device=mu_y.device)
    z = mu_y + noise.to(mu_y) / temperature
    dec = reverse_diffusion(model.decoder.estimator, z, y_mask, mu_y,
                            n_timesteps, model.decoder.beta_min,
                            model.decoder.beta_max)
    return SynthesisResult(mu_y * y_mask, dec * y_mask, attn, y_lengths,
                           y_mask)
