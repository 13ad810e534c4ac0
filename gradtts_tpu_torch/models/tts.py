"""GradTTS: the text-to-mel model, its synthesis, its training losses and
the score closure of likelihood scoring.

Counterpart of gradtts_tpu/models/tts.py (``GradTTS`` :33, ``synthesize``
:145-211, ``_log_prior_grid`` :214, ``compute_loss`` :234-301,
``get_score_fn`` :304-336). Submodules ``encoder``, ``decoder.estimator``
and ``spk_emb`` carry the reference torch ``state_dict`` layout, so a
reference ``.pt`` file loads with ``load_state_dict(strict=True)``.
Layouts at the public functions are the JAX package's: text ids [B, Tx],
mels [B, Ty, F], speakers ``spk`` as int ids [B] (``n_spks > 1``) or
vectors [B, spk_emb_dim] (``n_spks == -1``).
"""

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from gradtts_tpu_torch.config import GradTTSConfig
from gradtts_tpu_torch.models.diffusion import (Diffusion, diffusion_loss,
                                                reverse_diffusion,
                                                reverse_diffusion_dpm)
from gradtts_tpu_torch.models.layers import draw
from gradtts_tpu_torch.models.text_encoder import TextEncoder
from gradtts_tpu_torch.ops.mas import maximum_path
from gradtts_tpu_torch.ops.seq import (duration_loss, generate_path,
                                       sequence_mask)
from gradtts_tpu_torch.utils.profiling import span


class GradTTS(nn.Module):
    """GradTTS in every speaker set-up of the JAX package: ``n_spks`` 1 (one
    speaker), > 1 (an ``spk_emb`` table of speaker ids) or -1 (external
    speaker vectors). The speaker conditions the U-Net; with
    ``encoder_speaker`` (the upstream wiring, ``n_spks > 1``) it also
    enters the encoder after the prenet, as the fork does not."""

    def __init__(self, n_vocab: int, n_enc_channels: int = 192,
                 filter_channels: int = 768, filter_channels_dp: int = 256,
                 n_heads: int = 2, n_enc_layers: int = 6, enc_kernel: int = 3,
                 window_size: int = 4, n_feats: int = 80, dec_dim: int = 64,
                 beta_min: float = 0.05, beta_max: float = 20.0,
                 pe_scale: float = 1000.0, enc_dropout: float = 0.1,
                 n_spks: int = 1, spk_emb_dim: int = 64,
                 encoder_speaker: bool = False):
        super().__init__()
        self.n_feats = n_feats
        self.n_spks = n_spks
        if n_spks > 1:
            self.spk_emb = nn.Embedding(n_spks, spk_emb_dim)
        self.encoder = TextEncoder(n_vocab, n_feats, n_enc_channels,
                                   filter_channels, filter_channels_dp,
                                   n_heads, n_enc_layers, enc_kernel,
                                   window_size, enc_dropout,
                                   n_spks if encoder_speaker else 1,
                                   spk_emb_dim)
        self.decoder = Diffusion(n_feats, dec_dim, beta_min, beta_max,
                                 pe_scale, n_spks, spk_emb_dim)

    @classmethod
    def from_config(cls, cfg: GradTTSConfig) -> 'GradTTS':
        e, d = cfg.encoder, cfg.decoder
        return cls(cfg.n_vocab, e.n_enc_channels, e.filter_channels,
                   e.filter_channels_dp, e.n_heads, e.n_enc_layers,
                   e.enc_kernel, e.window_size, cfg.data.n_feats, d.dec_dim,
                   d.beta_min, d.beta_max, d.pe_scale, e.enc_dropout,
                   cfg.n_spks, cfg.spk_emb_dim, cfg.encoder_speaker)

    def embed_speaker(self, spk):
        """(``embed_speaker`` :106) the ``spk_emb`` row of each id [B] with
        ``n_spks > 1``, the vectors [B, D] themselves with -1 (f32), and
        None with one speaker."""
        if self.n_spks > 1:
            if spk is None:
                raise ValueError(f'a {self.n_spks}-speaker model needs the '
                                 'speaker ids spk')
            return self.spk_emb(spk.long())
        if self.n_spks == -1 and spk is not None:
            return spk.float()
        return None

    def encode(self, x, x_lengths, generator=None, spk_vec=None):
        """-> f32 (mu_x [B, Tx, F], logw [B, Tx, 1], x_mask [B, Tx, 1]).
        ``generator`` draws the dropout masks under ``train()``; ``spk_vec``
        is the speaker as :meth:`embed_speaker` returns it."""
        with span('gradtts.encoder'):
            return self.encoder(x, x_lengths, generator, spk_vec)

    def estimate(self, x_t, mask, mu, t, spk_vec=None):
        """Score estimate [B, Ty, F] (f32) for x_t, mu [B, Ty, F], mask
        [B, Ty], t [B]; ``spk_vec`` as in :meth:`encode`."""
        return self.decoder.estimator(x_t, mask, mu, t, spk_vec)

    def forward(self, x, x_lengths, y, y_lengths, **kwargs) -> 'LossResult':
        """The training losses, :func:`compute_loss` of this model: a
        ``DistributedDataParallel`` wrapper sees the step's forward here."""
        return compute_loss(self, x, x_lengths, y, y_lengths, **kwargs)


def set_compute_dtype(model: GradTTS, dtype: torch.dtype) -> GradTTS:
    """Runs the model's compute in ``dtype`` where the JAX package runs its
    compute dtype: the convolutions of the encoder trunk and of the U-Net,
    and the U-Net's attention projections (their f32 weights are cast at
    each call, see ``models/layers.py``). Embeddings, norms, the time MLPs,
    the ReZero gains and the encoder's output heads stay f32, as there.
    Every parameter stays f32, so training and synthesis share this one
    way to run bf16."""
    model.encoder.compute_dtype = dtype
    model.decoder.estimator.compute_dtype = dtype
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
               generator=None, stoc: bool = False, spk=None,
               sampler: str = 'euler', stoc_noise=None) -> SynthesisResult:
    """Text -> mel (``synthesize`` :145).

    Runs on the device of the model and of ``x``. ``y_max_length`` is the
    padded frame budget (a multiple of 4); frames past the predicted length
    are masked. Fork quirk kept: ``length_scale`` multiplies the ceil'd
    durations, each sequence gets at least 1 and at most ``y_max_length``
    frames (:180-183). ``noise`` [B, y_max_length, F] is the standard normal
    draw; when None it is drawn from ``generator``.

    ``sampler`` 'euler' runs ``reverse_diffusion``, the probability-flow
    ODE or, with ``stoc``, the SDE, whose per-step draws are ``stoc_noise``
    [n_timesteps, B, y_max_length, F] (drawn from ``generator`` when None);
    'dpm' runs ``reverse_diffusion_dpm`` and ignores ``stoc``, as the JAX
    package does. ``spk``: speaker ids [B] or vectors [B, D].
    """
    if sampler not in ('euler', 'dpm'):
        raise ValueError(f'unknown sampler {sampler!r}: euler or dpm')
    with span('gradtts.synthesize'):
        spk_vec = model.embed_speaker(spk)
        mu_x, logw, x_mask = model.encode(x, x_lengths, spk_vec=spk_vec)
        with span('gradtts.align'):
            w = torch.exp(logw[..., 0]) * x_mask[..., 0]         # [B, Tx]
            w_ceil = torch.ceil(w) * length_scale
            y_lengths = torch.clamp(w_ceil.sum(dim=1), min=1.0)
            y_lengths = torch.clamp(y_lengths,
                                    max=y_max_length).to(torch.int32)
            y_mask = sequence_mask(y_lengths,
                                   y_max_length)[..., None].to(mu_x.dtype)
            attn_mask = x_mask[:, :, 0, None] * y_mask[:, None, :, 0]
            attn = generate_path(w_ceil, attn_mask)              # [B, Tx, Ty]
            mu_y = torch.einsum('bxy,bxf->byf', attn, mu_x)

        if noise is None:
            noise = torch.randn(mu_y.shape, generator=generator,
                                dtype=mu_y.dtype, device=mu_y.device)
        z = mu_y + noise.to(mu_y) / temperature
        dec_args = (model.decoder.estimator, z, y_mask, mu_y, n_timesteps,
                    model.decoder.beta_min, model.decoder.beta_max)
        if sampler == 'dpm':
            dec = reverse_diffusion_dpm(*dec_args, spk=spk_vec)
        else:
            dec = reverse_diffusion(*dec_args, stoc=stoc, spk=spk_vec,
                                    noise=stoc_noise, generator=generator)
        return SynthesisResult(mu_y * y_mask, dec * y_mask, attn, y_lengths,
                               y_mask)


def _log_prior_grid(y, mu_x):
    """log N(y_frame; mu_token, I) for every (token, frame) pair as one
    matmul (``_log_prior_grid`` :214). y [B, Ty, F], mu_x [B, Tx, F] ->
    [B, Tx, Ty] f32."""
    const = -0.5 * math.log(2 * math.pi) * y.shape[-1]
    cross = mu_x @ y.transpose(1, 2)
    y_sq = -0.5 * torch.sum(y ** 2, dim=-1)                     # [B, Ty]
    mu_sq = -0.5 * torch.sum(mu_x ** 2, dim=-1)                 # [B, Tx]
    return cross + y_sq[:, None, :] + mu_sq[:, :, None] + const


class LossResult(NamedTuple):
    dur_loss: torch.Tensor
    prior_loss: torch.Tensor
    diff_loss: torch.Tensor
    attn: torch.Tensor             # [B, Tx, Ty or out_size], no grad


def crop_offsets(y_lengths, out_size: int, generator=None):
    """Per-item crop start, drawn as ``compute_loss`` :266-269 draws it:
    a 30-bit integer modulo max(y_length - out_size, 1), 0 where the item
    is no longer than the crop. ``generator``: a ``torch.Generator`` or a
    ``RowShard``."""
    max_offset = (y_lengths - out_size).clamp_min(0)
    rand = draw(functools.partial(torch.randint, 0, 1 << 30),
                y_lengths.shape, generator, device=y_lengths.device)
    return torch.where(max_offset > 0, rand % max_offset.clamp_min(1), 0)


def loss_counts(x_lengths, y_lengths, y_max_length: int,
                out_size: Optional[int] = None) -> torch.Tensor:
    """[2] f32: the tokens and the mel frames (after the crop to
    ``out_size`` where it is shorter than ``y_max_length``) of a batch,
    the counts that :func:`compute_loss` normalizes by. Summed over the
    ranks of a data-parallel step, they are the global batch's."""
    frames = y_lengths
    if out_size is not None and out_size < y_max_length:
        frames = y_lengths.clamp_max(out_size)
    return torch.stack([x_lengths.sum(), frames.sum()]).float()


def compute_loss(model: GradTTS, x, x_lengths, y, y_lengths,
                 out_size: Optional[int] = None, offset=None, t=None, z=None,
                 generator=None, spk=None, remat: bool = False,
                 counts=None) -> LossResult:
    """Duration + prior + diffusion losses (``compute_loss`` :234).

    x [B, Tx] ids; y [B, Ty, F] mels; ``spk`` speaker ids [B] or vectors
    [B, D] where the model has speakers. The random draws are inputs: the crop
    ``offset`` [B] (used when ``out_size`` < Ty), the diffusion time ``t``
    [B] and noise ``z`` [B, out_size or Ty, F]; each that is None is drawn
    from ``generator``, which also draws the encoder's dropout masks under
    ``train()``. The alignment is MAS on the log-prior grid, without grad;
    the per-item crop is one batched gather. ``remat`` keeps none of the
    U-Net's activations between its forward and its backward, which runs
    the forward again (``jax.checkpoint`` at :291-292): the same
    gradients; as one segment around the whole U-Net, it frees memory
    only while the rest of the step runs.

    ``counts`` [2], the global batch's :func:`loss_counts` where this
    process holds a part of it, are the losses' normalizers (tokens;
    frames, times the features for the prior and diffusion losses), as
    the JAX package's losses are means over the global batch under its
    mesh (:299); each loss is then this part's sum over the global count.
    None: this batch's own counts. ``generator`` may be a ``RowShard``,
    which draws the crop, ``t``, ``z`` and the dropout masks at the
    global batch's shape and keeps this part's rows."""
    spk_vec = model.embed_speaker(spk)
    mu_x, logw, x_mask = model.encode(x, x_lengths, generator, spk_vec)
    y_max_length = y.shape[1]
    # the duration loss lies between MAS and the crop: the span holds it too
    with span('gradtts.align'):
        y_mask = sequence_mask(y_lengths, y_max_length)[..., None].to(x_mask)
        attn_mask = x_mask[:, :, None, 0] * y_mask[:, None, :, 0]
        with torch.no_grad():
            attn = maximum_path(_log_prior_grid(y, mu_x).contiguous(),
                                attn_mask.contiguous())      # [B, Tx, Ty]

        logw_hat = torch.log(1e-8 + torch.sum(attn, dim=-1))[..., None] \
            * x_mask
        n_tokens, n_frames = (None, None) if counts is None else counts
        dur = duration_loss(logw, logw_hat, x_lengths, n_tokens)

        if out_size is not None and out_size < y_max_length:
            if offset is None:
                offset = crop_offsets(y_lengths, out_size, generator)
            # as dynamic_slice, a start past Ty - out_size is clamped
            offset = offset.clamp(0, y_max_length - out_size)
            frames = offset[:, None] + torch.arange(out_size,
                                                    device=y.device)
            y = torch.gather(y, 1,
                             frames[:, :, None].expand(-1, -1, y.shape[2]))
            attn = torch.gather(
                attn, 2, frames[:, None, :].expand(-1, attn.shape[1], -1))
            y_mask = sequence_mask(y_lengths.clamp_max(out_size),
                                   out_size)[..., None].to(y_mask)
            y = y * y_mask
            attn = attn * y_mask[:, None, :, 0]

        mu_y = torch.einsum('bxy,bxf->byf', attn, mu_x)
    estimator = model.decoder.estimator
    if remat:
        # the U-Net draws nothing at random: no RNG state to stash
        estimator = functools.partial(
            torch.utils.checkpoint.checkpoint, estimator,
            use_reentrant=False, preserve_rng_state=False)
    diff, _, _ = diffusion_loss(estimator, y, y_mask, mu_y,
                                model.decoder.beta_min, model.decoder.beta_max,
                                t=t, z=z, generator=generator, spk=spk_vec,
                                count=None if counts is None
                                else n_frames * model.n_feats)
    prior = torch.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi))
                      * y_mask)
    if n_frames is None:
        n_frames = torch.sum(y_mask)
    prior = prior / (n_frames * model.n_feats)
    return LossResult(dur, prior, diff, attn)


def get_score_fn(model: GradTTS, x, x_lengths, y, y_lengths, spk=None):
    """Score closure for (text hypothesis, real mel) pairs (``get_score_fn``
    :304): encodes x [B, Tx], aligns the real mels y [B, Ty, F] to the
    tokens by MAS on the log-prior grid (no grad) and returns (score_fn,
    mu_y [B, Ty, F], y_mask [B, Ty, 1]); score_fn(x_t, t) is the U-Net's
    score conditioned on mu_y and the speaker ``spk`` (ids [B] or vectors
    [B, D])."""
    spk_vec = model.embed_speaker(spk)
    mu_x, _logw, x_mask = model.encode(x, x_lengths, spk_vec=spk_vec)
    with span('gradtts.align'):
        y_mask = sequence_mask(y_lengths, y.shape[1])[..., None].to(x_mask)
        attn_mask = x_mask[:, :, None, 0] * y_mask[:, None, :, 0]
        with torch.no_grad():
            attn = maximum_path(_log_prior_grid(y, mu_x).contiguous(),
                                attn_mask.contiguous())      # [B, Tx, Ty]
        mu_y = torch.einsum('bxy,bxf->byf', attn, mu_x)
        mask = y_mask[..., 0]

    def score_fn(x_t, t):
        return model.estimate(x_t, mask, mu_y, t, spk_vec)

    return score_fn, mu_y, y_mask
