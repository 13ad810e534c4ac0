"""Text encoder: phoneme embedding -> conv prenet -> relative-position
transformer -> mel prior mu_x + duration predictor.

Counterpart of gradtts_tpu/models/text_encoder.py (``TextEncoder`` :457,
``Encoder`` :390, ``_mha_apply`` :321, ``ConvReluNorm`` :24,
``DurationPredictor`` :51), with the upstream speaker concat
(:495-499). Activations are [B, C, T] as torch's Conv1d
takes them; parameter names follow the reference torch ``state_dict``
(``encoder.prenet.conv_layers.0.weight``, ...). The JAX package has no
kernel here, so the attention is plain matmul + softmax: the relative
position logits and values are added to the scores and to the output, which
``scaled_dot_product_attention`` cannot express. Dropout sits where the
JAX package has it (prenet 0.5; ``p_dropout`` in the duration predictor, on
the attention probabilities, inside the FFN and on each sub-layer output),
active under ``train()`` only and drawn from the ``generator`` passed down
from :meth:`TextEncoder.forward`. The duration predictor reads a detached
copy of the encoder output (``stop_gradient``, :511).

Under tensor parallelism the attention's ``conv_q/k/v/o`` and the FFN's
``conv_1``/``conv_2`` may be split over the 'model' axis
(``models.layers.split_apply``): each computes its output-channel block
(its bias block added in the conv) from the whole input, gathered right
after the conv. The attention, the ReLU and every dropout run on whole
tensors, so every 'model' rank draws the same masks.
"""

import math

import torch
from torch import nn

from gradtts_tpu_torch.models.layers import (ChannelLayerNorm, Conv1d,
                                             dropout, split_apply)
from gradtts_tpu_torch.ops.seq import sequence_mask


class ConvReluNorm(nn.Module):
    """Conv prenet with a residual projection (``ConvReluNorm`` :24)."""

    def __init__(self, channels: int, kernel_size: int = 5, n_layers: int = 3,
                 p_dropout: float = 0.5):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_layers = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=kernel_size // 2)
            for _ in range(n_layers))
        self.norm_layers = nn.ModuleList(
            ChannelLayerNorm(channels) for _ in range(n_layers))
        self.proj = Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj.weight)     # the prenet starts as identity
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, generator=None):
        x_org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = torch.relu(norm(conv(x * x_mask)))
            x = dropout(x, self.p_dropout, self.training, generator)
        return (x_org + self.proj(x)) * x_mask


class DurationPredictor(nn.Module):
    """2x (conv -> relu -> LN) -> 1x1 conv (``DurationPredictor`` :51)."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        pad = kernel_size // 2
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                                padding=pad)
        self.norm_1 = ChannelLayerNorm(filter_channels)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size,
                                padding=pad)
        self.norm_2 = ChannelLayerNorm(filter_channels)
        self.proj = Conv1d(filter_channels, 1, 1)

    def forward(self, x, x_mask, generator=None):
        p, training = self.p_dropout, self.training
        x = self.norm_1(torch.relu(self.conv_1(x * x_mask)))
        x = dropout(x, p, training, generator)
        x = self.norm_2(torch.relu(self.conv_2(x * x_mask)))
        x = dropout(x, p, training, generator)
        return self.proj(x * x_mask) * x_mask


def relative_to_absolute(x):
    """[B, H, L, 2L-1] relative-keyed logits -> [B, H, L, L] absolute
    (``_relative_to_absolute`` :72)."""
    b, h, l, _ = x.shape
    x = nn.functional.pad(x, (0, 1))
    x = nn.functional.pad(x.reshape(b, h, 2 * l * l), (0, l - 1))
    return x.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def absolute_to_relative(x):
    """[B, H, L, L] attention weights -> [B, H, L, 2L-1] relative
    (``_absolute_to_relative`` :82)."""
    b, h, l, _ = x.shape
    x = nn.functional.pad(x, (0, l - 1))
    x = nn.functional.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def relative_embeddings(emb, length: int, window_size: int):
    """[1, 2w+1, d] window table -> [1, 2*length-1, d]
    (``_get_relative_embeddings`` :92)."""
    pad_length = max(length - (window_size + 1), 0)
    slice_start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = nn.functional.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, slice_start:slice_start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    """Self-attention with windowed relative position embeddings shared by
    all heads (``_mha_apply`` :321). Scores, softmax and both value
    contractions run in f32 whatever the compute dtype."""

    def __init__(self, channels: int, n_heads: int, window_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.p_dropout = p_dropout
        self.window_size = window_size
        d = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, d)
                                      * d ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, d)
                                      * d ** -0.5)

    def forward(self, x, attn_mask, generator=None):
        b, c, t = x.shape
        h, d = self.n_heads, c // self.n_heads

        def heads(y):                                   # -> [B, H, T, D] f32
            return y.float().reshape(b, h, d, t).transpose(2, 3)

        q, k, v = (heads(split_apply(conv, x)) for conv in
                   (self.conv_q, self.conv_k, self.conv_v))
        key_rel = relative_embeddings(self.emb_rel_k.float(), t,
                                      self.window_size)
        scores = (q @ k.transpose(2, 3)) / math.sqrt(d)
        scores = scores + relative_to_absolute(
            q @ key_rel.transpose(1, 2)[None]) / math.sqrt(d)
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = dropout(torch.softmax(scores, dim=-1), self.p_dropout,
                         self.training, generator)
        value_rel = relative_embeddings(self.emb_rel_v.float(), t,
                                        self.window_size)
        out = p_attn @ v + absolute_to_relative(p_attn) @ value_rel[None]
        out = out.transpose(2, 3).reshape(b, c, t).to(x.dtype)
        return split_apply(self.conv_o, out)


class FFN(nn.Module):
    """conv -> relu -> conv with masking (``_ffn_apply`` :373)."""

    def __init__(self, channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        pad = kernel_size // 2
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size,
                                padding=pad)
        self.conv_2 = Conv1d(filter_channels, channels, kernel_size,
                                padding=pad)

    def forward(self, x, x_mask, generator=None):
        x = torch.relu(split_apply(self.conv_1, x * x_mask))
        x = dropout(x, self.p_dropout, self.training, generator)
        return split_apply(self.conv_2, x * x_mask) * x_mask


class Encoder(nn.Module):
    """Stack of (rel-pos MHA + LN, FFN + LN) layers (``Encoder`` :390)."""

    def __init__(self, channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int, window_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(channels, n_heads, window_size, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(
            ChannelLayerNorm(channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(channels, filter_channels, kernel_size, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(
            ChannelLayerNorm(channels) for _ in range(n_layers))

    def forward(self, x, x_mask, generator=None):
        attn_mask = x_mask[:, :, None, :] * x_mask[:, :, :, None]  # [B,1,T,T]
        p, training = self.p_dropout, self.training
        for attn, ln1, ffn, ln2 in zip(self.attn_layers, self.norm_layers_1,
                                       self.ffn_layers, self.norm_layers_2):
            x = x * x_mask
            y = dropout(attn(x, attn_mask, generator), p, training, generator)
            x = ln1(x + y)
            y = dropout(ffn(x, x_mask, generator), p, training, generator)
            x = ln2(x + y)
        return x * x_mask


class TextEncoder(nn.Module):
    """Full text encoder (``TextEncoder`` :457). The fork builds it with no
    speaker input; with ``n_spks > 1`` (the upstream wiring, GradTTS's
    ``encoder_speaker``) the speaker embedding, broadcast over the tokens,
    is concatenated after the prenet (:495-499), and the transformer, its
    relative-position tables and the output heads are ``n_channels +
    spk_emb_dim`` wide. The trunk runs in ``compute_dtype`` (see
    ``models.tts.set_compute_dtype``); the output heads ``proj_m`` and
    ``proj_w`` run in f32 whatever that dtype is (:504-510)."""

    def __init__(self, n_vocab: int, n_feats: int, n_channels: int,
                 filter_channels: int, filter_channels_dp: int, n_heads: int,
                 n_layers: int, kernel_size: int, window_size: int,
                 p_dropout: float = 0.1, n_spks: int = 1,
                 spk_emb_dim: int = 64):
        super().__init__()
        self.n_channels = n_channels
        self.n_spks = n_spks
        self.compute_dtype = torch.float32
        width = n_channels + (spk_emb_dim if n_spks > 1 else 0)
        self.emb = nn.Embedding(n_vocab, n_channels)
        self.prenet = ConvReluNorm(n_channels, kernel_size=5, n_layers=3)
        self.encoder = Encoder(width, filter_channels, n_heads, n_layers,
                               kernel_size, window_size, p_dropout)
        self.proj_m = Conv1d(width, n_feats, 1)
        self.proj_w = DurationPredictor(width, filter_channels_dp,
                                        kernel_size, p_dropout)

    def forward(self, x, x_lengths, generator=None, spk=None):
        """x [B, Tx] int ids; x_lengths [B]; spk [B, spk_emb_dim], the
        embedded speaker (read with ``n_spks > 1`` only). Returns f32
        (mu_x [B, Tx, F], logw [B, Tx, 1], x_mask [B, Tx, 1]).
        ``generator`` draws the dropout masks under ``train()``."""
        dtype = self.compute_dtype
        h = (self.emb(x) * math.sqrt(self.n_channels)).transpose(1, 2)
        h = h.to(dtype)                                         # [B, C, T]
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, None, :].to(dtype)
        h = self.prenet(h, x_mask, generator)
        if self.n_spks > 1:
            if spk is None:
                raise ValueError('an encoder with the speaker concat needs '
                                 'the speaker embedding spk')
            h = torch.cat([h, spk.to(dtype)[:, :, None].expand(
                -1, -1, h.shape[2])], dim=1)
        h = self.encoder(h, x_mask, generator).float()
        x_mask = x_mask.float()
        mu = self.proj_m(h) * x_mask
        logw = self.proj_w(h.detach(), x_mask, generator)
        return (mu.transpose(1, 2), logw.transpose(1, 2),
                x_mask.transpose(1, 2))
