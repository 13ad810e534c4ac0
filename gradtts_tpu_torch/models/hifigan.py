"""HiFi-GAN V1 generator: mel [B, T, 80] -> waveform [B, T * 256]; the
multi-period and multi-scale discriminators and the GAN losses.

Counterpart of gradtts_tpu/models/hifigan.py (``HiFiGANConfig`` :35-69,
``ResBlock1`` :155, ``ResBlock2`` :176, ``Generator`` :193-240, the
discriminators and losses :243-370). The
module holds plain weights, as the JAX package does after folding the
reference checkpoint's weight norm (``utils.convert.load_hifigan_state_dict``);
its keys are the reference torch generator's (``conv_pre.weight``,
``ups.0.weight``, ``resblocks.0.convs1.0.weight``, ...) without the
``weight_g``/``weight_v`` split. The upsamples are plain
``ConvTranspose1d(k, stride u, padding (k - u) // 2)``: the JAX package's
phase-packed lowering (``_phase_packed_kernel`` :78) is a TPU lane layout
of the same product. No hand kernel: every convolution is cuDNN's.

``compute_dtype`` bf16 runs each convolution in bf16 from the f32
parameters, as in the JAX package: a ``Conv1d`` adds its bias in bf16 (the
rule of Flax's ``nn.Conv``), an upsample adds its bias in f32 and rounds
once (``ConvTranspose1dTorch`` :108); the output's tanh and the parameters
stay f32.

The discriminators are f32 with plain kernels, as in the JAX package (the
upstream reference's weight norm, and spectral norm on the first scale,
are left out there too). ``DiscriminatorP`` runs ``Conv2d`` on
[B, 1, T / p, p] and ``DiscriminatorS`` grouped ``Conv1d``s; their feature
maps are NCHW / NCW, the JAX package's NHWC / NWC transposed.
"""

import json
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from gradtts_tpu_torch.utils.profiling import span

LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class HiFiGANConfig:
    """The V1 generator of the reference ``hifigan-config.json`` (upsample
    8 x 8 x 2 x 2 = 256 samples a frame), with its mel-analysis and
    training settings, which the generator does not read."""
    resblock: str = '1'
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050
    segment_size: int = 8192
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0
    fmax_loss: Optional[float] = None
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999

    @classmethod
    def from_json(cls, path_or_dict) -> 'HiFiGANConfig':
        """A config from a JSON file's path or its dict; keys that are not
        fields are ignored, lists become tuples."""
        d = path_or_dict
        if isinstance(d, str):
            with open(d) as f:
                d = json.load(f)
        names = {f.name for f in fields(cls)}
        keep = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                    if isinstance(v, list) else v)
                for k, v in d.items() if k in names}
        return cls(**keep)


def _wide(t):
    """``t`` in f32 for the bias adds of the upsamples and the tanh, or in
    f64 where the model runs in f64."""
    return t if t.dtype == torch.float64 else t.float()


def _conv(x, conv: nn.Conv1d, dilation: int = 1):
    """``conv`` with 'same' padding, weight and bias cast to the dtype of
    ``x``, as Flax's ``nn.Conv`` casts them to its ``dtype``."""
    pad = (conv.kernel_size[0] * dilation - dilation) // 2
    return F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=pad, dilation=dilation)


class ResBlock1(nn.Module):
    """3 x (leaky ReLU -> dilated conv -> leaky ReLU -> conv) with
    residuals (:155)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation=(1, 3, 5)):
        super().__init__()
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, kernel_size)
                                    for _ in self.dilation)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, kernel_size)
                                    for _ in self.dilation)

    def forward(self, x):
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilation):
            xt = _conv(F.leaky_relu(x, LRELU_SLOPE), c1, d)
            xt = _conv(F.leaky_relu(xt, LRELU_SLOPE), c2)
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """2 x (leaky ReLU -> dilated conv) with residuals (:176)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3)):
        super().__init__()
        self.dilation = tuple(dilation)
        self.convs = nn.ModuleList(nn.Conv1d(channels, channels, kernel_size)
                                   for _ in self.dilation)

    def forward(self, x):
        for c, d in zip(self.convs, self.dilation):
            x = _conv(F.leaky_relu(x, LRELU_SLOPE), c, d) + x
        return x


class Generator(nn.Module):
    """mel [B, T, num_mels] -> waveform [B, T * prod(upsample_rates)] in
    [-1, 1], f32 (:193). Runs on the device of its parameters, in
    ``compute_dtype`` (f32 unless set)."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch.float32
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(c0 // 2 ** i, c0 // 2 ** (i + 1), k, u)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                           cfg.upsample_kernel_sizes)))
        block = ResBlock1 if cfg.resblock == '1' else ResBlock2
        self.resblocks = nn.ModuleList(
            block(c0 // 2 ** (i + 1), k, d)
            for i in range(len(self.ups))
            for k, d in zip(cfg.resblock_kernel_sizes,
                            cfg.resblock_dilation_sizes))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(self.ups), 1, 7)

    def forward(self, mel):
        with span('gradtts.vocoder'):
            n_kernels = len(self.cfg.resblock_kernel_sizes)
            x = _conv(mel.transpose(1, 2).to(self.compute_dtype),
                      self.conv_pre)
            for i, up in enumerate(self.ups):
                x = F.leaky_relu(x, LRELU_SLOPE)
                u = up.stride[0]
                y = F.conv_transpose1d(x, up.weight.to(x.dtype), None, u,
                                       (up.kernel_size[0] - u) // 2)
                x = (_wide(y) + up.bias[:, None]).to(x.dtype)
                xs = None
                for block in self.resblocks[i * n_kernels:
                                            (i + 1) * n_kernels]:
                    xs = block(x) if xs is None else xs + block(x)
                x = xs / n_kernels
            x = F.leaky_relu(x)                 # slope 0.01, as the reference
            return torch.tanh(_wide(_conv(x, self.conv_post)))[:, 0]


# --- discriminators and losses (vocoder training) -----------------------------


class DiscriminatorP(nn.Module):
    """Period discriminator (:243): [B, T] reflect-padded to a multiple of
    ``period``, folded to [B, 1, T / p, p], five (k, 1) convolutions and a
    (3, 1) one. Returns (scores [B, n], feature maps)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, (kernel_size, 1), (stride, 1), (pad, 0))
            for i, o in zip(chans[:-1], chans[1:]))
        self.convs.append(nn.Conv2d(1024, 1024, (kernel_size, 1), 1, (2, 0)))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, (1, 0))

    def forward(self, x):
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode='reflect')[:, 0]
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


# (out channels, kernel, stride, groups, padding) of DiscriminatorS (:283)
_SCALE_CONVS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
                (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20),
                (1024, 41, 1, 16, 20), (1024, 5, 1, 1, 2))


class DiscriminatorS(nn.Module):
    """Scale discriminator (:274): seven 1-D convolutions, five grouped,
    and a post convolution on [B, 1, T]. Returns (scores, feature maps)."""

    def __init__(self):
        super().__init__()
        chans = (1,) + tuple(c[0] for c in _SCALE_CONVS)
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, k, s, p, groups=g)
            for i, (o, k, s, g, p) in zip(chans, _SCALE_CONVS))
        self.conv_post = nn.Conv1d(1024, 1, 3, 1, 1)

    def forward(self, x):
        x = x[:, None]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """Periods 2, 3, 5, 7, 11 (:297). ``forward(y, y_hat)`` returns the
    scores of the real and generated audio and their feature maps, one
    entry a discriminator."""

    def __init__(self, periods=(2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p)
                                            for p in periods)

    def forward(self, y, y_hat):
        return _by_kind([(d(y), d(y_hat)) for d in self.discriminators])


def _avg_pool1d(x, window=4, stride=2, padding=2):
    """[B, T] average pool over zero-padded edges; the padded zeros count
    in the mean, as the JAX package divides every window by its size
    (:313)."""
    return F.avg_pool1d(x[:, None], window, stride, padding,
                        count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """Three scale discriminators on the audio pooled 0, 1 and 2 times
    (:320); ``forward`` as :class:`MultiPeriodDiscriminator`'s."""

    def __init__(self, n_scales: int = 3):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorS()
                                            for _ in range(n_scales))

    def forward(self, y, y_hat):
        outs = []
        for i, d in enumerate(self.discriminators):
            if i:
                y, y_hat = _avg_pool1d(y), _avg_pool1d(y_hat)
            outs.append((d(y), d(y_hat)))
        return _by_kind(outs)


def _by_kind(outs):
    """[((real scores, real maps), (generated scores, generated maps)), ...]
    a discriminator -> (real scores, generated scores, real feature maps,
    generated feature maps), each a list over the discriminators."""
    return ([r[0] for r, _ in outs], [g[0] for _, g in outs],
            [r[1] for r, _ in outs], [g[1] for _, g in outs])


def feature_loss(fmap_r, fmap_g):
    """2 x the sum over every feature map of mean |real - generated|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real, disc_gen):
    """Least-squares GAN loss of the discriminators: (sum, per-disc real
    terms, per-disc generated terms)."""
    loss, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean((1 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """Least-squares GAN loss of the generator: (sum, per-disc terms)."""
    loss, gen_losses = 0.0, []
    for dg in disc_outputs:
        term = torch.mean((1 - dg) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses
