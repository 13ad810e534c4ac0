"""HiFi-GAN V1 generator: mel [B, T, 80] -> waveform [B, T * 256].

Counterpart of gradtts_tpu/models/hifigan.py (``HiFiGANConfig`` :35-69,
``ResBlock1`` :155, ``ResBlock2`` :176, ``Generator`` :193-240). The
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
"""

import json
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

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
        n_kernels = len(self.cfg.resblock_kernel_sizes)
        x = _conv(mel.transpose(1, 2).to(self.compute_dtype), self.conv_pre)
        for i, up in enumerate(self.ups):
            x = F.leaky_relu(x, LRELU_SLOPE)
            u = up.stride[0]
            y = F.conv_transpose1d(x, up.weight.to(x.dtype), None, u,
                                   (up.kernel_size[0] - u) // 2)
            x = (y.float() + up.bias[:, None]).to(x.dtype)
            xs = None
            for block in self.resblocks[i * n_kernels:(i + 1) * n_kernels]:
                xs = block(x) if xs is None else xs + block(x)
            x = xs / n_kernels
        x = F.leaky_relu(x)                      # slope 0.01, as the reference
        return torch.tanh(_conv(x, self.conv_post).float())[:, 0]
