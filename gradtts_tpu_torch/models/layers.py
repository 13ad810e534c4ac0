"""Shared building blocks (counterpart of gradtts_tpu/models/layers.py)."""

import torch
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation, x * tanh(softplus(x))."""
    return x * torch.tanh(nn.functional.softplus(x))


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T] with biased variance, eps
    1e-4, statistics in f32 (reference layout: parameters ``gamma``/``beta``)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.gamma.view(1, -1, 1) + self.beta.view(1, -1, 1)
        return y.to(x.dtype)
