"""Plain PyTorch HiFi-GAN V1 generator (jik876/hifi-gan models.py,
config_v1.json): conv_pre, four leaky-ReLU + transposed-convolution
upsamplings (8, 8, 2, 2), each followed by the mean of three ResBlock1s
(kernels 3, 7, 11; dilations 1, 3, 5), leaky ReLU (0.01), conv_post and
tanh. The weights are plain (weight norm folded), under the published
names. f32; matrix products read their operands through ``lowp.operand``.
"""

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.gradtts import Lp

SLOPE = 0.1


class Conv(Lp):
    def __init__(self, cin, cout, k, dilation=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.dilation = dilation
        self.padding = (k * dilation - dilation) // 2

    def forward(self, x):
        return F.conv1d(self.q(x), self.q(self.weight), self.bias,
                        padding=self.padding, dilation=self.dilation)


class Up(Lp):
    def __init__(self, cin, cout, k, u):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.padding = u, (k - u) // 2

    def forward(self, x):
        return F.conv_transpose1d(self.q(x), self.q(self.weight), self.bias,
                                  self.stride, self.padding)


class ResBlock1(nn.Module):
    def __init__(self, c, k, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(Conv(c, c, k, d) for d in dilations)
        self.convs2 = nn.ModuleList(Conv(c, c, k) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, SLOPE)), SLOPE))
        return x


class Generator(nn.Module):
    """mel [B, T, 80] -> waveform [B, T * 256]. ``cfg``: the V1 sizes
    (upsample_rates, upsample_kernel_sizes, upsample_initial_channel,
    resblock_kernel_sizes, resblock_dilation_sizes, num_mels)."""

    def __init__(self, cfg):
        super().__init__()
        c0 = cfg['upsample_initial_channel']
        self.n_kernels = len(cfg['resblock_kernel_sizes'])
        self.conv_pre = Conv(cfg['num_mels'], c0, 7)
        self.ups = nn.ModuleList(
            Up(c0 // 2 ** i, c0 // 2 ** (i + 1), k, u)
            for i, (u, k) in enumerate(zip(cfg['upsample_rates'],
                                           cfg['upsample_kernel_sizes'])))
        self.resblocks = nn.ModuleList(
            ResBlock1(c0 // 2 ** (i + 1), k, d)
            for i in range(len(self.ups))
            for k, d in zip(cfg['resblock_kernel_sizes'],
                            cfg['resblock_dilation_sizes']))
        self.conv_post = Conv(c0 // 2 ** len(self.ups), 1, 7)

    def forward(self, mel):
        x = self.conv_pre(mel.transpose(1, 2))
        n = self.n_kernels
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, SLOPE))
            x = sum(b(x) for b in self.resblocks[i * n:(i + 1) * n]) / n
        return torch.tanh(self.conv_post(F.leaky_relu(x)))[:, 0]
