"""Plain PyTorch Grad-TTS: the benchmark's frozen reference.

Written from the published model (huawei-noah/Speech-Backbones, Grad-TTS:
model/text_encoder.py, model/diffusion.py, model/tts.py, model/utils.py)
and this fork's choices, in f32 with no hand kernel, no cache and no
layout trick:

- text encoder: embedding, conv prenet (ConvReluNorm), six relative-
  position transformer layers (window 4, heads share the tables), the mel
  prior head ``proj_m`` and the duration predictor on a detached copy;
- score U-Net: (1, 2, 4) x ``dec_dim`` ResNet blocks of conv3x3 ->
  GroupNorm(8) -> Mish, ReZero linear attention (4 heads of 32, softmax
  over every (F, T) position, padding included), time and speaker MLPs;
- synthesis by the Euler steps of the probability-flow ODE; the three
  training losses; the likelihood of the probability-flow ODE by Euler
  steps with the Hutchinson divergence (forward mode, ``torch.func.jvp``).

Parameter names are the published ``state_dict``'s, so one state dict
serves this model and the program. Dropout draws its keep masks from a
``torch.Generator`` in the order the layers run, so the same seed gives
the same masks wherever the same draws are made in that order. Matrix
products read their operands through ``lowp.operand``: f32 here, fp8 in
the control of the output check. Imports nothing but torch and numpy.
"""

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.lowp import LowPrecision, operand
from benchmark.reference.mas import maximum_path  # noqa: F401 (the check's)


class Lp(nn.Module):
    """Base of every layer with a matrix product: ``self.lp`` is the
    model's shared :class:`LowPrecision` (set by :func:`set_precision`)."""
    lp = None

    def q(self, x):
        return operand(self.lp, x)


class Conv1d(Lp):
    def __init__(self, cin, cout, k, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.padding = padding

    def forward(self, x):
        return F.conv1d(self.q(x), self.q(self.weight), self.bias,
                        padding=self.padding)


class Conv2d(Lp):
    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(self.q(x), self.q(self.weight), self.bias,
                        self.stride, self.padding)


class ConvTranspose2d(Lp):
    def __init__(self, dim, k=4, stride=2, padding=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dim, k, k))
        self.bias = nn.Parameter(torch.empty(dim))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv_transpose2d(self.q(x), self.q(self.weight), self.bias,
                                  self.stride, self.padding)


class Linear(Lp):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def sequence_mask(lengths, max_length):
    return torch.arange(max_length, device=lengths.device)[None] \
        < lengths[:, None]


def dropout(x, p, gen):
    """Inverted dropout with the keep mask drawn from ``gen`` (f32 uniform
    of x's shape); the identity where ``gen`` is None (eval)."""
    if gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


# ---- text encoder ------------------------------------------------------------


class LayerNorm(nn.Module):
    """Over the channels of [B, C, T], biased variance, eps 1e-4."""

    def __init__(self, c):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(c))
        self.beta = nn.Parameter(torch.empty(c))

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = ((x - mean) ** 2).mean(1, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + 1e-4)
        return x * self.gamma[None, :, None] + self.beta[None, :, None]


class ConvReluNorm(nn.Module):
    def __init__(self, c, k=5, n=3):
        super().__init__()
        self.conv_layers = nn.ModuleList(Conv1d(c, c, k, k // 2)
                                         for _ in range(n))
        self.norm_layers = nn.ModuleList(LayerNorm(c) for _ in range(n))
        self.proj = Conv1d(c, c, 1)

    def forward(self, x, mask, gen):
        x0 = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = dropout(torch.relu(norm(conv(x * mask))), 0.5, gen)
        return (x0 + self.proj(x)) * mask


class DurationPredictor(nn.Module):
    def __init__(self, cin, cf, k, p):
        super().__init__()
        self.p = p
        self.conv_1 = Conv1d(cin, cf, k, k // 2)
        self.norm_1 = LayerNorm(cf)
        self.conv_2 = Conv1d(cf, cf, k, k // 2)
        self.norm_2 = LayerNorm(cf)
        self.proj = Conv1d(cf, 1, 1)

    def forward(self, x, mask, gen):
        x = dropout(self.norm_1(torch.relu(self.conv_1(x * mask))), self.p,
                    gen)
        x = dropout(self.norm_2(torch.relu(self.conv_2(x * mask))), self.p,
                    gen)
        return self.proj(x * mask) * mask


def rel_to_abs(x):
    """[B, H, L, 2L-1] -> [B, H, L, L] (text_encoder.py
    _relative_position_to_absolute_position)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, 2 * l * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def abs_to_rel(x):
    """[B, H, L, L] -> [B, H, L, 2L-1] (_absolute_position_to_relative)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * (2 * l - 1))
    return F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)[:, :, :, 1:]


def window_table(emb, length, window):
    """[1, 2w+1, d] -> [1, 2*length-1, d] (_get_relative_embeddings)."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


class MultiHeadAttention(Lp):
    def __init__(self, c, heads, window, p):
        super().__init__()
        self.h, self.window, self.p = heads, window, p
        d = c // heads
        self.conv_q, self.conv_k, self.conv_v, self.conv_o = (
            Conv1d(c, c, 1) for _ in range(4))
        self.emb_rel_k = nn.Parameter(torch.empty(1, 2 * window + 1, d))
        self.emb_rel_v = nn.Parameter(torch.empty(1, 2 * window + 1, d))

    def forward(self, x, attn_mask, gen):
        b, c, t = x.shape
        d = c // self.h
        q, k, v = (conv(x).view(b, self.h, d, t).transpose(2, 3)
                   for conv in (self.conv_q, self.conv_k, self.conv_v))
        scores = self.q(q) @ self.q(k).transpose(2, 3) / math.sqrt(d)
        rel_k = window_table(self.emb_rel_k, t, self.window)
        scores = scores + rel_to_abs(
            self.q(q) @ self.q(rel_k).transpose(1, 2)[None]) / math.sqrt(d)
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p = dropout(torch.softmax(scores, -1), self.p, gen)
        rel_v = window_table(self.emb_rel_v, t, self.window)
        out = self.q(p) @ self.q(v) \
            + self.q(abs_to_rel(p)) @ self.q(rel_v)[None]
        return self.conv_o(out.transpose(2, 3).reshape(b, c, t))


class FFN(nn.Module):
    def __init__(self, c, cf, k, p):
        super().__init__()
        self.p = p
        self.conv_1 = Conv1d(c, cf, k, k // 2)
        self.conv_2 = Conv1d(cf, c, k, k // 2)

    def forward(self, x, mask, gen):
        x = dropout(torch.relu(self.conv_1(x * mask)), self.p, gen)
        return self.conv_2(x * mask) * mask


class Transformer(nn.Module):
    def __init__(self, c, cf, heads, layers, k, window, p):
        super().__init__()
        self.p = p
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(c, heads, window, p) for _ in range(layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(c) for _ in range(layers))
        self.ffn_layers = nn.ModuleList(FFN(c, cf, k, p)
                                        for _ in range(layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(c) for _ in range(layers))

    def forward(self, x, mask, gen):
        attn_mask = mask[:, :, None, :] * mask[:, :, :, None]
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1,
                                     self.ffn_layers, self.norm_layers_2):
            x = x * mask
            x = n1(x + dropout(attn(x, attn_mask, gen), self.p, gen))
            x = n2(x + dropout(ffn(x, mask, gen), self.p, gen))
        return x * mask


class TextEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.channels = c['n_enc_channels']
        ch, p = c['n_enc_channels'], c['enc_dropout']
        self.emb = nn.Module()
        self.emb.weight = nn.Parameter(torch.empty(c['n_vocab'], ch))
        self.prenet = ConvReluNorm(ch)
        self.encoder = Transformer(ch, c['filter_channels'], c['n_heads'],
                                   c['n_enc_layers'], c['enc_kernel'],
                                   c['window_size'], p)
        self.proj_m = Conv1d(ch, c['n_feats'], 1)
        self.proj_w = DurationPredictor(ch, c['filter_channels_dp'],
                                        c['enc_kernel'], p)

    def forward(self, x, x_lengths, gen=None):
        """-> mu_x [B, F, Tx], logw [B, 1, Tx], mask [B, 1, Tx]; dropout
        where ``gen`` is given (training)."""
        h = self.emb.weight[x].transpose(1, 2) * math.sqrt(self.channels)
        mask = sequence_mask(x_lengths, x.shape[1])[:, None].float()
        h = self.prenet(h, mask, gen)
        h = self.encoder(h, mask, gen)
        return self.proj_m(h) * mask, self.proj_w(h.detach(), mask, gen), mask


# ---- score U-Net -------------------------------------------------------------


class GroupNorm(nn.Module):
    """GroupNorm(8) over every (F, T) position, eps 1e-5."""

    def __init__(self, c, groups=8):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, 1e-5)


class Block(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.block = nn.ModuleList([Conv2d(cin, cout, 3, padding=1),
                                    GroupNorm(cout)])

    def forward(self, x, mask):
        conv, norm = self.block
        return mish(norm(conv(x * mask))) * mask


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, tdim):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Identity(), Linear(tdim, cout)])
        self.block1 = Block(cin, cout)
        self.block2 = Block(cout, cout)
        self.res_conv = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, mask, t):
        h = self.block1(x, mask) + self.mlp[1](mish(t))[:, :, None, None]
        h = self.block2(h, mask)
        return h + (x * mask if self.res_conv is None
                    else self.res_conv(x * mask))


class LinearAttention(Lp):
    def __init__(self, dim, heads=4, dim_head=32):
        super().__init__()
        self.heads = heads
        self.to_qkv = Conv2d(dim, 3 * heads * dim_head, 1, bias=False)
        self.to_out = Conv2d(heads * dim_head, dim, 1)

    def forward(self, x):
        b, c, f, t = x.shape
        qkv = self.to_qkv(x).reshape(b, 3, self.heads, -1, f * t)
        q, k, v = qkv.unbind(1)
        k = k.softmax(-1)
        ctx = torch.einsum('bhdn,bhen->bhde', self.q(k), self.q(v))
        out = torch.einsum('bhde,bhdn->bhen', self.q(ctx), self.q(q))
        return self.to_out(out.reshape(b, -1, f, t))


class Residual(nn.Module):
    """x + g * attention(x) (Residual(Rezero(LinearAttention)))."""

    def __init__(self, dim):
        super().__init__()
        self.fn = nn.Module()
        self.fn.fn = LinearAttention(dim)
        self.fn.g = nn.Parameter(torch.empty(1))

    def forward(self, x):
        return x + self.fn.g * self.fn.fn(x)


class Resample(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


class Estimator(nn.Module):
    def __init__(self, c):
        super().__init__()
        dim, n_feats = c['dec_dim'], c['n_feats']
        self.pe_scale = c['pe_scale']
        self.dim = dim
        self.n_spks = c['n_spks']
        if self.n_spks > 1:
            e = c['spk_emb_dim']
            self.spk_mlp = nn.ModuleList([Linear(e, 4 * e), nn.Identity(),
                                          Linear(4 * e, n_feats)])
        self.mlp = nn.ModuleList([Linear(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])
        dims = [3 if self.n_spks > 1 else 2, dim, 2 * dim, 4 * dim]
        pairs = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for i, (a, b) in enumerate(pairs):
            down = (nn.Identity() if i == len(pairs) - 1
                    else Resample(Conv2d(b, b, 3, 2, 1)))
            self.downs.append(nn.ModuleList([
                ResnetBlock(a, b, dim), ResnetBlock(b, b, dim), Residual(b),
                down]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, dim)
        self.mid_attn = Residual(mid)
        self.mid_block2 = ResnetBlock(mid, mid, dim)
        self.ups = nn.ModuleList()
        for a, b in reversed(pairs[1:]):
            self.ups.append(nn.ModuleList([
                ResnetBlock(2 * b, a, dim), ResnetBlock(a, a, dim),
                Residual(a), Resample(ConvTranspose2d(a))]))
        self.final_block = Block(dim, dim)
        self.final_conv = Conv2d(dim, 1, 1)

    def time_embedding(self, t):
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=t.device)
                          * -(math.log(10000) / (half - 1)))
        e = self.pe_scale * t[:, None] * freqs[None]
        e = torch.cat([e.sin(), e.cos()], -1)
        return self.mlp[2](mish(self.mlp[0](e)))

    def forward(self, x, mask, mu, t, spk=None):
        """x, mu [B, T, F]; mask [B, T]; t [B]; spk [B, D] embedded.
        -> score [B, T, F]."""
        temb = self.time_embedding(t)
        chans = [mu.transpose(1, 2), x.transpose(1, 2)]
        if self.n_spks > 1:
            s = self.spk_mlp[2](mish(self.spk_mlp[0](spk)))
            chans.append(s[:, :, None].expand(-1, -1, x.shape[1]))
        h = torch.stack(chans, 1)
        masks = [mask[:, None, None, :]]
        hiddens = []
        for res1, res2, attn, down in self.downs:
            m = masks[-1]
            h = attn(res2(res1(h, m, temb), m, temb))
            hiddens.append(h)
            h = down(h * m)
            masks.append(m[:, :, :, ::2])
        masks.pop()
        m = masks[-1]
        h = self.mid_block2(self.mid_attn(self.mid_block1(h, m, temb)), m,
                            temb)
        for res1, res2, attn, up in self.ups:
            m = masks.pop()
            h = torch.cat([h, hiddens.pop()], 1)
            h = up(attn(res2(res1(h, m, temb), m, temb)) * m)
        m = masks[-1]
        h = self.final_block(h, m)
        return (self.final_conv(h * m) * m)[:, 0].transpose(1, 2)


class Decoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.estimator = Estimator(c)


class GradTTS(nn.Module):
    """The model. ``cfg`` is the configuration file's dict."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        if cfg['n_spks'] > 1:
            self.spk_emb = nn.Module()
            self.spk_emb.weight = nn.Parameter(
                torch.empty(cfg['n_spks'], cfg['spk_emb_dim']))
        self.encoder = TextEncoder(cfg)
        self.decoder = Decoder(cfg)

    def speaker(self, spk):
        return self.spk_emb.weight[spk] if self.cfg['n_spks'] > 1 else None

    def score(self, x, mask, mu, t, spk_vec):
        return self.decoder.estimator(x, mask, mu, t, spk_vec)


def set_precision(model, fmt):
    """Every matrix product of ``model`` reads its operands in ``fmt``
    (None: f32; 'fp8')."""
    lp = LowPrecision(fmt)
    for m in model.modules():
        if isinstance(m, Lp):
            m.lp = lp
    return model


def noise_rate(t, c):
    return c['beta_min'] + (c['beta_max'] - c['beta_min']) * t


def noise_integral(t, c):
    return c['beta_min'] * t + 0.5 * (c['beta_max'] - c['beta_min']) * t ** 2


# ---- synthesis ---------------------------------------------------------------


def durations(model, x, x_lengths):
    """-> (mu_x [B, F, Tx], w [B, Tx] = exp(logw) on real tokens)."""
    mu_x, logw, mask = model.encoder(x, x_lengths)
    return mu_x, torch.exp(logw[:, 0]) * mask[:, 0]


def duration_path(w_ceil, x_mask, y_mask):
    """[B, Tx] integer durations -> the 0/1 path [B, Tx, Ty]: token x holds
    frames [sum of the earlier durations, that plus its own), inside both
    masks ([B, Tx], [B, Ty])."""
    end = torch.cumsum(w_ceil, 1)
    pos = torch.arange(y_mask.shape[1], device=w_ceil.device)
    covered = (pos[None, None] < end[:, :, None]).float()
    path = covered - F.pad(covered, (0, 0, 1, 0))[:, :-1]
    return path * x_mask[:, :, None] * y_mask[:, None, :]


def mel_prior(model, x, x_lengths, budget):
    """The mel prior of a text with the model's own durations: ceil(w)
    frames a token, at least 1 and at most ``budget`` a text. Returns
    (mu_y [B, budget, F], attn [B, Tx, budget], y_lengths, w [B, Tx])."""
    mu_x, w = durations(model, x, x_lengths)
    w_ceil = torch.ceil(w)
    y_lengths = w_ceil.sum(1).clamp(1, budget).long()
    y_mask = sequence_mask(y_lengths, budget).float()
    x_mask = sequence_mask(x_lengths, x.shape[1]).float()
    attn = duration_path(w_ceil, x_mask, y_mask)
    mu_y = torch.einsum('bxy,bfx->byf', attn, mu_x) * y_mask[..., None]
    return mu_y, attn, y_lengths, w


def synthesize(model, x, x_lengths, n_steps, budget, temperature, noise,
               spk=None):
    """Text -> mel with the model's own durations (:func:`mel_prior`).
    Returns (mu_y, mel, attn, y_lengths) as the program's synthesis names
    them."""
    mu_y, attn, y_lengths, _ = mel_prior(model, x, x_lengths, budget)
    y_mask = sequence_mask(y_lengths, budget).float()[..., None]
    mel = euler_synthesis(model, mu_y, y_mask, noise, n_steps, temperature,
                          model.speaker(spk))
    return Synthesis(mu_y, mel, attn, y_lengths)


class Synthesis(NamedTuple):
    encoder_outputs: torch.Tensor
    decoder_outputs: torch.Tensor
    attn: torch.Tensor
    y_lengths: torch.Tensor


def euler_synthesis(model, mu_y, y_mask, noise, n_steps, temperature,
                    spk_vec=None):
    """The probability-flow ODE from t = 1 to 0 in ``n_steps`` Euler steps
    at the midpoints. mu_y, noise [B, T, F]; y_mask [B, T, 1]."""
    c = model.cfg
    h = 1.0 / n_steps
    x = (mu_y + noise / temperature) * y_mask
    for i in range(n_steps):
        t = torch.full((x.shape[0],), 1.0 - (i + 0.5) * h, device=x.device)
        beta = noise_rate(t, c)[:, None, None]
        s = model.score(x, y_mask[..., 0], mu_y, t, spk_vec)
        x = (x - 0.5 * (mu_y - x - s) * beta * h) * y_mask
    return x


# ---- alignment and losses ----------------------------------------------------


def log_prior_grid(y, mu_x):
    """log N(y_frame; mu_token, I) for every pair: y [B, T, F], mu_x
    [B, F, Tx] -> [B, Tx, T]."""
    mu = mu_x.transpose(1, 2)
    const = -0.5 * math.log(2 * math.pi) * y.shape[-1]
    return (mu @ y.transpose(1, 2) - 0.5 * (y ** 2).sum(-1)[:, None]
            - 0.5 * (mu ** 2).sum(-1)[:, :, None] + const)


def align(y, y_lengths, mu_x, x_mask):
    """Monotonic alignment search (NumPy) on the log-prior grid of ``mu_x``
    [B, F, Tx] -> attn [B, Tx, T] on y's device."""
    y_mask = sequence_mask(y_lengths, y.shape[1]).float()
    attn_mask = x_mask[:, 0, :, None] * y_mask[:, None, :]
    with torch.no_grad():
        grid = (log_prior_grid(y, mu_x) * attn_mask).cpu().numpy()
    path = maximum_path(grid, attn_mask.cpu().numpy())
    return torch.from_numpy(path).to(y.device)


def training_losses(model, x, x_lengths, y, y_lengths, out_size, gen,
                    align_mu=None):
    """(duration, prior, diffusion) losses of one step, and the step's
    record {'mu_x' [B, F, Tx], 'attn' [B, Tx, out_size], the alignment
    after the crop}. ``gen`` draws, in this order: the dropout masks of the
    encoder, the crop offsets (``randint(0, 2**30)``), the diffusion times
    (uniform) and the noise (normal). The alignment is MAS on the
    log-prior grid of ``align_mu`` [B, F, Tx] where given, else of the
    model's own mu_x."""
    c = model.cfg
    mu_x, logw, x_mask = model.encoder(x, x_lengths, gen)
    record = {'mu_x': mu_x.detach()}
    attn = align(y, y_lengths, mu_x if align_mu is None else align_mu,
                 x_mask)
    logw_hat = torch.log(1e-8 + attn.sum(-1))[:, None] * x_mask
    dur = ((logw - logw_hat) ** 2).sum() / x_lengths.sum()
    B, T = y.shape[:2]
    max_off = (y_lengths - out_size).clamp_min(0)
    rand = torch.randint(0, 1 << 30, (B,), generator=gen, device=y.device)
    off = torch.where(max_off > 0, rand % max_off.clamp_min(1), 0)
    off = off.clamp(0, T - out_size)
    frames = off[:, None] + torch.arange(out_size, device=y.device)
    y = torch.gather(y, 1, frames[:, :, None].expand(-1, -1, y.shape[2]))
    attn = torch.gather(attn, 2, frames[:, None].expand(-1, attn.shape[1], -1))
    y_mask = sequence_mask(y_lengths.clamp_max(out_size),
                           out_size).float()[..., None]
    y, attn = y * y_mask, attn * y_mask[:, None, :, 0]
    record['attn'] = attn
    mu_y = torch.einsum('bxy,bfx->byf', attn, mu_x)
    n = y_mask.sum() * y.shape[-1]
    t = torch.rand((B,), generator=gen, device=y.device)
    z = torch.randn(y.shape, generator=gen, device=y.device)
    t = t.clamp(1e-5, 1.0 - 1e-5)
    cum = noise_integral(t, c)[:, None, None]
    decay = torch.exp(-0.5 * cum)
    z = z * y_mask
    xt = (y * decay + mu_y * (1.0 - decay) + z * torch.sqrt(
        1.0 - torch.exp(-cum))) * y_mask
    est = model.score(xt, y_mask[..., 0], mu_y, t, None) \
        * torch.sqrt(1.0 - torch.exp(-cum))
    diff = ((est + z) ** 2).sum() / n
    prior = (0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * y_mask).sum() / n
    return (dur, prior, diff), record


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) over a list of tensors."""

    def __init__(self, params, lr):
        self.params, self.lr, self.step_count = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        self.step_count += 1
        bc1 = 1 - 0.9 ** self.step_count
        bc2 = 1 - 0.999 ** self.step_count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + 1e-8))


def clipped(grads, max_norm):
    """The grads scaled by min(1, max_norm / (norm + 1e-6))."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads]


def train_steps(model, batches, seed, device, n_steps, align_mu=None):
    """``n_steps`` steps of acoustic training from the model's weights, one
    generator seeded ``seed`` drawing everything; step k aligns by MAS on
    the grid of ``align_mu[k]`` [B, F, Tx] where given, else of its own
    mu_x. Returns (losses a
    step [(dur, prior, diff)], the first step's clipped grads {name:
    tensor}, the change of every parameter after the steps {name: tensor},
    the steps' records)."""
    c = model.cfg
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    groups = [[i for i, n in enumerate(names) if n.startswith(pre)]
              for pre in ('encoder.', 'decoder.estimator.')]
    adam = Adam(params, c['learning_rate'])
    gen = torch.Generator(device=device).manual_seed(seed)
    losses, first, records = [], None, []
    for k in range(n_steps):
        b = batches[k % len(batches)]
        (dur, prior, diff), record = training_losses(
            model, b['x'], b['x_lengths'], b['y'], b['y_lengths'],
            c['out_size'], gen, None if align_mu is None else align_mu[k])
        records.append(record)
        grads = torch.autograd.grad(dur + prior + diff, params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        for idx in groups:
            for i, g in zip(idx, clipped([grads[i] for i in idx],
                                         c['grad_clip_norm'])):
                grads[i] = g
        if first is None:
            first = {n: g.detach() for n, g in zip(names, grads)}
        adam.step(grads)
        losses.append(tuple(float(v.detach()) for v in (dur, prior, diff)))
    change = {n: (p.detach() - s) for n, p, s in zip(names, params, start)}
    return losses, first, change, records


# ---- likelihood --------------------------------------------------------------


def likelihood(model, x, x_lengths, y, y_lengths, epsilon, n_steps,
               spk=None):
    """-log p(y | text) by the probability-flow ODE from t ~ 0 to 1 in
    ``n_steps`` Euler steps at the midpoints, the divergence by Hutchinson
    with the probe ``epsilon`` [B, T, F], summed in float64. Returns (score
    [B], prior_logp, delta_logp, z)."""
    c = model.cfg
    spk_vec = model.speaker(spk)
    mu_x, _, x_mask = model.encoder(x, x_lengths)
    attn = align(y, y_lengths, mu_x, x_mask)
    mu_y = torch.einsum('bxy,bfx->byf', attn, mu_x)
    y_mask = sequence_mask(y_lengths, y.shape[1]).float()[..., None]

    def drift(z, t):
        beta = noise_rate(t, c)[:, None, None]
        s = model.score(z * y_mask, y_mask[..., 0], mu_y, t, spk_vec)
        return (0.5 * beta * (mu_y - z * y_mask) - 0.5 * beta * s) * y_mask

    h = 1.0 / n_steps
    z = y * y_mask
    dlp = torch.zeros(y.shape[0], dtype=torch.float64, device=y.device)
    for i in range(n_steps):
        t = torch.full((y.shape[0],), (i + 0.5) * h, device=y.device)
        d, dd = torch.func.jvp(lambda v: drift(v, t), (z,), (epsilon,))
        dlp = dlp + (dd.double() * epsilon.double()).sum((1, 2)) * h
        z = z + d * h
    n = z[0].numel()
    prior = -n / 2.0 * math.log(2 * math.pi) \
        - ((z - mu_y) ** 2).sum((1, 2)) / 2.0
    return Likelihood(-(prior + dlp), prior, dlp, z)


def linear_divergence(y_lengths, epsilon, n_steps, c):
    """[B] float64: the part of delta_logp that the drift's linear term
    -0.5 beta z gives, exactly: the sum over the Euler steps of h * -0.5
    beta(t) * sum(epsilon^2) over the real frames. What is left of
    delta_logp is the score U-Net's divergence."""
    mask = sequence_mask(y_lengths, epsilon.shape[1]).double()[..., None]
    sq = (epsilon.double() ** 2 * mask).sum((1, 2))
    h = 1.0 / n_steps
    rate = sum(noise_rate((i + 0.5) * h, c) for i in range(n_steps))
    return -0.5 * h * rate * sq


class Likelihood(NamedTuple):
    score: torch.Tensor
    prior_logp: torch.Tensor
    delta_logp: torch.Tensor
    z: torch.Tensor

