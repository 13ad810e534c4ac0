"""Score-estimator U-Net and the Euler sampler of the reverse ODE.

Counterpart of gradtts_tpu/models/diffusion.py (``GradLogPEstimator2d``
:496, ``ResnetBlock`` :283, ``Block`` :251, ``LinearAttention`` + ``Rezero``
:351-493, ``SinusoidalPosEmb`` :133, ``get_noise`` :125,
``reverse_diffusion`` :662 with its ``stoc`` branch,
``reverse_diffusion_dpm`` :698, ``forward_diffusion`` :649,
``diffusion_loss`` :773), without the TPU layout tricks (frequency
folding and its kernel rearrangements): those are exact re-layouts of the
math computed here.

Activations are NCHW tensors [B, C, F, T] in ``torch.channels_last``
memory format, so cuDNN's convolutions and the hand kernels share one
layout: ``h.permute(0, 2, 3, 1)`` is a contiguous [B, F, T, C] view, which
the kernels read as [B, N = F*T, C] without a copy. Every ``Block`` ends in
the GroupNorm+Mish kernel (K1) and every attention is the linear-attention
kernel pair (K2 + K3), both autograd Functions: the attention's backward is
the kernel pair K4 + K5, the norm's recomputes its plain version. A
``Block``'s 3x3 convolution in f32 on the card with cuDNN's TF32 off is the
kernel ``ops.conv3x3``, in both modes. Parameter
names follow the reference torch
``state_dict`` (``downs.0.2.fn.fn.to_qkv.weight``, ...).

Tensor parallelism (``parallel.mesh.shard_model``): every ResnetBlock's
convs and time-embedding Linear, the attentions' ``to_qkv``/``to_out``,
the time MLP and the speaker MLP may be split over the 'model' axis along
their output channels. A split layer computes its block from the whole
input; elementwise ops and K1 run on the block; the block is gathered
before the first op that mixes channels (two gathers a ResnetBlock). The
attention gathers its weights and runs whole on every rank.
"""

import math

import torch
from torch import nn

from gradtts_tpu_torch.models.layers import (Conv2d, ConvTranspose2d,
                                             draw, mish, output_block,
                                             split_apply)
from gradtts_tpu_torch.ops.conv3x3 import conv3x3, tap_major, use_kernel
from gradtts_tpu_torch.ops.groupnorm_mish import fits, groupnorm_mish
from gradtts_tpu_torch.ops.linear_attention import linear_attention_rezero
from gradtts_tpu_torch.parallel.tensor import (gather_from_model,
                                               scatter_to_model)
from gradtts_tpu_torch.utils.profiling import span

CL = torch.channels_last


def get_noise(t, beta_init, beta_term, cumulative=False):
    """Linear beta schedule; ``cumulative`` gives its integral."""
    if cumulative:
        return beta_init * t + 0.5 * (beta_term - beta_init) * (t ** 2)
    return beta_init + (beta_term - beta_init) * t


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t, scale: float = 1000.0):
        half = self.dim // 2
        step = math.log(10000) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                       device=t.device) * -step)
        emb = scale * t[:, None].float() * freqs[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class Block(nn.Module):
    """conv3x3 -> masked GroupNorm + Mish (kernel K1); ``block.0`` is the
    conv and ``block.1`` holds the norm's f32 affine parameters. The conv
    is the hand kernel (``ops.conv3x3``) where
    :func:`~gradtts_tpu_torch.ops.conv3x3.use_kernel` says so (CUDA f32
    with cuDNN's TF32 off), with its tap-major weight kept on the conv;
    else cuDNN's (or oneDNN's) call.

    With its conv split over the 'model' axis it returns this rank's
    output-channel block: K1 runs on the block with groups / M groups
    (GroupNorm's statistics are per group, so whole groups a rank give the
    same numbers) where M divides the groups and K1 takes the block's
    width (:func:`~gradtts_tpu_torch.ops.groupnorm_mish.fits`); else the
    blocks are gathered, K1 runs on the whole, and the rank keeps its
    block."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.block = nn.ModuleList([Conv2d(dim, dim_out, 3, padding=1),
                                    nn.GroupNorm(groups, dim_out)])

    def forward(self, x, mask):
        """x [B, C, F, T] channels_last; mask [B, 1, 1, T] in x's dtype."""
        conv, norm = self.block
        split = getattr(conv, 'model_split', None)
        if split is not None:
            return self._split_forward(x, mask, split)
        if use_kernel(x, conv.in_channels, conv.out_channels):
            h = conv3x3(x, mask, conv.weight, conv.bias,
                        conv.kept('taps', conv.weight, tap_major))
        else:
            h = conv(x * mask).contiguous(memory_format=CL)
        b, _, _, t = mask.shape
        y = groupnorm_mish(h.permute(0, 2, 3, 1), mask.view(b, 1, t, 1),
                           norm.weight, norm.bias, norm.num_groups, norm.eps)
        return y.permute(0, 3, 1, 2)

    def _split_forward(self, x, mask, split):
        conv, norm = self.block
        h = output_block(conv, x * mask).contiguous(memory_format=CL)
        b, _, _, t = mask.shape
        mask = mask.view(b, 1, t, 1)
        groups = norm.num_groups // split.size
        if norm.num_groups % split.size == 0 and fits(h.shape[1], groups):
            y = groupnorm_mish(h.permute(0, 2, 3, 1), mask,
                               scatter_to_model(norm.weight, split, 0),
                               scatter_to_model(norm.bias, split, 0),
                               groups, norm.eps)
            return y.permute(0, 3, 1, 2)
        h = gather_from_model(h, split, 1).contiguous(memory_format=CL)
        y = groupnorm_mish(h.permute(0, 2, 3, 1), mask, norm.weight,
                           norm.bias, norm.num_groups, norm.eps)
        return scatter_to_model(y.permute(0, 3, 1, 2), split, 1)


class ResnetBlock(nn.Module):
    """Two Blocks with a time-embedding injection and a residual conv."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int,
                 groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = Conv2d(dim, dim_out, 1) if dim != dim_out \
            else nn.Identity()

    def forward(self, x, mask, time_emb):
        split = getattr(self.block1.block[0], 'model_split', None)
        if split is not None:
            return self._split_forward(x, mask, time_emb, split)
        h = self.block1(x, mask)
        h = h + self.mlp(time_emb)[:, :, None, None].to(h.dtype)
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask)

    def _split_forward(self, x, mask, time_emb, split):
        """Every layer split over the 'model' axis (they share dim_out):
        block1's block plus the time-embedding block, gathered for block2;
        block2's block plus the residual's, gathered."""
        h = self.block1(x, mask)
        emb = output_block(self.mlp[1], mish(time_emb))
        h = gather_from_model(h + emb[:, :, None, None].to(h.dtype), split, 1)
        h = self.block2(h.contiguous(memory_format=CL), mask)
        if isinstance(self.res_conv, nn.Identity):
            res = scatter_to_model(x * mask, split, 1)
        else:
            res = output_block(self.res_conv, x * mask)
        return gather_from_model(h + res, split, 1).contiguous(
            memory_format=CL)


class LinearAttention(nn.Module):
    """Softmax-kernel linear attention over all (F, T) positions; holds the
    reference's ``to_qkv`` (channel order (qkv, heads, dim_head)) and
    ``to_out`` 1x1 convs."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)


class Rezero(nn.Module):
    """The ReZero gain ``g`` around the attention ``fn``."""

    def __init__(self, dim: int):
        super().__init__()
        self.fn = LinearAttention(dim)
        self.g = nn.Parameter(torch.zeros(1))


class Residual(nn.Module):
    """x + g * attention(x), the reference's Residual(Rezero(
    LinearAttention)), computed in one call of K2 + K3 with the output
    projection, the gain and the residual folded in."""

    def __init__(self, dim: int):
        super().__init__()
        self.fn = Rezero(dim)

    def forward(self, x):
        """x [B, C, F, T] channels_last."""
        attn = self.fn.fn
        hidden = attn.heads * attn.dim_head
        c = x.shape[1]
        w, w_out = attn.to_qkv.weight, attn.to_out.weight
        # under autograd the f32 weights go in (their grads come back in
        # f32, as in the JAX package); else the kept cast to x's dtype
        if not (torch.is_grad_enabled() and w.requires_grad):
            w = attn.to_qkv.cast('weight', x.dtype)
        # split over the 'model' axis, the weights are gathered and every
        # rank runs the whole attention: a block of to_qkv's outputs is
        # not whole heads, and K2-K5 are built for heads x dim_head = 128
        split = getattr(attn.to_qkv, 'model_split', None)
        if split is not None:
            w = gather_from_model(w, split, 0)
        split = getattr(attn.to_out, 'model_split', None)
        if split is not None:
            w_out = gather_from_model(w_out, split, 0)
        w = w.view(3 * hidden, c).t()                            # [C, 3H]
        y = linear_attention_rezero(
            x.contiguous(memory_format=CL).permute(0, 2, 3, 1),
            w[:, :hidden], w[:, hidden:2 * hidden], w[:, 2 * hidden:],
            w_out.view(c, hidden).t(), attn.to_out.bias,
            self.fn.g, attn.dim_head)
        return y.permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = ConvTranspose2d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


class GradLogPEstimator2d(nn.Module):
    """U-Net over (F, T) with [mu, x_t(, spk)] as input channels.

    Interface as in the JAX package: x, mu [B, T, F]; mask [B, T]; t [B];
    spk [B, spk_emb_dim] (already embedded) or None; returns [B, T, F] in
    f32. Runs in ``compute_dtype`` (``models.tts.set_compute_dtype``); the
    time and speaker MLPs and the GroupNorm stay f32.

    Speakers (:513-545): with ``n_spks > 1`` the speaker MLP's output,
    broadcast over time, is a third input channel. With ``n_spks == -1``
    the JAX package computes the MLP and uses its output nowhere (the
    fork's quirk): the parameters exist so that a reference checkpoint
    loads, and the output does not depend on the vector, so the MLP is
    not run, and its parameters need no grad (Adam leaves them as they
    are on both sides, and ``DistributedDataParallel`` waits for no grad
    of theirs)."""

    def __init__(self, dim: int, dim_mults=(1, 2, 4), groups: int = 8,
                 n_feats: int = 80, pe_scale: float = 1000.0,
                 n_spks: int = 1, spk_emb_dim: int = 64):
        super().__init__()
        self.pe_scale = pe_scale
        self.n_spks = n_spks
        self.compute_dtype = torch.float32
        self.spk_mlp = None
        if n_spks > 1 or n_spks == -1:
            self.spk_mlp = nn.Sequential(
                nn.Linear(spk_emb_dim, spk_emb_dim * 4), Mish(),
                nn.Linear(spk_emb_dim * 4, n_feats))
            self.spk_mlp.requires_grad_(n_spks > 1)
        self.time_pos_emb = SinusoidalPosEmb(dim)
        self.mlp = nn.Sequential(nn.Linear(dim, dim * 4), Mish(),
                                 nn.Linear(dim * 4, dim))
        dims = [3 if n_spks > 1 else 2] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(dim_in, dim_out, dim, groups),
                ResnetBlock(dim_out, dim_out, dim, groups),
                Residual(dim_out),
                nn.Identity() if last else Downsample(dim_out)]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, dim, groups)
        self.mid_attn = Residual(mid)
        self.mid_block2 = ResnetBlock(mid, mid, dim, groups)
        self.ups = nn.ModuleList()
        for dim_in, dim_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResnetBlock(dim_out * 2, dim_in, dim, groups),
                ResnetBlock(dim_in, dim_in, dim, groups),
                Residual(dim_in),
                Upsample(dim_in)]))
        self.final_block = Block(dim, dim, groups)
        self.final_conv = Conv2d(dim, 1, 1)

    def block_widths(self):
        """(C_in, C_out, level) of each Block's convolution, in the order
        they run (25 of them): a level-l Block sees ``n_feats >> l`` rows
        and ``T >> l`` frames."""
        top = len(self.downs) - 1
        levels = ([(d, i) for i, d in enumerate(self.downs)]
                  + [((self.mid_block1, self.mid_block2), top)]
                  + [(u, top - i) for i, u in enumerate(self.ups)])
        blocks = [(b, lv) for group, lv in levels for r in group[:2]
                  for b in (r.block1, r.block2)] + [(self.final_block, 0)]
        return [(b.block[0].in_channels, b.block[0].out_channels, lv)
                for b, lv in blocks]

    def forward(self, x, mask, mu, t, spk=None):
        """One evaluation, in the span ``gradtts.unet``; its 25 sub-spans
        (``utils.profiling.SPANS``) are the same at every width."""
        with span('gradtts.unet'):
            dtype = self.compute_dtype
            with span('gradtts.unet.embed'):
                t_emb = _mlp(self.mlp,
                             self.time_pos_emb(t, scale=self.pe_scale))
                chans = [mu.transpose(1, 2), x.transpose(1, 2)]
                if self.n_spks > 1:
                    if spk is None:
                        raise ValueError(f'a {self.n_spks}-speaker estimator '
                                         'needs the speaker embedding spk')
                    s = _mlp(self.spk_mlp, spk.float())         # [B, F]
                    chans.append(s[:, :, None].expand(-1, -1, x.shape[1]))
                h = torch.stack(chans, dim=1)
                h = h.to(dtype).contiguous(memory_format=CL)  # [B, 2|3, F, T]
                m = mask[:, None, None, :].to(dtype)             # [B, 1, 1, T]

            hiddens, masks = [], [m]
            for res1, res2, attn, down in self.downs:
                mask_down = masks[-1]
                with span('gradtts.unet.resnet'):
                    h = res1(h, mask_down, t_emb)
                with span('gradtts.unet.resnet'):
                    h = res2(h, mask_down, t_emb)
                with span('gradtts.unet.attention'):
                    h = attn(h)
                hiddens.append(h)
                with span('gradtts.unet.resample'):
                    h = down(h * mask_down)
                    masks.append(mask_down[:, :, :, ::2].contiguous())
            masks = masks[:-1]
            mask_mid = masks[-1]
            with span('gradtts.unet.resnet'):
                h = self.mid_block1(h, mask_mid, t_emb)
            with span('gradtts.unet.attention'):
                h = self.mid_attn(h)
            with span('gradtts.unet.resnet'):
                h = self.mid_block2(h, mask_mid, t_emb)
            for res1, res2, attn, up in self.ups:
                mask_up = masks.pop()
                # the skip connection's cat is the first block's input and
                # sits in its span: a level keeps its four sub-spans
                with span('gradtts.unet.resnet'):
                    h = torch.cat([h, hiddens.pop()], dim=1)
                    h = res1(h, mask_up, t_emb)
                with span('gradtts.unet.resnet'):
                    h = res2(h, mask_up, t_emb)
                with span('gradtts.unet.attention'):
                    h = attn(h)
                with span('gradtts.unet.resample'):
                    h = up(h * mask_up)
            with span('gradtts.unet.out'):
                h = self.final_block(h, m)
                out = (self.final_conv(h * m) * m).float()      # [B, 1, F, T]
                return out[:, 0].transpose(1, 2)


def _mlp(seq, x):
    """``seq(x)`` of a Linear -> Mish -> Linear ``nn.Sequential``, each
    Linear split over the 'model' axis or whole (``split_apply``)."""
    return split_apply(seq[2], mish(split_apply(seq[0], x)))


class Diffusion(nn.Module):
    """Holds the estimator under the reference's ``decoder.estimator``."""

    def __init__(self, n_feats: int, dim: int, beta_min: float,
                 beta_max: float, pe_scale: float, n_spks: int = 1,
                 spk_emb_dim: int = 64):
        super().__init__()
        self.beta_min, self.beta_max = beta_min, beta_max
        self.estimator = GradLogPEstimator2d(dim, n_feats=n_feats,
                                             pe_scale=pe_scale, n_spks=n_spks,
                                             spk_emb_dim=spk_emb_dim)


def reverse_diffusion(estimator, z, mask, mu, n_timesteps: int, beta_min,
                      beta_max, stoc: bool = False, spk=None, noise=None,
                      generator=None):
    """Euler steps of the reverse diffusion (``reverse_diffusion`` :662):
    the probability-flow ODE, or with ``stoc`` the Euler-Maruyama SDE,
    whose step adds N(0, 1) sqrt(noise_t h) to the drift
    (0.5 (mu - x) - score) noise_t h. z, mu [B, T, F]; mask [B, T, 1];
    ``spk`` the embedded speaker passed to the estimator. The SDE's draws
    are ``noise`` [n_timesteps, B, T, F], or drawn step by step from
    ``generator`` when None."""
    h = 1.0 / n_timesteps
    with span('gradtts.decoder'):
        xt = z * mask
        for i in range(n_timesteps):
            step = torch.full((z.shape[0],), float(i), dtype=z.dtype,
                              device=z.device)
            t = 1.0 - (step + 0.5) * h
            noise_t = get_noise(t[:, None, None], beta_min, beta_max)
            score = estimator(xt, mask[..., 0], mu, t, spk)
            if stoc:
                draw = noise[i].to(z) if noise is not None else torch.randn(
                    z.shape, generator=generator, dtype=z.dtype,
                    device=z.device)
                dxt = (0.5 * (mu - xt) - score) * noise_t * h \
                    + draw * torch.sqrt(noise_t * h)
            else:
                dxt = 0.5 * (mu - xt - score) * noise_t * h
            xt = (xt - dxt) * mask
        return xt


def _linspace(start, stop, num: int):
    """``jnp.linspace`` as the JAX package computes it: start (1 - s) +
    stop s at s = i / (num - 1), and the last point ``stop`` itself
    (``torch.linspace`` may differ from it in the last ulp)."""
    s = torch.arange(num - 1, dtype=start.dtype, device=start.device) \
        / (num - 1)
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def interp(x, xp, fp):
    """``jnp.interp`` (numpy's ``interp``) on ``torch.searchsorted``: linear
    interpolation in the increasing table (xp, fp), held at fp[0] left of
    xp[0] and at fp[-1] right of xp[-1]."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    f = fp[i - 1] + ((x - xp[i - 1]) / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def dpm_grid(n: int, beta_min, beta_max, t_min: float = 0.02,
             dtype=torch.float32, device=None):
    """The DPM-Solver grid of ``reverse_diffusion_dpm`` (:738-749): n + 1
    times ``ts`` (1 down to ``t_min``) uniform in the log-SNR lambda =
    log(alpha / sigma), found by inverting lambda(t) on a 2049-point
    table; alpha_t = exp(-zeta), zeta = 0.5 int beta; sigma_t =
    sqrt(1 - alpha_t^2) as -expm1(-2 zeta), which keeps its digits near
    t_min. Returns (ts, alphas, sigmas, hs), hs the n log-SNR steps."""
    t_min = torch.tensor(t_min, dtype=dtype, device=device)
    tt = _linspace(t_min, torch.ones_like(t_min), 2049)
    zt = 0.5 * get_noise(tt, beta_min, beta_max, cumulative=True)
    lam_tab = -zt - 0.5 * torch.log(-torch.expm1(-2.0 * zt))
    lam_edges = _linspace(lam_tab[-1], lam_tab[0], n + 1)
    # lambda falls as t grows: the table reversed is increasing
    ts = interp(lam_edges, lam_tab.flip(0), tt.flip(0))
    zetas = 0.5 * get_noise(ts, beta_min, beta_max, cumulative=True)
    alphas = torch.exp(-zetas)
    sigmas = torch.sqrt(-torch.expm1(-2.0 * zetas))
    return ts, alphas, sigmas, lam_edges[1:] - lam_edges[:-1]


def reverse_diffusion_dpm(estimator, z, mask, mu, n_timesteps: int, beta_min,
                          beta_max, spk=None, t_min: float = 0.02):
    """DPM-Solver-2M with eps prediction on the uniform log-SNR grid of
    :func:`dpm_grid` (``reverse_diffusion_dpm`` :698). With y = x - mu and
    the noise prediction eps = -sigma_t score, a step is
    y' = (alpha_r / alpha_t) y - sigma_r expm1(h) E, E = eps on the first
    step and (1 + 1/2r) eps - (1/2r) eps_prev after it, r = h_prev / h.
    One estimator call a step, as Euler. z, mu [B, T, F]; mask [B, T, 1]."""
    with span('gradtts.decoder'):
        ts, alphas, sigmas, hs = dpm_grid(n_timesteps, beta_min, beta_max,
                                          t_min, z.dtype, z.device)
        xt = z * mask
        e_prev = h_prev = None
        for i in range(n_timesteps):
            t = ts[i].expand(z.shape[0])
            eps = -sigmas[i] * estimator(xt, mask[..., 0], mu, t, spk)
            h = hs[i]
            if i == 0:
                e_ext = eps
            else:
                r = h_prev / h
                e_ext = (1.0 + 0.5 / r) * eps - (0.5 / r) * e_prev
            y = (alphas[i + 1] / alphas[i]) * (xt - mu) \
                - sigmas[i + 1] * torch.expm1(h) * e_ext
            xt = (mu + y) * mask
            e_prev, h_prev = eps, h
        return xt


def forward_diffusion(x0, mask, mu, t, z, beta_min, beta_max):
    """Closed-form sample of q(x_t | x_0) (``forward_diffusion`` :649) with
    the standard normal draw ``z`` [B, T, F] as an input. mask [B, T, 1].
    Returns (x_t * mask, z * mask)."""
    cum_noise = get_noise(t[:, None, None], beta_min, beta_max,
                          cumulative=True)
    decay = torch.exp(-0.5 * cum_noise)
    mean = x0 * decay + mu * (1.0 - decay)
    xt = mean + z * torch.sqrt(1.0 - torch.exp(-cum_noise))
    return xt * mask, z * mask


def diffusion_loss(estimator, x0, mask, mu, beta_min, beta_max, t=None,
                   z=None, generator=None, offset: float = 1e-5, spk=None,
                   count=None):
    """Score-matching loss (``diffusion_loss`` :773). ``t`` [B] (clipped to
    [offset, 1 - offset]) and ``z`` [B, T, F] are the uniform and normal
    draws; each that is None is drawn from ``generator`` (a
    ``torch.Generator`` or a ``RowShard``). mask [B, T, 1]; ``spk`` the
    embedded speaker. The sum of squares is divided by ``count``, the
    masked elements of the global batch where this process holds a part
    of it (:786 divides by the global batch's under its mesh), or by this
    batch's own (``sum(mask) * F``) where None. Returns (loss, x_t, t)."""
    if t is None:
        t = draw(torch.rand, (x0.shape[0],), generator, dtype=x0.dtype,
                 device=x0.device)
    if z is None:
        z = draw(torch.randn, x0.shape, generator, dtype=x0.dtype,
                 device=x0.device)
    t = torch.clamp(t, offset, 1.0 - offset)
    xt, z = forward_diffusion(x0, mask, mu, t, z, beta_min, beta_max)
    cum_noise = get_noise(t[:, None, None], beta_min, beta_max,
                          cumulative=True)
    est = estimator(xt, mask[..., 0], mu, t, spk)
    est = est * torch.sqrt(1.0 - torch.exp(-cum_noise))
    if count is None:
        count = torch.sum(mask) * x0.shape[-1]
    loss = torch.sum((est + z) ** 2) / count
    return loss, xt, t
