"""Frozen arithmetic of the benchmark: the H100's peaks, the bytes and
operations of each hand kernel's work as functions of its shape, and the
model FLOPs of a call.

The kernel arithmetic is ``chip_smoke.py``'s (``bound``, ``_timed`` and the
``work`` table of ``phase_kernels``; the Block convolution's as
``phase_conv3x3`` counts it), copied so that a later change to the program
cannot move the yardstick. One departure: K6's outputs count one split a
batch item (as K2's do), not the program's tiling, so the bound does not
follow the program's choice of splits. The U-Net's Block convolutions are
listed here from ``dec_dim`` and the speakers, not read from the program.

Model FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference on the meta device (convolutions and matrix
products; elementwise work is not counted), at the cell's padded shapes,
so the count is the same whatever implements the work.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet: HBM bytes/s and dense peak rates (bf16 on
# the tensor cores, f32 on the CUDA cores, with TF32 off)
HBM_BPS = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
HIDDEN = 128            # heads x dim_head of every linear attention
DIM_HEAD = 32
SIZE = {'bfloat16': 2, 'float32': 4}

# the program's hand kernels by family, as their CUDA entry names begin
KERNEL_FAMILIES = {
    'K1': ('gn_stats_kernel', 'gn_apply_kernel'),
    'K2': ('la_stats_kernel',),
    'K3': ('la_apply_kernel',),
    'K4': ('la_bwd1_kernel', 'la_bwd1_tc_kernel'),
    'K5': ('la_bwd2_kernel', 'la_bwd2_dx_kernel', 'la_bwd2_dw_kernel'),
    'K6': ('la_jvp_stats_kernel',),
    'K7': ('la_jvp_apply_kernel',),
    'MAS': ('mas_kernel', 'mas_dp_kernel', 'mas_path_kernel'),
    'conv3x3': ('conv3x3_kernel', 'conv3x3_small_kernel'),
}


def bound_s(nbytes, flops, peak):
    """Least seconds for the work on the published rates: the larger of
    bytes over HBM bandwidth and operations over ``peak`` FLOP/s."""
    return max(nbytes / HBM_BPS, flops / peak)


def kernel_work(kernel, B, F, T, C, dtype):
    """(bytes, flops, peak FLOP/s) of one launch of ``kernel`` ('K1'-'K7')
    on activations [B, F, T, C] in ``dtype`` ('bfloat16' or 'float32')."""
    size, H, N = SIZE[dtype], HIDDEN, F * T
    elems = B * N * C
    peak = PEAK_FLOPS[dtype]
    if kernel == 'K1':
        return (2 * elems * size + B * T * size, 13 * elems,
                PEAK_FLOPS['float32'])
    if kernel == 'K2':
        return (elems * size + 2 * C * H * size
                + B * (H * DIM_HEAD + 2 * H) * 4,
                B * N * (4 * C * H + 2 * H * DIM_HEAD + 2 * H), peak)
    if kernel == 'K3':
        return (2 * elems * size + C * H * size + B * H * C * size + C * 4,
                B * N * (4 * C * H + C), peak)
    if kernel == 'K4':
        return (2 * elems * size + C * H * size + 2 * B * H * C * size
                + C * 4 + B * H * C * 4 + C * H * 4 + 2 * C * 4,
                B * N * 10 * C * H, peak)
    if kernel == 'K5':
        return (3 * elems * size + 3 * C * H * size
                + B * (C * H + H * H) * size + 2 * B * H * 4
                + 2 * C * H * 4,
                B * N * (16 * C * H + 4 * H * DIM_HEAD), peak)
    if kernel == 'K6':
        return (2 * elems * size + 2 * C * H * size
                + B * (3 * H + 2 * H * DIM_HEAD) * 4,
                B * N * (8 * C * H + 6 * H * DIM_HEAD + 2 * H), peak)
    if kernel == 'K7':
        return (4 * elems * size + C * H * size + 2 * B * H * C * size
                + 2 * C * 4, B * N * (10 * C * H + 4 * C), peak)
    raise KeyError(kernel)


def mas_work(B, Tx, Ty, valid_cells):
    """(bytes, flops, peak) of one MAS launch over [B, Tx, Ty], of which
    ``valid_cells`` lie inside the masks."""
    return 3 * B * Tx * Ty * 4, 4 * valid_cells, PEAK_FLOPS['float32']


def conv3x3_work(B, F, T, c_in, c_out):
    """(bytes, flops, peak FLOP/s) of one launch of the Block convolution
    (3x3, stride 1, padding 1, f32) of [B, c_in, F, T] to [B, c_out, F, T]
    under the time mask [B, T]: a multiply-add for each of 9 c_in taps of
    each output, and each element of the input, output, mask, weight and
    bias moved once."""
    return (4 * (B * F * T * (c_in + c_out) + B * T + 9 * c_in * c_out
                 + c_out), 18 * B * F * T * c_in * c_out,
            PEAK_FLOPS['float32'])


def unet_blocks(dim, n_spks):
    """(C_in, C_out, level) of the score U-Net's 25 Block convolutions a
    pass, in the order they run, for dim_mults (1, 2, 4): two ResnetBlocks
    of two Blocks at each down level, the first from the 2 input channels
    (mu, x) or 3 (with the speaker), four in the middle, two ResnetBlocks
    at each up level (the first from the skip's concatenation), and the
    final Block. A level-l Block sees ``n_feats >> l`` rows and ``T >> l``
    frames."""
    dims = [3 if n_spks > 1 else 2, dim, 2 * dim, 4 * dim]
    out = []
    for level, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(a, b, level)] + [(b, b, level)] * 3
    out += [(4 * dim, 4 * dim, 2)] * 4
    for level, (a, b) in ((2, (2 * dim, 4 * dim)), (1, (dim, 2 * dim))):
        out += [(2 * b, a, level)] + [(a, a, level)] * 3
    return out + [(dim, dim, 0)]


def conv3x3_bound_s(B, n_feats, T, dim, n_spks, calls=1):
    """Least seconds of the Block convolutions of ``calls`` U-Net passes
    at [B, T]."""
    return calls * sum(
        bound_s(*conv3x3_work(B, n_feats >> level, T >> level, a, b))
        for a, b, level in unet_blocks(dim, n_spks))


def unet_levels(n_feats, T, dim):
    """The U-Net's levels at T frames: ((F, T, C), GroupNorm+Mish blocks,
    linear attentions) a forward call, for dim_mults (1, 2, 4): the down
    path, the middle, the up path and the final block."""
    return [((n_feats, T, dim), 5, 1),
            ((n_feats // 2, T // 2, 2 * dim), 4, 1),
            ((n_feats // 4, T // 4, 4 * dim), 8, 2),
            ((n_feats // 4, T // 4, 2 * dim), 4, 1),
            ((n_feats // 2, T // 2, dim), 4, 1)]


def kernel_bound_s(families, B, n_feats, T, dim, dtype, calls=1):
    """Least seconds of the hand-kernel work of ``calls`` U-Net passes at
    [B, T]: per level, K1 for each block and ``families`` (of 'K2'-'K7')
    for each attention."""
    total = 0.0
    for (F, t, C), blocks, attns in unet_levels(n_feats, T, dim):
        total += blocks * bound_s(*kernel_work('K1', B, F, t, C, dtype))
        for k in families:
            total += attns * bound_s(*kernel_work(k, B, F, t, C, dtype))
    return calls * total


def _flops(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_flop_counts()['Global']


def _split(counts):
    """(FLOPs of products with a weight, FLOPs of products of two
    activations): convolutions and linear layers against the attention
    products."""
    bilinear = sum(v for k, v in counts.items() if 'bmm' in str(k))
    return sum(counts.values()) - bilinear, bilinear


def encoder_flops(model, B, Tx, train=False):
    x = torch.zeros((B, Tx), dtype=torch.long, device='meta')
    lengths = torch.full((B,), Tx, device='meta')

    def run():
        mu, logw, _ = model.encoder(x, lengths)
        if train:
            (mu.sum() + logw.sum()).backward()
    return sum(_flops(run).values())


def unet_flops(model, B, T, mode='forward'):
    """FLOPs of one score U-Net call at [B, T]: 'forward'; 'train'
    (forward and backward); 'jvp' (forward and the tangent along x: a
    product with a weight once more, a product of two activations twice)."""
    c = model.cfg
    x = torch.zeros((B, T, c['n_feats']), device='meta')
    mask = torch.ones((B, T), device='meta')
    t = torch.ones((B,), device='meta')
    spk = (torch.zeros((B, c['spk_emb_dim']), device='meta')
           if c['n_spks'] > 1 else None)
    xi = x.requires_grad_() if mode == 'train' else x

    def run():
        s = model.score(xi, mask, x, t, spk)
        if mode == 'train':
            s.sum().backward()
    counts = _flops(run)
    if mode == 'jvp':
        linear, bilinear = _split(counts)
        return 2 * linear + 3 * bilinear
    return sum(counts.values())


def vocoder_flops(vocoder, B, T, n_mels):
    mel = torch.zeros((B, T, n_mels), device='meta')
    return sum(_flops(lambda: vocoder(mel)).values())


def grid_flops(B, Tx, Ty, n_feats):
    """The log-prior grid's product mu_x y^T."""
    return 2 * B * Tx * Ty * n_feats


def meta_model(build):
    """``build()`` on the meta device, with every parameter needing grad."""
    with torch.device('meta'):
        model = build()
    return model

