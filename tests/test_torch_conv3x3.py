"""The Block convolution's kernel (``ops/conv3x3.py``, ``csrc/conv3x3.cu``):
on the CPU its plain version and autograd Function against the Block's
cuDNN/oneDNN call, primal, tangent and gradient, and the dispatch rule of
``Block``; on an NVIDIA GPU (``cuda`` tests, skipped without one) the
kernel against the plain version in float64 at every width of both
configurations, and its launches on the scoring and synthesis paths.
JAX-free, so the ``cuda`` tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3x3.py
"""

import types

import numpy as np
import pytest
import torch

from gradtts_tpu_torch.models import diffusion
from gradtts_tpu_torch.models.diffusion import Block, GradLogPEstimator2d
from gradtts_tpu_torch.ops import conv3x3 as c3
from gradtts_tpu_torch.parallel.tensor import ModelSplit

CL = torch.channels_last
# oneDNN's CPU convolution is not bit-repeatable from call to call: one 3x3
# convolution of a Block moved its output by 8e-6 of its largest value
# between two calls in one process. The CPU tests compare two calls of it;
# 1e-4 covers that, and a routing fault (a wrong tap, a lost bias or mask)
# moves outputs by O(1)
ONEDNN = dict(rtol=1e-4, atol=1e-4)


def _block_shapes():
    """(C_in, C_out, F) of every Block of the score U-Net at the published
    width, without speakers (ljspeech: 2 input channels) and with them
    (tedlium-spk: 3), each once."""
    shapes = []
    for n_spks in (1, 675):
        est = GradLogPEstimator2d(64, n_spks=n_spks, spk_emb_dim=128)
        for c_in, c_out, level in est.block_widths():
            if (c_in, c_out, 80 >> level) not in shapes:
                shapes.append((c_in, c_out, 80 >> level))
    return shapes


SHAPES = _block_shapes()
IDS = [f'{ci}-{co}-F{f}' for ci, co, f in SHAPES]


def _inputs(c_in, c_out, F, T, B=2, seed=0, device='cpu',
            dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype,
                            device=device)

    x = t((B, c_in, F, T)).contiguous(memory_format=CL)
    mask = torch.ones((B, 1, 1, T), dtype=dtype, device=device)
    mask[-1, ..., T - T // 3:] = 0                  # a shorter last row
    w = t((c_out, c_in, 3, 3), (9 * c_in) ** -0.5)
    b = t((c_out,), 0.1)
    return x, mask, w, b


def test_block_shapes_cover_both_configurations():
    # the widths the kernel must take (csrc/conv3x3.cu: C_in 2, 3 or a
    # multiple of 8, C_out a multiple of 64), all of them Block widths
    assert {ci for ci, _, _ in SHAPES} == {2, 3, 64, 128, 256, 512}
    assert {co for _, co, _ in SHAPES} == {64, 128, 256}
    assert {f for _, _, f in SHAPES} == {80, 40, 20}
    assert all(c3.fits(ci, co) for ci, co, _ in SHAPES)


@pytest.mark.parametrize('dim,n_spks', [(16, 1), (16, 5)],
                         ids=['no-speakers', 'speakers'])
def test_block_widths_are_the_blocks_as_they_run(dim, n_spks):
    # the table the shapes above come from: every Block in the order it
    # runs, its conv's widths, and the rows of F its input holds
    est = GradLogPEstimator2d(dim, n_spks=n_spks, spk_emb_dim=8).eval()
    seen = []
    for m in est.modules():
        if isinstance(m, Block):
            m.register_forward_hook(lambda mod, args, out: seen.append(
                (mod.block[0].in_channels, mod.block[0].out_channels,
                 args[0].shape[2])))
    x, mu = torch.randn(2, 24, 80), torch.randn(2, 24, 80)
    with torch.no_grad():
        est(x, torch.ones(2, 24), mu, torch.tensor([0.3, 0.8]),
            torch.randn(2, 8) if n_spks > 1 else None)
    assert [(ci, co, 80 >> lv) for ci, co, lv in est.block_widths()] == seen
    assert len(seen) == 25


@pytest.mark.parametrize('c_in,c_out,F', SHAPES, ids=IDS)
def test_plain_and_function_equal_the_block_conv(c_in, c_out, F):
    # the kernel's plain version and its Function (CPU: the plain version)
    # against the Block's call, conv(x * mask) with its bias: the primal,
    # the torch.func.jvp tangent along x and the gradient, each a second
    # call of the same oneDNN convolution (ONEDNN)
    x, mask, w, b = _inputs(c_in, c_out, F, 10)
    conv = torch.nn.Conv2d(c_in, c_out, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
        want = conv(x * mask)
        torch.testing.assert_close(c3.conv3x3_plain(x, mask, w, b), want,
                                   **ONEDNN)
        got = c3.conv3x3(x, mask, w, b)
        assert got.is_contiguous(memory_format=CL)
        torch.testing.assert_close(got, want, **ONEDNN)
    dx = torch.randn_like(x).contiguous(memory_format=CL)
    p_want, t_want = torch.func.jvp(lambda a: conv(a * mask), (x,), (dx,))
    p_got, t_got = torch.func.jvp(lambda a: c3.conv3x3(a, mask, w, b), (x,),
                                  (dx,))
    torch.testing.assert_close(p_got, p_want, **ONEDNN)
    torch.testing.assert_close(t_got, t_want, **ONEDNN)
    xs, ws, bs, x_ref = (v.detach().clone().requires_grad_()
                         for v in (x, w, b, x))
    dy = torch.randn_like(want)
    c3.conv3x3(xs, mask, ws, bs).backward(dy)
    conv(x_ref * mask).backward(dy)
    for g, g_ref in ((xs, x_ref), (ws, conv.weight), (bs, conv.bias)):
        torch.testing.assert_close(g.grad, g_ref.grad, **ONEDNN)


@pytest.mark.parametrize('moving', ['weight', 'bias'])
def test_weight_and_bias_tangents_are_refused(moving):
    # no path of the port gives the weights a tangent; the rule refuses one
    # rather than drop it
    x, mask, w, b = _inputs(8, 64, 6, 9)
    args = {'weight': w, 'bias': b}

    def f(p):
        return c3.conv3x3(x, mask, **{**args, moving: p})

    with pytest.raises(NotImplementedError, match='tangent'):
        torch.func.jvp(f, (args[moving],), (torch.ones_like(args[moving]),))


def _case(device, dtype):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize('device,dtype,tf32,c_in,c_out,takes', [
    ('cuda', torch.float32, False, 64, 64, True),
    ('cuda', torch.float32, False, 3, 64, True),
    ('cuda', torch.float32, False, 512, 128, True),
    ('cuda', torch.float32, True, 64, 64, False),     # TF32 asked for
    ('cuda', torch.bfloat16, False, 64, 64, False),
    ('cuda', torch.float16, False, 64, 64, False),
    ('cuda', torch.float32, False, 64, 16, False),    # C_out not x64
    ('cuda', torch.float32, False, 2, 64, True),
    ('cuda', torch.float32, False, 12, 64, False),    # C_in neither
    ('cuda', torch.float32, False, 1, 64, False),     # no Block's C_in
    ('cuda', torch.float32, False, 4, 64, False),
    ('cpu', torch.float32, False, 64, 64, False),
], ids=['f32', 'f32-cin3', 'f32-cin512', 'tf32', 'bf16', 'fp16',
        'cout16', 'f32-cin2', 'cin12', 'cin1', 'cin4', 'cpu'])
def test_dispatch_rule(monkeypatch, device, dtype, tf32, c_in, c_out, takes):
    # what the caller can see: the input's device and dtype, its widths
    # and its own request for full-f32 convolutions
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
    assert c3.use_kernel(_case(device, dtype), c_in, c_out) is takes


@pytest.mark.parametrize('split', [False, True], ids=['whole', 'model_split'])
def test_block_routes_by_the_rule(monkeypatch, split):
    # with the rule forced on (CPU: the Function's plain version) a Block
    # gives what its cuDNN route gives and keeps its tap-major weight; a
    # Block whose conv is split over the 'model' axis never asks for the
    # kernel (a one-rank split needs no collective in forward)
    calls = []

    def counted(*args):
        calls.append(args)
        return real(*args)

    real = diffusion.conv3x3
    torch.manual_seed(0)
    blk = Block(64, 128)
    x, mask, _, _ = _inputs(64, 128, 8, 12)
    with torch.no_grad():
        want = blk(x, mask)
        if split:
            blk.block[0].model_split = ModelSplit(None, 0, 1, 0)
        monkeypatch.setattr(diffusion, 'use_kernel', lambda *a: True)
        monkeypatch.setattr(diffusion, 'conv3x3', counted)
        got = blk(x, mask)
    torch.testing.assert_close(got, want, **ONEDNN)
    assert len(calls) == (0 if split else 1)
    if not split:
        taps = calls[0][4]
        assert torch.equal(taps, c3.tap_major(blk.block[0].weight))
        with torch.no_grad():
            blk(x, mask)
            assert calls[1][4] is taps              # kept while unchanged
            blk.block[0].weight.mul_(2)
            blk(x, mask)
        assert torch.equal(calls[2][4], c3.tap_major(blk.block[0].weight))


def test_bf16_block_keeps_the_conv(monkeypatch):
    # bf16 never reaches the kernel's route, TF32 or not
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(diffusion, 'conv3x3', None)
    torch.manual_seed(0)
    blk = Block(64, 64)
    x, mask, _, _ = _inputs(64, 64, 8, 12, dtype=torch.bfloat16)
    with torch.no_grad():
        assert blk(x, mask).dtype == torch.bfloat16


def test_unet_through_the_function_equals_its_conv_route(monkeypatch):
    # the whole score U-Net (speakers: 3 input channels), forward and
    # torch.func.jvp, with every Block through Conv3x3Fn (its CPU plain
    # version) against the Blocks' own convolutions
    torch.manual_seed(0)
    est = GradLogPEstimator2d(16, n_spks=5, spk_emb_dim=8).eval()
    for m in est.modules():
        if hasattr(m, 'g'):
            m.g.data.fill_(0.5)
    rng = np.random.default_rng(3)
    x, mu, eps = (torch.tensor(rng.standard_normal((2, 24, 80)),
                               dtype=torch.float32) for _ in range(3))
    mask = (torch.arange(24)[None] < torch.tensor([[24], [17]])).float()
    t = torch.tensor([0.3, 0.8])
    spk = torch.randn(2, 8)

    def run():
        with torch.no_grad():
            return torch.func.jvp(lambda a: est(a, mask, mu, t, spk), (x,),
                                  (eps,))

    want = run()
    monkeypatch.setattr(diffusion, 'use_kernel', lambda *a: True)
    calls = []
    real = c3._forward

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(c3, '_forward', counted)
    got = run()
    assert len(calls) == 2 * 25                     # primal and tangent
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **ONEDNN)


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _err_bound(x, mask, w, b):
    """(the float64 truth, 2^-18 of sum |w| |x * mask| + |b|) per output:
    an f32 FMA chain over K = 9 C_in products errs ~ 2^-24 of that sum (a
    rounding of the running sum a step, in random directions), so 2^-18
    leaves a 64x margin; TF32's rounded operands (2^-11 of each product)
    err ~ 2^-11 / sqrt(K) of it, 2^-17 or more at K <= 4608: a kernel that
    summed in TF32 would not pass."""
    d = [v.double() for v in (x, mask, w, b)]
    want = c3.conv3x3_plain(*d)
    mag = c3.conv3x3_plain((d[0] * d[1]).abs(), torch.ones_like(d[1]),
                           d[2].abs(), d[3].abs())
    return want, 2.0 ** -18 * mag


@pytest.mark.cuda
@pytest.mark.parametrize('c_in,c_out,F', SHAPES, ids=IDS)
def test_kernel_matches_plain_at_every_block_width(cuda, c_in, c_out, F):
    # ragged T (not a multiple of the 64-frame tile, and one under it), B
    # 3 with masked frames; the primal with its bias, the tangent without
    for T in (100, 37):
        x, mask, w, b = _inputs(c_in, c_out, F, T, B=3, seed=c_in + T,
                                device=cuda)
        taps = c3.tap_major(w)
        before = c3.conv3x3.launches
        got = c3.conv3x3(x, mask, w, b, taps)
        with torch.no_grad():
            _, tangent = torch.func.jvp(
                lambda a: c3.conv3x3(a, mask, w, b, taps), (x,), (x * 0.5,))
        torch.cuda.synchronize()
        assert c3.conv3x3.launches == before + 3
        assert got.is_contiguous(memory_format=CL)
        want, tol = _err_bound(x, mask, w, b)
        assert bool(((got.double() - want).abs() <= tol).all())
        want_t, tol_t = _err_bound(x * 0.5, mask, w, torch.zeros_like(b))
        assert bool(((tangent.double() - want_t).abs() <= tol_t).all())


def _tiny_full_width_unet(device):
    """A GradTTS with a small encoder and the published U-Net width (dim
    64: every Block width the kernel takes)."""
    from gradtts_tpu_torch.models.tts import GradTTS
    torch.manual_seed(0)
    model = GradTTS(n_vocab=40, n_enc_channels=32, filter_channels=64,
                    filter_channels_dp=16, n_heads=2, n_enc_layers=1,
                    n_feats=80, dec_dim=64).eval()
    for m in model.modules():                # non-zero gains: attention runs
        if hasattr(m, 'g'):
            m.g.data.fill_(0.5)
    return model.to(device)


@pytest.mark.cuda
def test_score_batch_launches_two_per_block_and_step(cuda):
    # forward mode through the U-Net: 25 Blocks, each a primal and a
    # tangent launch, an Euler step; the score against the CPU's (plain
    # versions), as test_torch_cuda's jvp test holds it
    from gradtts_tpu_torch.nbest.scoring import score_batch
    n_euler = 2
    model = _tiny_full_width_unet(cuda)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(1, 40, (2, 12), generator=g)
    x_lengths = torch.tensor([12, 7])
    y = torch.randn((2, 64, 80), generator=g)
    y_lengths = torch.tensor([64, 40])
    eps = torch.randint(0, 2, y.shape, generator=g) * 2.0 - 1
    scores = []
    for dev in (cuda, torch.device('cpu')):
        m = model.to(dev)
        before = c3.conv3x3.launches
        res = score_batch(m, x.to(dev), x_lengths.to(dev), y.to(dev),
                          y_lengths.to(dev), n_euler=n_euler,
                          epsilon=eps.to(dev))
        launched = c3.conv3x3.launches - before
        assert launched == (2 * 25 * n_euler if dev.type == 'cuda' else 0)
        scores.append(res.z.cpu())
    assert float((scores[0] - scores[1]).abs().max()) \
        <= 1e-3 * float(scores[1].abs().max())


@pytest.mark.cuda
def test_bf16_synthesis_launches_none(cuda):
    from gradtts_tpu_torch.models.tts import set_compute_dtype, synthesize
    model = _tiny_full_width_unet(cuda)
    set_compute_dtype(model, torch.bfloat16)
    before = c3.conv3x3.launches
    res = synthesize(model, torch.randint(1, 40, (2, 12), device=cuda),
                     torch.tensor([12, 7], device=cuda), 2, 64)
    torch.cuda.synchronize()
    assert torch.isfinite(res.decoder_outputs).all()
    assert c3.conv3x3.launches == before
