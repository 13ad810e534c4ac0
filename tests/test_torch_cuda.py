"""The CUDA kernels (K1-K7, MAS) against their plain versions on an NVIDIA
GPU, and forward mode through the GPU U-Net; skipped without one. JAX-free, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gradtts_tpu_torch.ops import groupnorm_mish as tgn
from gradtts_tpu_torch.ops import linear_attention as tla


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_groupnorm_mish_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 40, 96, 64)), dtype=dtype,
                     device=cuda)
    mask = torch.ones((2, 1, 96, 1), dtype=dtype, device=cuda)
    mask[1, :, 70:] = 0
    gamma = torch.tensor(rng.standard_normal(64), dtype=torch.float32,
                         device=cuda)
    beta = torch.tensor(rng.standard_normal(64), dtype=torch.float32,
                        device=cuda)
    got = tgn.groupnorm_mish(x * mask, mask, gamma, beta)
    torch.cuda.synchronize()
    want = tgn.groupnorm_mish_plain(x * mask, mask, gamma, beta)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_linear_attention_kernels_match_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    C = 128

    def t(shape, scale=1.0, dt=torch.float32):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dt,
                            device=cuda)

    args = (t((2, 40, 96, C), dt=dtype), t((C, 128), 0.1), t((C, 128), 0.1),
            t((C, 128), 0.1), t((128, C), 0.1), t((C,), 0.1),
            torch.tensor([0.7], device=cuda))
    got = tla.linear_attention_rezero(*args)
    torch.cuda.synchronize()
    want = tla.linear_attention_rezero_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('C', tla._CHANNELS)
def test_attention_stats_and_apply_kernels_match_plain(cuda, C, dtype):
    # K2 and K3 alone at every channel count: ragged N (the training
    # crops' 860 and 3440 rows, and 1001, odd), B 1 and 16, K2 over one
    # split, over the wrapper's splits and over splits that end inside a
    # 64-row tile; tolerances as in chip_smoke.py (TOL)
    rng = np.random.default_rng(6)
    H = tla.HIDDEN

    def t(shape, scale=1.0, dt=dtype):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            device=cuda).to(dt)

    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for B in (1, 16):
        for N in (860, 3440, 1001):
            x = t((B, N, C), 2.0) + 0.5
            wq, wk, wv = (t((C, H), 0.5 / C ** 0.5) for _ in range(3))
            w_out = t((H, C), H ** -0.5, torch.float32)
            b_out = t((C,), 0.1, torch.float32)
            g = torch.tensor([0.7], device=cuda)
            for chunk in (N, tla.split_chunk(B, N), 100):
                got = tla.attention_stats(x, wk, wv, chunk)
                torch.cuda.synchronize()
                want = tla.attention_stats_plain(x, wk, wv, chunk)
                assert got[1].shape == (B, -(-N // chunk), 4, 32, 32)
                (m_k, c_k, d_k), (m_p, c_p, d_p) = (
                    tla.merge_stats(*o) for o in (got, want))
                rows = c_k.shape[:-1]
                for a, b in ((m_k, m_p), (c_k / d_k.reshape(rows)[..., None],
                                          c_p / d_p.reshape(rows)[..., None])):
                    assert bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())
            ctx2, bias = tla.fold_context(c_p, d_p, w_out, b_out, g)
            ctx2 = ctx2.to(dtype)
            got = tla.attention_apply(x, wq, ctx2, bias)
            torch.cuda.synchronize()
            want = tla.attention_apply_plain(x, wq, ctx2, bias)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_linear_attention_backward_kernels_match_plain(cuda, dtype):
    # K4 + K5 under autograd against the plain sweeps, at a ragged row count
    # (40 * 43 rows); f32 weights under a bf16 x, as in the U-Net
    rng = np.random.default_rng(2)
    C = 64

    def t(shape, scale=1.0, dt=torch.float32):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dt,
                            device=cuda)

    args = (t((4, 40, 43, C), dt=dtype), t((C, 128), 0.1), t((C, 128), 0.1),
            t((C, 128), 0.1), t((128, C), 0.1), t((C,), 0.1),
            torch.tensor([0.7], device=cuda))
    dy = t((4, 40, 43, C), dt=dtype)
    grads = []
    for fn in (tla.linear_attention_rezero, tla.linear_attention_rezero_plain):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        fn(*leaves).backward(dy)
        grads.append([a.grad.float() for a in leaves])
    torch.cuda.synchronize()
    # each grad within tol of its largest value: batch-wide f32 sums in
    # other orders, and in bf16 the rare rounding of an intermediate that
    # lands on the other side of a boundary
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


@pytest.mark.cuda
def test_maximum_path_kernel_equals_plain(cuda):
    from gradtts_tpu_torch.ops import mas
    rng = np.random.default_rng(3)
    # Tx above the kernel's 512 threads, ragged lengths
    B, tx, ty = 3, 600, 1400
    t_x, t_y = [600, 300, 17], [1400, 900, 40]
    mask = torch.zeros((B, tx, ty), device=cuda)
    for i in range(B):
        mask[i, :t_x[i], :t_y[i]] = 1.0
    value = torch.tensor(rng.standard_normal((B, tx, ty)) * 30.0 - 100.0,
                         dtype=torch.float32, device=cuda)
    got = mas.maximum_path(value, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, mas.maximum_path_plain(value, mask))


@pytest.mark.cuda
@pytest.mark.parametrize('weight_tangents', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('C', tla._CHANNELS)
def test_linear_attention_jvp_kernels_match_plain(cuda, C, dtype,
                                                  weight_tangents):
    # K6 (with and without weight tangents) and K7 at every channel count:
    # ragged N (the training crops' 860 and 3440 rows, and 1001, odd), B 1
    # and 16, K6 over one split, over the wrapper's splits and over splits
    # that end inside a 64-row tile, against their plain versions
    rng = np.random.default_rng(4)
    H = tla.HIDDEN

    def t(shape, scale=1.0, dt=dtype):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            device=cuda).to(dt)

    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for B in (1, 16):
        for N in (860, 3440, 1001):
            x, dx = t((B, N, C)), t((B, N, C))
            w = [t((C, H), 0.5 / C ** 0.5) for _ in range(3)]
            dw = [t((C, H), 0.05) for _ in range(3)] if weight_tangents \
                else [None] * 3
            for chunk in (N, tla.split_chunk(B, N), 100):
                got = tla.attention_jvp_stats(x, dx, w[1], w[2], dw[1],
                                              dw[2], chunk)
                torch.cuda.synchronize()
                want = tla.attention_jvp_stats_plain(x, dx, w[1], w[2],
                                                     dw[1], dw[2], chunk)
                assert got[1].shape == (B, -(-N // chunk), 4, 32, 32)
                # f32 statistics, sums over up to 3440 rows in other
                # orders: each within 1e-4 of its largest value
                for g, wt in zip(tla.merge_jvp_stats(*got),
                                 tla.merge_jvp_stats(*want)):
                    assert float((g - wt).abs().max()) <= 1e-4 * float(
                        wt.abs().max())
            a, da = t((B, H, C), 0.1), t((B, H, C), 0.1)
            bias = t((C,), 0.1, torch.float32)
            dbias = t((C,), 0.1, torch.float32)
            got = tla.attention_jvp_apply(x, dx, w[0], dw[0], a, da, bias,
                                          dbias)
            torch.cuda.synchronize()
            want = tla.attention_jvp_apply_plain(x, dx, w[0], dw[0], a, da,
                                                 bias, dbias)
            for g, wt in zip(got, want):
                torch.testing.assert_close(g.float(), wt.float(), rtol=tol,
                                           atol=tol)


@pytest.mark.cuda
def test_unet_jvp_on_gpu_matches_plain_on_cpu(cuda):
    # torch.func.jvp through the U-Net: K1, K2, K3 for the primal, K6 and K7
    # for the attention's tangent on the GPU; the plain versions on the CPU.
    # f32 with TF32 off; cuDNN and oneDNN sum convolutions in other orders
    from gradtts_tpu_torch.models.tts import GradTTS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = GradTTS(n_vocab=40, n_enc_channels=32, filter_channels=64,
                    filter_channels_dp=16, n_heads=2, n_enc_layers=1,
                    n_feats=80, dec_dim=16).eval()
    for m in model.modules():                # non-zero gains: attention runs
        if hasattr(m, 'g'):
            m.g.data.fill_(0.5)
    rng = np.random.default_rng(5)
    xt, mu, eps = (torch.tensor(rng.standard_normal((2, 64, 80)),
                                dtype=torch.float32) for _ in range(3))
    mask = (torch.arange(64)[None] < torch.tensor([[64], [40]])).float()
    t = torch.tensor([0.3, 0.8])
    outs = []
    launches = tla.attention_jvp_stats.launches
    for dev in (cuda, torch.device('cpu')):
        m = model.to(dev)
        with torch.no_grad():
            outs.append([o.cpu() for o in torch.func.jvp(
                lambda a: m.estimate(a, mask.to(dev), mu.to(dev), t.to(dev)),
                (xt.to(dev),), (eps.to(dev),))])
    assert tla.attention_jvp_stats.launches == launches + 6
    for g, wt in zip(*outs):
        assert float((g - wt).abs().max()) <= 1e-3 * float(wt.abs().max())


def _bwd2_inputs(rng, cuda, B, N, C, dtype):
    """K5's inputs as the backward hands them over: a block-diagonal dctx,
    weights and A_full^T at the U-Net's scales."""
    H = tla.HIDDEN

    def t(shape, scale=1.0, dt=dtype):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            device=cuda).to(dt)

    x, dy = t((B, N, C), 2.0), t((B, N, C))
    wq, wk, wv = (t((C, H), 0.5 / C ** 0.5) for _ in range(3))
    m = (x.float() @ wk.float()).amax(dim=1)
    a_full_t = t((B, C, H), 0.1)
    dctx = (t((B, H, H), 0.01, torch.float32)
            * tla.head_blockdiag(H, 32, cuda)).to(dtype)
    dden = t((B, H), 1e-3, torch.float32)
    return x, dy, wq, wk, wv, m, a_full_t, dctx, dden


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('C', [64, 128, 256])
def test_bwd_sweep2_kernel_matches_plain(cuda, C, dtype):
    # K5 alone at the training levels' channel counts: ragged row counts
    # (the crops' 860 and 3440 rows, and 1001, odd), B 1 and 16; dx
    # elementwise and dWk, dWv of their largest value, tolerances as in
    # chip_smoke.py (TOL)
    rng = np.random.default_rng(7)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for B, N in ((16, 860), (16, 3440), (1, 1001)):
        args = _bwd2_inputs(rng, cuda, B, N, C, dtype)
        got = tla.attention_bwd_sweep2(*args)
        torch.cuda.synchronize()
        want = tla.attention_bwd_sweep2_plain(*args)
        assert got[0].dtype == dtype and got[0].shape == (B, N, C)
        d = (got[0].float() - want[0].float()).abs()
        assert bool((d <= tol + tol * want[0].float().abs()).all()), \
            float(d.max())
        for g, w in zip(got[1:], want[1:]):
            assert g.shape == (C, tla.HIDDEN) and g.dtype == torch.float32
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('C', [64, 256])
def test_bwd_sweep2_kernel_is_bitwise_repeatable(cuda, C, dtype):
    # per-split partial sums added in a fixed order, no atomics
    args = _bwd2_inputs(np.random.default_rng(8), cuda, 16, 3440, C, dtype)
    first = tla.attention_bwd_sweep2(*args)
    second = tla.attention_bwd_sweep2(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('C', tgn._CHANNELS)
def test_groupnorm_mish_kernel_every_channel_count(cuda, C, dtype):
    # K1 at every channel count, with a row count (F 7 x T 45 = 315) that
    # leaves a ragged last group of rows in every block, a masked tail and
    # values past the one-exponential Mish's v > 20 switch; tolerances as
    # in chip_smoke.py (TOL)
    rng = np.random.default_rng(9)
    B, F, T = 3, 7, 45
    mask = torch.ones((B, 1, T, 1), dtype=dtype, device=cuda)
    mask[2, :, 30:] = 0
    x = torch.tensor(rng.standard_normal((B, F, T, C)) * 2.0 + 0.5,
                     device=cuda).to(dtype) * mask
    gamma = torch.tensor(rng.standard_normal(C) * 8.0, dtype=torch.float32,
                         device=cuda)
    beta = torch.tensor(rng.standard_normal(C), dtype=torch.float32,
                        device=cuda)
    before = tgn.groupnorm_mish.launches
    got = tgn.groupnorm_mish(x, mask, gamma, beta)
    torch.cuda.synchronize()
    assert tgn.groupnorm_mish.launches == before + 1
    want = tgn.groupnorm_mish_plain(x, mask, gamma, beta)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    d = (got.float() - want.float()).abs()
    assert bool((d <= tol + tol * want.float().abs()).all()), float(d.max())
    assert float(got[2, :, 30:].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('C', tla._CHANNELS)
def test_bwd_sweep1_kernel_matches_plain(cuda, C, dtype):
    # K4 alone at every channel count: ragged row counts (the crops' 860
    # and 3440 rows, and 1001, odd), B 1 and 16; each output of its largest
    # value, as in chip_smoke.py (TOL); in bf16 dA within 2^-12, since the
    # kernel keeps q f32 (bf16 hi + lo) for it; two runs give the same bits
    rng = np.random.default_rng(10)
    H = tla.HIDDEN

    def t(shape, scale=1.0, dt=dtype):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            device=cuda).to(dt)

    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    tols = [1e-4 if dtype == torch.float32 else 2 ** -12] + [tol] * 3
    for B, N in ((16, 860), (16, 3440), (1, 1001)):
        args = (t((B, N, C), 2.0), t((B, N, C)), t((C, H), 0.5 / C ** 0.5),
                t((B, C, H), 0.1), t((B, H, C), 0.1),
                t((C,), 0.1, torch.float32))
        got = tla.attention_bwd_sweep1(*args)
        again = tla.attention_bwd_sweep1(*args)
        torch.cuda.synchronize()
        want = tla.attention_bwd_sweep1_plain(*args)
        shapes = [(B, H, C), (C, H), (C,), (C,)]
        for g, a, w, shape, tl in zip(got, again, want, shapes, tols):
            assert tuple(g.shape) == shape and g.dtype == torch.float32
            assert torch.equal(g, a)
            assert float((g - w).abs().max()) <= tl * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('shape,scale', [
    ((16, 384, 1024), 30.0), ((8, 128, 512), 30.0), ((4, 512, 2048), 30.0),
    ((3, 45, 700), 30.0), ((3, 200, 701), 30.0), ((2, 600, 1400), 30.0),
    ((3, 40, 90), 4e8)])
def test_maximum_path_kernel_routes_equal_plain(cuda, shape, scale):
    # MAS bit-exact on both routes: the one-warp DP (Tx <= 512, also a Tx
    # and a Ty that are not multiples of 32 or 4) and the block-wide DP
    # (Tx 600), with ragged lengths and one item at full length; values so
    # large that the cells above the diagonal climb past -1e9
    from gradtts_tpu_torch.ops import mas
    rng = np.random.default_rng(11)
    B, tx, ty = shape
    t_x = rng.integers(tx // 2, tx + 1, B)
    t_y = np.minimum(t_x * rng.uniform(2.0, 4.0, B), ty).astype(int)
    t_x[0], t_y[0] = tx, ty
    mask = torch.zeros(shape, device=cuda)
    for i in range(B):
        mask[i, :t_x[i], :t_y[i]] = 1.0
    value = torch.tensor(rng.standard_normal(shape) * scale - 100.0,
                         dtype=torch.float32, device=cuda)
    before = mas.maximum_path.launches
    got = mas.maximum_path(value, mask)
    torch.cuda.synchronize()
    assert mas.maximum_path.launches == before + 1
    assert torch.equal(got, mas.maximum_path_plain(value, mask))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_generator_on_gpu_matches_cpu(cuda, dtype):
    # the HiFi-GAN V1 generator at its full width: cuDNN's convolutions on
    # the GPU, oneDNN's on the CPU; f32 with TF32 off within 1e-4 of the
    # [-1, 1] waveform. bf16 on the GPU against f32 on the CPU within the
    # JAX package's bf16 bounds (tests/test_hifigan.py)
    from gradtts_tpu_torch.models.hifigan import Generator
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    gen = Generator().eval()
    mel = torch.tensor(np.random.default_rng(7).standard_normal((2, 32, 80)),
                       dtype=torch.float32)
    with torch.no_grad():
        want = gen(mel)
        gen = gen.to(cuda)
        gen.compute_dtype = dtype
        got = gen(mel.to(cuda)).cpu()
    diff = (got - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:
        assert float(diff.max()) < 0.05 and float(diff.mean()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize('spk_setup', ['ids', 'vectors', 'encoder'])
def test_speaker_synthesis_on_gpu_matches_cpu(cuda, spk_setup):
    # 4-step synthesis of a tiny speaker model whose every weight is drawn
    # as chip_smoke.py draws them (scaled so that the random score keeps
    # the steps finite; non-zero ReZero gains): K1-K3 on the GPU, their
    # plain versions on the CPU; f32 with TF32 off
    from chip_smoke import seeded_state_dict
    from gradtts_tpu_torch.models.tts import GradTTS, synthesize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp = {'ids': dict(n_spks=5), 'vectors': dict(n_spks=-1),
          'encoder': dict(n_spks=5, encoder_speaker=True)}[spk_setup]
    torch.manual_seed(0)
    model = GradTTS(n_vocab=40, n_enc_channels=32, filter_channels=64,
                    filter_channels_dp=16, n_heads=2, n_enc_layers=1,
                    n_feats=80, dec_dim=16, spk_emb_dim=8, **hp).eval()
    model.load_state_dict(seeded_state_dict(model, seed=1), strict=True)
    x = torch.randint(1, 40, (2, 12))
    x_lengths = torch.tensor([12, 7])
    spk = torch.tensor([3, 1]) if hp['n_spks'] > 1 else torch.randn(2, 8)
    noise = torch.randn(2, 64, 80)
    outs = []
    launches = tla.attention_stats.launches
    for dev in (cuda, torch.device('cpu')):
        m = model.to(dev)
        res = synthesize(m, x.to(dev), x_lengths.to(dev), 4, 64,
                         noise=noise.to(dev), spk=spk.to(dev))
        outs.append([o.cpu() for o in res])
    assert tla.attention_stats.launches == launches + 6 * 4
    (g_enc, g_dec, g_attn, g_len, _), (c_enc, c_dec, c_attn, c_len, _) = outs
    assert torch.equal(g_len, c_len) and torch.equal(g_attn, c_attn)
    scale = float(c_dec.abs().max())
    assert float((g_dec - c_dec).abs().max()) <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize('tf32', [False, True], ids=['tf32_off', 'tf32_on'])
def test_mel_on_gpu_matches_cpu(cuda, tf32):
    # rfft (cuFFT against pocketfft) and the float64 filterbank product,
    # which TF32 must not reach: within 1e-4 on the log-mel whatever the
    # flag, tail frames exactly 0, the waveform gradient within 1e-3 of
    # its largest value
    from gradtts_tpu_torch.data.mel import mel_from_padded, mel_spectrogram
    torch.backends.cuda.matmul.allow_tf32 = tf32
    rng = np.random.default_rng(11)
    pcm = torch.tensor(rng.integers(-20000, 20000, (3, 9000)),
                       dtype=torch.int16)
    lengths = torch.tensor([30, 12, 27])
    for y in (pcm, pcm.float() / 32768.0):
        want = mel_from_padded(y, lengths)
        got = mel_from_padded(y.to(cuda), lengths.to(cuda)).cpu()
        assert float((got - want).abs().max()) <= 1e-4
        assert (got[1, 12:] == 0).all()
    wav = pcm.float() / 32768.0
    grads = []
    for dev in (cuda, torch.device('cpu')):
        w = wav.to(dev).requires_grad_(True)
        mel_spectrogram(w).abs().mean().backward()
        grads.append(w.grad.cpu())
    scale = float(grads[1].abs().max())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-3 * scale
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_discriminators_on_gpu_match_cpu(cuda):
    # MPD and MSD at full width, f32 with TF32 off: scores and feature
    # maps within 1e-4 of each one's largest value
    from gradtts_tpu_torch.models.hifigan import (MultiPeriodDiscriminator,
                                                  MultiScaleDiscriminator)
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    y, y_hat = torch.rand(2, 2, 8000) * 1.8 - 0.9
    for disc in (MultiPeriodDiscriminator(), MultiScaleDiscriminator()):
        with torch.no_grad():
            want = disc(y, y_hat)
            got = disc.to(cuda)(y.to(cuda), y_hat.to(cuda))
        for g_list, w_list in zip(got, want):
            g_flat = [g for item in g_list
                      for g in (item if isinstance(item, list) else [item])]
            w_flat = [w for item in w_list
                      for w in (item if isinstance(item, list) else [item])]
            for g, w in zip(g_flat, w_flat):
                assert float((g.cpu() - w).abs().max()) <= \
                    1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_gan_step_on_gpu_matches_cpu(cuda):
    # one GAN step of a narrow V1 generator with the full-width
    # discriminators at segment 8192, TF32 off: in f32 the seven losses
    # within 1e-4 relative and each gradient within 1e-3 of its largest
    # value, the CPU taking the card's leaky-ReLU slopes (an input within
    # rounding of 0 may take the other slope on the other device; each
    # flipped one lies within 1e-4 of its call's largest input); in f64,
    # with no replay, each gradient within 1e-3
    # (chip_smoke.py phase vocoder_train_slice)
    from chip_smoke import (_gan_step_grads, _vocoder_batch,
                            gan_step_on_card_and_cpu, grad_errors)
    from gradtts_tpu_torch.models.hifigan import HiFiGANConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = HiFiGANConfig(upsample_initial_channel=64)
    batch = _vocoder_batch(np.random.default_rng(12), 2)
    cpu = torch.device('cpu')
    g_metrics, c_metrics, f32, replay, _, _ = gan_step_on_card_and_cpu(
        cfg, cuda, batch)
    for k, v in c_metrics.items():
        assert g_metrics[k] == pytest.approx(v, rel=1e-4), k
    assert replay.worst_flip <= 1e-4
    assert max(f32.values()) <= 1e-3
    f64 = grad_errors(_gan_step_grads(cfg, cuda, batch,
                                      dtype=torch.float64)[1],
                      _gan_step_grads(cfg, cpu, batch,
                                      dtype=torch.float64)[1])
    assert max(f64.values()) <= 1e-3
