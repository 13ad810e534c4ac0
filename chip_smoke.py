"""Smoke run of the PyTorch/CUDA port (gradtts_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build    the hand-written kernels from gradtts_tpu_torch/csrc (one nvcc
              per source, all at once) and report nvcc's register report;
  2. kernels  hold every kernel against its plain PyTorch version at each
              shape the U-Net gives it (B 8, 768 frames), in f32 and bf16,
              and time kernel and plain version in bf16;
  3. slice    a full-width ljspeech GradTTS with every weight drawn from a
              seed: 10-step synthesis (B 2, Tx 64, Ty 256, f32) on the GPU
              against the same on the CPU (plain versions);
  4. cli      python -m gradtts_tpu_torch.cli.inference on that checkpoint;
  5. synth    bf16 synthesis at B 8, Tx 128, Ty 768, 10 Euler steps: launch
              counts per synthesis, audio-s/s and the kernels' device share.
Then the card's name and power limit (nvidia-smi), the {"kernels": [...]}
line, and last {"ok": true, "device": {...}}. Any failure exits non-zero
before the last line; so does a machine without a GPU or a directory
without the package.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, 'build', 'chip_smoke')

# NVIDIA's H100 SXM data sheet: HBM bytes/s and dense peak rates
HBM_BPS = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}   # tensor core / CUDA core

B, TX, TY, STEPS = 8, 128, 768, 10          # the bench.py synthesis shape
SR, HOP = 22050, 256
# (F, T, C) of the U-Net levels at Ty 768, with the Blocks (K1) and the
# attentions (K2 + K3) that one U-Net call runs there
LEVELS = [((80, 768, 64), 5, 1), ((40, 384, 128), 4, 1),
          ((20, 192, 256), 8, 2), ((20, 192, 128), 4, 1),
          ((40, 384, 64), 4, 1)]
# max |kernel - plain| <= atol + rtol * |plain|, per dtype. f32: identical
# inputs, f32 sums in other orders over up to 491520 values: ~1e-6
# relative, 1e-4 leaves margin. bf16 outputs: both sides round the same f32
# value, which may straddle a rounding boundary: one or two bf16 ulps.
TOL = {
    'groupnorm_mish': {'float32': 1e-4, 'bfloat16': 2 ** -7},
    'attention_stats': {'float32': 1e-4, 'bfloat16': 1e-4},   # f32 outputs
    'attention_apply': {'float32': 1e-4, 'bfloat16': 2 ** -6},
}
# weights drawn as std gain/sqrt(fan_in): a random score does not pull x_t
# back to mu, so the Euler steps grow x_t - mu ~150-fold, and the linear
# attention is quadratic in its input's scale; these gains keep the U-Net's
# un-normed residual stream finite while the attention still contributes
GAINS = (('to_qkv', 0.05), ('res_conv', 0.3), ('.3.conv', 0.5))
SLICE_TOL = 1e-3   # of max |mel|: GPU vs CPU, f32 with TF32 off (see phase 3)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, dtype_name):
    """(least ms for the work, what bounds it) on the H100's published rates."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else \
        'operations'


# ---- phase 1 ---------------------------------------------------------------


def phase_build():
    from gradtts_tpu_torch.ops import _build
    t0 = time.perf_counter()
    report = _build.build()
    ptxas = {}     # entry function -> 'R registers, S bytes spill stores'
    for r in report.values():
        fn = None
        for ln in r['log'].splitlines():
            if 'Compiling entry function' in ln:
                # _ZN..gn_stats_kernelI13__nv_bfloat16Li64E.. -> gn_stats<bf16,64>
                m = re.search(r'((?:gn|la)_(?:stats|apply))_kernelI'
                              r'(f|13__nv_bfloat16)Li(\d+)E', ln)
                fn = f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},{m[3]}>" \
                    if m else ln.split("'")[1]
            elif fn and 'spill stores' in ln:
                spill = ln.split(',')[1].strip()
            elif fn and 'Used' in ln and 'registers' in ln:
                ptxas[fn] = f"{ln.split('Used')[1].split(',')[0].strip()}, " \
                            f'{spill}'
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'per_source_seconds': {n: r['seconds'] for n, r in report.items()},
          'flags': ' '.join(_build.NVCC_FLAGS), 'ptxas': ptxas})


# ---- phase 2 ---------------------------------------------------------------


def _allclose(got, want, tol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    return float(err.max()), ok


def phase_kernels(device):
    import numpy as np
    import torch
    from gradtts_tpu_torch.ops import groupnorm_mish as gn
    from gradtts_tpu_torch.ops import linear_attention as la

    rng = np.random.default_rng(0)
    H = la.HIDDEN
    stats = {k: {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0,
                 'bytes_ms': 0.0, 'ops_ms': 0.0} for k in TOL}

    def rand(shape, scale=1.0, dtype=torch.float32):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, device=device).to(dtype)

    for (F, T, C), n_blocks, n_attn in LEVELS:
        N = F * T
        lengths = torch.tensor([T] * (B - 2) + [T * 3 // 4, T // 3],
                               device=device)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split('.')[1]
            size = torch.tensor([], dtype=dtype).element_size()
            mask = (torch.arange(T, device=device)[None] < lengths[:, None]
                    ).to(dtype).reshape(B, 1, T, 1)
            x = (rand((B, F, T, C), 2.0, dtype) + 0.5) * mask
            gamma, beta = rand((C,)), rand((C,))
            wq, wk, wv = (rand((C, H), 0.5 / math.sqrt(C), dtype)
                          for _ in range(3))
            w_out, b_out = rand((H, C), 1 / math.sqrt(H)), rand((C,), 0.1)
            g = torch.tensor([0.7], device=device)
            xr = x.view(B, N, C)
            chunk = la.split_chunk(B, N)

            def k1():
                return gn.groupnorm_mish(x, mask, gamma, beta)

            def k1_plain():
                return gn.groupnorm_mish_plain(x, mask, gamma, beta)

            def k2():
                return la.attention_stats(xr, wk, wv, chunk)

            def k2_plain():
                return la.attention_stats_plain(xr, wk, wv, chunk)

            m_p, ctx_p, den_p = la.merge_stats(*k2_plain())
            ctx2, bias = la.fold_context(ctx_p, den_p, w_out, b_out, g, 32)
            ctx2 = ctx2.to(dtype)

            def k3():
                return la.attention_apply(xr, wq, ctx2, bias)

            def k3_plain():
                return la.attention_apply_plain(xr, wq, ctx2, bias)

            got_k1 = k1()
            torch.cuda.synchronize()
            m_k, ctx_k, den_k = la.merge_stats(*k2())
            torch.cuda.synchronize()
            got_k3 = k3()
            torch.cuda.synchronize()
            checks = {
                'groupnorm_mish': [(got_k1, k1_plain())],
                'attention_stats': [(ctx_k / den_k[..., None],
                                     ctx_p / den_p[..., None]), (m_k, m_p)],
                'attention_apply': [(got_k3, k3_plain())],
            }
            line = {'phase': 'kernels', 'shape': [B, F, T, C], 'dtype': dn}
            for name, pairs in checks.items():
                tol = TOL[name][dn]
                errs = [_allclose(a, b, tol) for a, b in pairs]
                err = max(e for e, _ in errs)
                ok = all(o for _, o in errs)
                line[name] = {'max_abs_err': err, 'tol': tol, 'ok': ok}
                stats[name]['max_abs_err'] = max(stats[name]['max_abs_err'],
                                                 err)
                require(ok, f'{name} {dn} {(B, F, T, C)}: max abs err {err} '
                            f'over tolerance {tol}')
            if dtype == torch.bfloat16:      # the main path's dtype: time it
                elems = B * N * C
                work = {
                    'groupnorm_mish': (n_blocks, k1, k1_plain,
                                       2 * elems * size + B * T * size,
                                       13 * elems, 'float32'),
                    'attention_stats': (n_attn, k2, k2_plain,
                                        elems * size + 2 * C * H * size
                                        + B * (H * H + 2 * H) * 4,
                                        B * N * (4 * C * H + 2 * H * 32
                                                 + 2 * H), dn),
                    'attention_apply': (n_attn, k3, k3_plain,
                                        2 * elems * size + C * H * size
                                        + B * H * C * size + C * 4,
                                        B * N * (4 * C * H + C), dn),
                }
                for name, (mult, fn, plain, nbytes, flops, peak) in \
                        work.items():
                    ms, plain_ms = cuda_ms(fn, 20), cuda_ms(plain, 3, 1)
                    b_ms, by = bound(nbytes, flops, peak)
                    line[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=by, per_unet_call=mult)
                    st = stats[name]
                    st['ms'] += mult * ms
                    st['plain_ms'] += mult * plain_ms
                    st['bytes_ms'] += mult * nbytes / HBM_BPS * 1e3
                    st['ops_ms'] += mult * flops / PEAK_FLOPS[peak] * 1e3
            emit(line)
    return stats


# ---- phase 3 ---------------------------------------------------------------


def seeded_state_dict(model, seed):
    """Every entry of the model's state_dict drawn from a numpy seed, in the
    reference torch layout ([out, in, ...] kernels)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith('.g'):            # ReZero gain, zero at init
            v = rng.uniform(0.3, 0.7, shape)
        elif len(shape) == 1:              # biases, norm scales and shifts
            v = rng.standard_normal(shape) * 0.3
        else:
            gain = next((gv for key, gv in GAINS if key in name), 1.0)
            v = rng.standard_normal(shape) * gain / math.sqrt(
                float(np.prod(shape[1:])))
        sd[name] = torch.from_numpy(v.astype(np.float32))
    return sd


def reset_counts():
    from gradtts_tpu_torch.ops import groupnorm_mish as gn
    from gradtts_tpu_torch.ops import linear_attention as la
    for fn in (gn.groupnorm_mish, la.attention_stats, la.attention_apply):
        fn.launches = 0


def read_counts():
    from gradtts_tpu_torch.ops import groupnorm_mish as gn
    from gradtts_tpu_torch.ops import linear_attention as la
    return {'groupnorm_mish': gn.groupnorm_mish.launches,
            'attention_stats': la.attention_stats.launches,
            'attention_apply': la.attention_apply.launches}


EXPECTED_COUNTS = {'groupnorm_mish': 25 * STEPS, 'attention_stats': 6 * STEPS,
                   'attention_apply': 6 * STEPS}


def phase_slice(device):
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import GradTTS, synthesize

    cfg = get_config('ljspeech')
    sd = seeded_state_dict(GradTTS.from_config(cfg), seed=0)
    os.makedirs(WORK, exist_ok=True)
    ckpt = os.path.join(WORK, 'ljspeech_seeded.pt')
    torch.save(sd, ckpt)

    rng = np.random.default_rng(1)
    bsz, t_x, t_y = 2, 64, 256
    x = torch.from_numpy(rng.integers(1, cfg.n_vocab, (bsz, t_x)))
    x_lengths = torch.tensor([t_x, 40])
    x[1, 40:] = 0
    noise = torch.from_numpy(
        rng.standard_normal((bsz, t_y, cfg.data.n_feats)).astype(np.float32))
    results = []
    for dev in (device, torch.device('cpu')):
        model = GradTTS.from_config(cfg)
        model.load_state_dict(torch.load(ckpt, weights_only=True),
                              strict=True)
        model = model.to(dev).eval()
        reset_counts()
        t0 = time.perf_counter()
        res = synthesize(model, x.to(dev), x_lengths.to(dev), STEPS, t_y,
                         temperature=1.5, noise=noise.to(dev))
        res = [t.cpu() for t in res]
        results.append((res, read_counts(), time.perf_counter() - t0))
    (g, counts, g_s), (c, cpu_counts, c_s) = results
    enc_g, dec_g, attn_g, yl_g, _ = g
    enc_c, dec_c, attn_c, yl_c, _ = c
    scale = float(dec_c.abs().max())
    err = float((dec_g - dec_c).abs().max())
    line = {'phase': 'slice', 'params': sum(v.numel() for v in sd.values()),
            'y_lengths': yl_g.tolist(),
            'y_lengths_equal': bool(torch.equal(yl_g, yl_c)),
            'attn_equal': bool(torch.equal(attn_g, attn_c)),
            'encoder_max_abs_err': float((enc_g - enc_c).abs().max()),
            'decoder_max_abs_err': err, 'decoder_max_abs': scale,
            'tol': SLICE_TOL * scale, 'gpu_launches': counts,
            'cpu_launches': cpu_counts, 'gpu_s': g_s, 'cpu_s': c_s}
    emit(line)
    require(line['y_lengths_equal'] and line['attn_equal'],
            'slice: y_lengths or attn differ between GPU and CPU')
    require(bool(torch.isfinite(dec_g).all()) and scale > 0,
            'slice: mel not finite')
    # f32 on both sides with TF32 off; cuDNN and oneDNN pick other conv
    # algorithms and sum orders (~1e-5 relative per U-Net call), and the
    # Euler steps grow the mel and its error alike: 1e-3 of the largest
    # value leaves a wide margin
    require(err <= SLICE_TOL * scale, f'slice: decoder max abs err {err} '
                                      f'over {SLICE_TOL * scale}')
    require(counts == EXPECTED_COUNTS, f'slice: GPU launches {counts}')
    require(not any(cpu_counts.values()), 'slice: the CPU run launched kernels')
    return ckpt


# ---- phase 4 ---------------------------------------------------------------


def phase_cli(ckpt):
    import numpy as np
    texts = os.path.join(WORK, 'texts.txt')
    out = os.path.join(WORK, 'cli_out')
    with open(texts, 'w', encoding='utf-8') as f:
        f.write('The quick brown fox jumps over the lazy dog.\n'
                'Grad-TTS synthesizes a mel-spectrogram from text.\n'
                'It ran on the GPU in 2026.\n')
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'gradtts_tpu_torch.cli.inference', '-f', texts,
         '-c', ckpt, '-o', out, '-t', str(STEPS)], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    print(proc.stdout, end='')
    require(proc.returncode == 0, f'cli exited {proc.returncode}:\n'
                                  f'{proc.stderr[-3000:]}')
    shapes = []
    for i in range(3):
        mel = np.load(os.path.join(out, f'mel_{i}.npy'))
        require(mel.ndim == 2 and mel.shape[1] == 80 and mel.shape[0] > 0
                and np.isfinite(mel).all(), f'cli: mel_{i} is malformed')
        shapes.append(list(mel.shape))
    emit({'phase': 'cli', 'seconds': time.perf_counter() - t0,
          'mels': shapes})


# ---- phase 5 ---------------------------------------------------------------


def phase_synth(device, card):
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import (GradTTS, set_compute_dtype,
                                              synthesize)

    cfg = get_config('ljspeech')
    model = GradTTS.from_config(cfg)
    model.load_state_dict(seeded_state_dict(model, seed=0), strict=True)
    model = set_compute_dtype(model.to(device).eval(), torch.bfloat16)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(1, cfg.n_vocab, (B, TX))).to(device)
    x_lengths = torch.full((B,), TX, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def run():
        res = synthesize(model, x, x_lengths, STEPS, TY, temperature=1.5,
                         generator=gen)
        torch.cuda.synchronize()
        return res

    run()                                           # warm-up
    reset_counts()
    res = run()                                     # the main path's run
    counts = read_counts()
    require(counts == EXPECTED_COUNTS,
            f'synth: launches per synthesis {counts}, expected '
            f'{EXPECTED_COUNTS}')
    require(bool(torch.isfinite(res.decoder_outputs).all()),
            'synth: mel not finite')
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    per_call = statistics.median(times)
    audio_s = B * TY * HOP / SR

    share = _device_share(run, per_call * 1e3)
    emit({'phase': 'synth', 'card': card, 'batch': B, 'tx': TX, 'ty': TY,
          'steps': STEPS,
          'dtype': 'bfloat16', 'seconds_per_call': per_call,
          'seconds_all': times, 'audio_s_per_s': audio_s / per_call,
          'launches_per_synthesis': counts,
          'y_lengths': res.y_lengths.tolist(), **share})
    return counts


def _family(name):
    """Coarse family of a device kernel, by its name."""
    for fam, keys in (('hand kernels', ('gn_stats_kernel', 'gn_apply_kernel',
                                        'la_stats_kernel', 'la_apply_kernel')),
                      ('convolutions', ('xmma', 'implicit_gemm', 'conv',
                                        'cudnn', 'wgrad', 'dgrad')),
                      ('matmuls', ('gemm', 'cutlass', 'sm90_')),
                      ('elementwise', ('elementwise', 'vectorized')),
                      ('reductions', ('reduce',))):
        if any(k in name for k in keys):
            return fam
    return 'other'


def _device_share(run, call_ms):
    """Device time by kernel over one synthesis from torch.profiler, against
    the unprofiled time of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    require(kern, 'synth: the profiler saw no device kernel')
    ms = [e.time_range.elapsed_us() / 1e3 for e in kern]
    busy = sum(ms)
    ours = {name: sum(t for e, t in zip(kern, ms) if name in e.name)
            for name in ('gn_stats_kernel', 'gn_apply_kernel',
                         'la_stats_kernel', 'la_apply_kernel')}
    families, top = {}, {}
    for e, t in zip(kern, ms):
        fam = _family(e.name)
        families[fam] = families.get(fam, 0.0) + t
        top[e.name[:70]] = top.get(e.name[:70], 0.0) + t
    return {'device_busy_ms': busy,
            'device_idle_share': max(0.0, 1 - busy / call_ms),
            'device_kernels': len(kern), 'kernel_ms': ours,
            'kernels_share_of_device_time': sum(ours.values()) / busy,
            'family_ms': families,
            'top_device_ms': dict(sorted(top.items(),
                                         key=lambda kv: -kv[1])[:10])}


# ---- main ------------------------------------------------------------------


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import gradtts_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda')
    t_start = time.perf_counter()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        print('chip_smoke: FAILED: nvidia-smi gave no name and power limit',
              file=sys.stderr)
        return 1
    card = smi.stdout.strip().splitlines()[0]
    try:
        phase_build()
        stats = phase_kernels(device)
        ckpt = phase_slice(device)
        phase_cli(ckpt)
        counts = phase_synth(device, card)
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr, flush=True)
        return 1
    replaces = {
        'groupnorm_mish': 'gradtts_tpu/ops/pallas/groupnorm_mish.py:48',
        'attention_stats': 'gradtts_tpu/ops/pallas/linear_attention.py:58',
        'attention_apply': 'gradtts_tpu/ops/pallas/linear_attention.py:113',
    }
    source = {'groupnorm_mish': 'gradtts_tpu_torch/csrc/groupnorm_mish.cu',
              'attention_stats': 'gradtts_tpu_torch/csrc/linear_attention.cu',
              'attention_apply': 'gradtts_tpu_torch/csrc/linear_attention.cu'}
    kernels = []
    for name, st in stats.items():
        kernels.append({
            'name': name, 'route': 'cuda', 'source': source[name],
            'replaces': replaces[name], 'launches': counts[name],
            'max_abs_err': st['max_abs_err'], 'ms': st['ms'],
            'plain_ms': st['plain_ms'],
            'bound_ms': max(st['bytes_ms'], st['ops_ms']),
            'bound_by': 'bytes' if st['bytes_ms'] >= st['ops_ms']
            else 'operations',
            'library_ms': None,
            'per': 'sum over the launches of one U-Net call, B 8, Ty 768, '
                   'bf16'})
    print(card)
    emit({'kernels': kernels})
    print(f'# total {time.perf_counter() - t_start:.1f} s', file=sys.stderr)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
