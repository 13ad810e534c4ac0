"""Smoke run of the PyTorch/CUDA port (gradtts_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build    the hand-written kernels from gradtts_tpu_torch/csrc (one nvcc
              per source, all at once), report nvcc's register report and
              count the tensor-core instructions (HMMA, HGMMA) of each
              entry function in the built SASS (cuobjdump), requiring some
              in every bf16 K2, K3, K4 and K5 entry and every bf16 K6 and
              K7 entry without weight tangents, and no spills in the K4,
              K5, K6 and K7 ones; K1's longest SASS loop per entry (its
              instructions, MUFU and FP32 counts) and the frame loop of
              the one-warp MAS DP;
  2. kernels  hold every kernel against its plain PyTorch version at each
              shape its path gives it, in f32 and bf16, and time kernel and
              plain version in bf16 (K1's two passes also apart, K4 and K5
              run twice for the same bits): K1-K3 at the synthesis shapes
              (B 8, 768 frames) and the training shapes (B 16, 172-frame
              crops, ragged row tiles) and the likelihood shapes (B 8, 512
              frames), K4 and K5 at the training shapes (K4 also, untimed,
              at every channel count and a ragged N), K6 and K7 (with and
              without weight tangents) at the likelihood shapes and,
              untimed, the training shapes, MAS at [16, 384, 1024] and
              [8, 128, 512] and, untimed, at [4, 512, 2048], a Tx that is
              not a multiple of 32 and a Tx above 512 (the block route);
              untimed, K1-K5 at the tedlium-spk training shapes (B 16,
              128-frame crops), MAS at [16, 192, 384] and K1 at the
              channel blocks of the tp step (B 16, C / 2, 4 groups) and
              of the likelihood cell split likewise (B 8, 512 frames);
     conv3x3  the Block convolution's kernel at every Block width against
              its plain version in float64, primal and tangent; timed at
              the widths of the n-best (B 50, 512 frames) and generate (B
              32, 768 frames) cells against cuDNN's f32 call (TF32 off),
              each timed launch against float64 too; its launches are
              counted on every path below (25 a U-Net evaluation in f32,
              twice that in forward mode, none in bf16);
  3. slice    a full-width ljspeech GradTTS with every weight drawn from a
              seed: 10-step synthesis (B 2, Tx 64, Ty 256, f32) on the GPU
              against the same on the CPU (plain versions);
  4. samplers_slice  the slice model's 10-step stoc Euler (the same draws on
              both devices) and 10-step DPM, GPU against CPU;
  5. speakers_slice  tedlium-spk (675 x 128 speaker table), tedlium (192-d
              speaker vectors) and libri-tts with the encoder-side speaker
              concat, each seeded at full width: 10-step synthesis,
              compute_loss + backward and a 4-step score_batch, GPU
              against CPU at the limits of slice, train_slice and
              likelihood_slice;
  6. vocoder_slice  the HiFi-GAN V1 generator on B 2 x 256 frames: f32 GPU
              against CPU, bf16 against f32 on the GPU;
     mel_slice  the mel front end (mel_from_padded, f32 and int16 wire,
              with lengths; mel_spectrogram and its gradient) on the GPU
              against the CPU at the synthesis (B 8 x 768 frames) and
              training (B 16 x 1024) buckets, with TF32 off and on;
     vocoder_train_slice  one GAN step of HiFi-GAN V1 with MPD and MSD at
              full width (B 2 x 8192 samples), GPU against CPU: losses
              and gradients in f32 (the CPU taking the card's
              leaky-ReLU slopes), gradients in f64;
  7. cli      python -m gradtts_tpu_torch.cli.inference on those
              checkpoints: Euler, --sampler dpm and --stoc with --vocoder
              (wavs read back), and -s 3 on the tedlium-spk model;
  8. synth    bf16 synthesis at B 8, Tx 128, Ty 768, 10 Euler steps: launch
              counts per synthesis, audio-s/s and the kernels' device share;
     profiling  utils.profiling.trace over one such synthesis: the trace
              file is written, not empty, and names K1-K3's kernels;
     dpm8     the same with 8 DPM steps; waveform: 50 Euler steps and the
              vocoder, then the vocoder alone in f32 and bf16 (x real time,
              device ms by family); multispeaker: libri-tts, 10 steps;
  9. train_slice  the slice model: compute_loss + backward (B 2, Tx 64,
              Ty 256, 172-frame crop, f32) on the GPU against the CPU, with
              the same crop offsets, diffusion times and noise;
 10. train    python -m gradtts_tpu_torch.cli.train --preset ljspeech on a
              synthetic 64-utterance corpus (B 16, bf16 compute, f32
              parameters, device mels by the auto rule), a resumed step,
              cli.inference on its checkpoint; then the train step timed
              in-process: launches per step, steps/s, audio-s trained per
              second and the device share;
     device_mel  the loader over that corpus with host mels and device
              mels (f32 and int16 wire): batches equal, and the sustained
              feed rate beside the train step's utterances/s;
     vocoder_train  python -m gradtts_tpu_torch.cli.train_vocoder (V1,
              B 16, segment 8192) on a synthetic 22.05 kHz corpus, a
              resumed step, cli.inference --vocoder on its checkpoint; then
              the GAN step timed in-process in f32, TF32 off and on;
     train_spk  the same for --preset tedlium-spk on a synthetic 16 kHz
              speaker corpus of Tx 192 x Ty 344 utterances (128-frame
              crops), utterances/s as well;
 11. likelihood_slice  the slice model: score_batch (likelihood of real
              mels under text hypotheses, 4-step Euler, Hutchinson jvp;
              B 2, Tx 64, Ty 256, f32) on the GPU against the CPU, with the
              same probe;
 12. nbest_cli  python -m gradtts_tpu_torch.cli.nbest score on a synthetic
              n-best list over synthetic wavs, then compile and rescore;
              once with --preset ljspeech, once with the default preset
              (tedlium-spk) on a speaker filelist;
 13. likelihood  score_batch at B 8, Tx 128, Ty 512, 10-step Euler, bf16
              compute: hypotheses/s, launches per call, the device share;
 14. adaptive  one adaptive Dormand-Prince score_batch (B 2, Ty 256).
     Phases 12, 14, 15, 19 and 20 (untimed, and light on the host) run
     while phase ddp's subprocesses work, in that order.
 15. checkpoint_slice  the seeded ljspeech checkpoint exported to .npz
              (utils.io, no tensorstore on the card's machine), and
              cli.inference -c x.npz against -c x.pt: the same mels, bit
              for bit (cuDNN's deterministic algorithms for the two runs);
 16. remat    train.remat_estimator at the train cell's shape: losses and
              every gradient with remat against without, then the step
              both ways (peak memory, wall and device time, launches), and
              cli.train --set train.remat_estimator=True --no-previews;
 17. previews  the trainer's synthesis_preview (4 items of a corpus of
              short texts, 50 Euler steps, f32) on the GPU, the first
              against the CPU with the same noise;
 18. generate  python -m gradtts_tpu_torch.cli.generate on a synthetic
              tedlium split (the first 20 texts of its test filelist, wavs
              of 1.5-10 s, 192-d speaker vectors, B 8: a tail of 4) with
              the seeded V1 vocoder, s a batch and audio-s/s; then without
              the vocoder, the first row of its first batch against the CPU
              with the same noise;
 19. inference_zero  python -m gradtts_tpu_torch.cli.inference_zero
              --spk-emb with the vocoder (the wavs), then its mels against
              synthesize called with the same vector, bit for bit;
 20. playground  python -m gradtts_tpu_torch.cli.playground: 3 utterances
              of the train corpus, 10 Euler steps, 3 probes each.
     ddp      data-parallel training of the train cell: torchrun
              --nproc-per-node 1 cli.train --mesh-data 1 (NCCL) against
              the train phase's plain run; the DDP step in this process
              (one NCCL rank) against the plain step, both timed; two
              ranks on the one card over gloo, a step of the global B 16
              against this process's (bf16 losses; f32 losses, gradients
              and parameters), the ranks' parameters bit-equal;
     tp       in the same two rank processes, after their DDP step, the
              train cell's step split over a data 1 x model 2 mesh
              (--mesh-model 2's path): bf16 and f32 against this
              process's step on the same batch, the replicated parameters
              bit-equal, the blocks the one-process parameters' (f32),
              the elements, peak memory, wall time and launches a rank;
     tp_likelihood  in the same two rank processes, after tp: the
              likelihood cell's score_batch (B 8, Tx 128, Ty 512, 2 Euler
              steps, bf16 and f32) on a data 1 x model 2 mesh (the model
              split, forward mode through the split layers) and on a data
              2 x model 1 mesh (B 4 a rank), the probe drawn at the global
              shape, against this process's score on the global batch;
              the model ranks against each other; phase adaptive's call
              on the data 2 mesh (one row a rank): its nfe, converged and
              scores; launches, wall s and peak memory a rank;
     ddp_generate  cli.generate --mesh-data 2 (two ranks on the card over
              gloo) against the generate phase's --mesh-data 1 mels.
 21. evaluate  python -m gradtts_tpu_torch.cli.evaluate on the seeded
              ljspeech checkpoint and V1 vocoder over an 8-utterance test
              split (ljspeech test texts, 22.05 kHz wavs of 1.5-10 s), 50
              Euler steps, f32: metrics finite, the MEAN: line the file's,
              the shortest utterance against the CPU with the same
              noise (mel, the vocoder on one mel, MCD, GPE/VDE/FFE,
              voicing flips counted; the waveforms' difference reported),
              seconds of synthesis, vocoder and host DSP;
 22. evaluate_mcd  python -m gradtts_tpu_torch.cli.evaluate_mcd --nj 2 as
              a subprocess on those wavs against the split's: 8 finite
              rows;
 23. quality_gate  the trained-weights gate of
              tests/test_e2e_quality_gate.py with the port on the card: one
              train step of its tiny model (dec_dim 16, 32 mels) GPU
              against CPU, 800 train steps on the sine-chunk corpus, then
              synthesis, a tiny HiFi-GAN and the eval metrics, trained
              against untrained at the JAX gate's margins; DPM-8/10 and
              Euler-10/50 against a 400-step Euler truth on the trained
              weights, under cuDNN's deterministic algorithms.
Each timed path (synth, dpm8, waveform, multispeaker, train,
vocoder_train, train_spk, likelihood) and each path of phases 15-23, ddp,
tp, tp_likelihood and ddp_generate sets the launch counts to 0 just before
its main run and reads them just after (the GAN step launches no hand
kernel; a rank of ddp, tp, tp_likelihood or ddp_generate counts its own);
phases 15-21 run their CLIs in this process, so that their launches are
counted. Wall times are the median of
utils.profiling.time_jitted, audio-s/s its Throughput, and the device
share a utils.profiling.trace capture. Then each phase's
seconds ({"phase_seconds": {...}}), the total seconds, the card's name
and power limit (nvidia-smi), the {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero before the last line; so does a machine
without a GPU or a directory without the package.
"""

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import re
import concurrent.futures
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
# the training shapes: B 16, 172-frame crops (config.out_size); F*T of 3440
# and 860 leave ragged 32- and 64-row tiles in the attention kernels
TRAIN_B = 16
TRAIN_LEVELS = [((80, 172, 64), 5, 1), ((40, 86, 128), 4, 1),
                ((20, 43, 256), 8, 2), ((20, 43, 128), 4, 1),
                ((40, 86, 64), 4, 1)]
MAS_SHAPE = (16, 384, 1024)      # [B, Tx, Ty]: the 384-token, 1024-frame buckets
# K1 on the channel blocks of the tp step (model 2): the first three U-Net
# levels' blocks, half the channels in half the 8 groups
TP_MODEL = 2
TP_BLOCK_LEVELS = ((80, 172, 32), (40, 86, 64), (20, 43, 128))
# the tedlium-spk training shapes (16 kHz): B 16, 128-frame crops
# (fix_len_compatibility(2 * 16000 // 256)), MAS over the 192-token,
# 384-frame bucket of ~5.5 s utterances (bench_suite.py:143); checked, not
# timed
SPK_LEVELS = [((80, 128, 64), 5, 1), ((40, 64, 128), 4, 1),
              ((20, 32, 256), 8, 2), ((20, 32, 128), 4, 1),
              ((40, 64, 64), 4, 1)]
SPK_MAS_SHAPE = (16, 192, 384)
# the likelihood shapes: score_batch at B 8, Tx 128, Ty 512, 10 Euler steps
# (bench_suite.py:187-208); every drift evaluation runs the U-Net forward
# and its jvp: K1-K3 for the primal, K6 + K7 for the attention's tangent
LIK_B, LIK_TX, LIK_TY, LIK_STEPS = 8, 128, 512, 10
LIK_LEVELS = [((80, 512, 64), 5, 1), ((40, 256, 128), 4, 1),
              ((20, 128, 256), 8, 2), ((20, 128, 128), 4, 1),
              ((40, 256, 64), 4, 1)]
LIK_MAS_SHAPE = (LIK_B, LIK_TX, LIK_TY)
# K1 on the channel blocks of the likelihood cell split over 'model'
# (tp_likelihood): the first three levels' blocks at B 8, Ty 512
LIK_BLOCK_LEVELS = ((80, 512, 32), (40, 256, 64), (20, 128, 128))
# MAS checked untimed: the largest buckets (512 tokens, 2048 frames), a Tx
# that is not a multiple of 32 (and a Ty not one of 4), and a Tx above 512,
# which takes the block-wide route
MAS_UNTIMED = ((4, 512, 2048), (3, 200, 701), (2, 600, 1400))
# Tolerances of |kernel - plain|, per dtype. Per-row outputs, elementwise
# |d| <= tol + tol * |plain|: f32 sums in other orders over up to 491520
# values, ~1e-6 relative, 1e-4 leaves margin; bf16 outputs round the same
# f32 value on both sides, which may straddle a rounding boundary: one or
# two bf16 ulps. The backward's batch-wide sums (dA, dWq, db, dg, dWk, dWv,
# all f32), |d| <= tol * max |plain|: sums of up to 220160 rows in other
# orders (f32), and the rare bf16 rounding of an intermediate that lands on
# the other side of a boundary (bf16). K4's dA in bf16 has no rounded
# intermediate (q stays f32, as bf16 hi + lo parts; dy is exact in bf16):
# TOL_K4_DA. MAS is bit-exact.
TOL = {
    'groupnorm_mish': {'float32': 1e-4, 'bfloat16': 2 ** -7},
    'attention_stats': {'float32': 1e-4, 'bfloat16': 1e-4},   # f32 outputs
    'attention_apply': {'float32': 1e-4, 'bfloat16': 2 ** -6},
    'attention_bwd_sweep1': {'float32': 1e-4, 'bfloat16': 2 ** -7},
    'attention_bwd_sweep2': {'float32': 1e-4, 'bfloat16': 2 ** -6},
    # K6: the f32 statistics as K2's (primal elementwise, the tangents'
    # batch-wide sums of max); K7: y and dy as K3's output
    'attention_jvp_stats': {'float32': 1e-4, 'bfloat16': 1e-4},
    'attention_jvp_apply': {'float32': 1e-4, 'bfloat16': 2 ** -6},
    'maximum_path': {'float32': 0.0},
}
TOL_K4_DA = {'float32': 1e-4, 'bfloat16': 2 ** -12}
KERNELS = list(TOL)
# weights drawn as std gain/sqrt(fan_in): a random score does not pull x_t
# back to mu, so the Euler steps grow x_t - mu ~150-fold, and the linear
# attention is quadratic in its input's scale; these gains keep the U-Net's
# un-normed residual stream finite while the attention still contributes
GAINS = (('to_qkv', 0.05), ('res_conv', 0.3), ('.3.conv', 0.5))
SLICE_TOL = 1e-3   # of max |mel|: GPU vs CPU, f32 with TF32 off (phase slice)


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


def device_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, without
    the host's share: the calls are queued behind a ~10 ms device-side
    sleep, so the device never waits for the host between them (where
    ``cuda_ms`` times a small kernel's Python wrapper as well)."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)           # cycles, ~10 ms at 1.98 GHz
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


def median_call(run, iters, warmup=1):
    """``utils.profiling.time_jitted`` of ``run`` (``warmup`` calls, then
    ``iters`` timed ones, each ended when the card has finished its
    output): (the median seconds a call, its median/mean/min figures)."""
    from gradtts_tpu_torch.utils.profiling import time_jitted
    stats = time_jitted(run, iters=iters, warmup=warmup)
    del stats['last_output']
    return stats['median_s'], stats


def throughput(frames, items, seconds, sr=SR, hop=HOP):
    """``utils.profiling.Throughput`` of ``frames`` mel frames and ``items``
    utterances in ``seconds`` (a median call)."""
    from gradtts_tpu_torch.utils.profiling import Throughput
    tp = Throughput(sample_rate=sr, hop_length=hop)
    tp.add(frames, items)
    tp.elapsed = seconds
    return tp


# ---- build ------------------------------------------------------------------


def _entry_name(mangled):
    """_ZN..gn_stats_kernelI13__nv_bfloat16Li64E.. -> gn_stats<bf16,64>,
    ..la_jvp_stats_kernelIfLi64ELb1E.. -> la_jvp_stats<f32,64,dW>; the
    kernels templated on C alone are bf16 (K5's tensor-core kernels):
    ..la_bwd2_dx_kernelILi64E.. -> la_bwd2_dx<bf16,64>."""
    m = re.search(r'((?:gn|la)_[a-z0-9_]+?)_kernelI'
                  r'(f|13__nv_bfloat16)?Li(\d+)E(?:Lb([01])E)?', mangled)
    if m:
        return (f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},{m[3]}"
                f"{',dW' if m[4] == '1' else ''}>")
    plain = re.search(r'(mas(?:_dp|_path)?)_kernel(?:ILi(\d+)E)?', mangled)
    if plain:
        return f'{plain[1]}<{plain[2]}>' if plain[2] else plain[1]
    return mangled


@functools.lru_cache(maxsize=None)
def _sass(path):
    """{entry function: [(address, opcode line)]} of a built library's SASS,
    by the cuobjdump of the toolkit that built the port's kernels; read
    once a library (callers do not change it)."""
    from gradtts_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    proc = subprocess.run([tool, '-sass', path], capture_output=True,
                          text=True, timeout=300)
    require(proc.returncode == 0, f'cuobjdump -sass {path} exited '
                                  f'{proc.returncode}: {proc.stderr[-2000:]}')
    entries, fn = {}, None
    for ln in proc.stdout.splitlines():
        if 'Function :' in ln:
            fn = _entry_name(ln.split('Function :')[1].strip())
            entries[fn] = []
        elif fn:
            m = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?);', ln)
            if m:
                entries[fn].append((int(m[1], 16), m[2]))
    return entries


def _tensor_core_counts(library):
    """{entry function: HMMA + HGMMA instructions} of a built library."""
    from gradtts_tpu_torch.ops import _build
    return {fn: sum(bool(re.search(r'\bHG?MMA\.', op)) for _, op in ins)
            for fn, ins in _sass(_build.library_path(library)).items()}


def sass_loops(path):
    """{entry function: its longest loop} of the library at ``path``: the
    instructions from a backward branch's target to the branch, with
    their MUFU (special-function unit) and FP32 (FADD, FMUL, FFMA)
    counts; None where an entry has no loop. For K1's row loops."""
    out = {}
    for fn, ins in _sass(path).items():
        best = None
        for addr, op in ins:
            m = re.search(r'\bBRA\b.*?0x([0-9a-f]+)', op)
            if m and int(m[1], 16) < addr:
                body = [o for a, o in ins if int(m[1], 16) <= a <= addr]
                if best is None or len(body) > best['instructions']:
                    best = {'instructions': len(body),
                            'mufu': sum('MUFU' in o for o in body),
                            'fp32': sum(bool(re.search(
                                r'\bF(ADD|MUL|FMA)\b', o)) for o in body)}
        out[fn] = best
    return out


def sass_loop_with(path, entry, opcode):
    """The innermost loop of ``entry`` in the library at ``path`` that holds
    an instruction matching ``opcode``: its instruction count, or None."""
    ins = _sass(path).get(entry, [])
    best = None
    for addr, op in ins:
        m = re.search(r'\bBRA\b.*?0x([0-9a-f]+)', op)
        if m and int(m[1], 16) < addr:
            body = [o for a, o in ins if int(m[1], 16) <= a <= addr]
            if any(re.search(opcode, o) for o in body) and (
                    best is None or len(body) < best):
                best = len(body)
    return best


def phase_build():
    from gradtts_tpu_torch.ops import _build
    from gradtts_tpu_torch.ops import linear_attention as la
    t0 = time.perf_counter()
    report = _build.build()
    # the SASS of every library, read by cuobjdump at once
    names = list(_build.SIGNATURES)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for done in [pool.submit(_sass, _build.library_path(n))
                     for n in names]:
            done.result()
    ptxas = {}     # entry function -> 'R registers, S bytes spill stores'
    for r in report.values():
        fn = None
        for ln in r['log'].splitlines():
            if 'Compiling entry function' in ln:
                fn = _entry_name(ln.split("'")[1])
            elif fn and 'spill stores' in ln:
                spill = ln.split(',')[1].strip()
            elif fn and 'Used' in ln and 'registers' in ln:
                ptxas[fn] = f"{ln.split('Used')[1].split(',')[0].strip()}, " \
                            f'{spill}'
    mma = {**_tensor_core_counts('linear_attention'),
           **_tensor_core_counts('linear_attention_bwd'),
           **_tensor_core_counts('linear_attention_jvp')}
    # K2, K3, K5 and the variants of K6 and K7 without weight tangents (the
    # Hutchinson probe's) run their bf16 products on the tensor cores
    tc = [f'{k}<bf16,{c}>' for k in ('la_stats', 'la_apply', 'la_bwd1_tc',
                                      'la_bwd2_dx', 'la_bwd2_dw',
                                      'la_jvp_stats', 'la_jvp_apply')
          for c in la._CHANNELS]
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'per_source_seconds': {n: r['seconds'] for n, r in report.items()},
          'flags': ' '.join(_build.NVCC_FLAGS), 'ptxas': ptxas,
          'tensor_core_instructions': mma,
          'tensor_core_ptxas': {fn: ptxas.get(fn) for fn in tc},
          'groupnorm_mish_loops': sass_loops(
              _build.library_path('groupnorm_mish')),
          'mas_ptxas': {fn: r for fn, r in ptxas.items()
                        if fn.startswith('mas')},
          'mas_dp_frame_loop_instructions': {
              k: sass_loop_with(_build.library_path('mas'), f'mas_dp<{k}>',
                                r'SHFL\.UP') for k in (4, 8, 12, 16)}})
    for fn in tc:
        require(mma.get(fn, 0) > 0, f'build: {fn} has no HMMA or HGMMA '
                                    f'instruction ({mma.get(fn)})')
        # (nvcc reports only what this call built)
        if fn.startswith(('la_jvp', 'la_bwd1', 'la_bwd2')) and fn in ptxas:
            require(ptxas[fn].endswith(' 0 bytes spill stores'),
                    f'build: {fn} spills ({ptxas[fn]})')


# ---- kernels ----------------------------------------------------------------


def _err(got, want, tol, rel_to_max):
    """(max |got - want|, within tolerance). Elementwise: |d| <= tol +
    tol * |want|; rel_to_max (sums over many rows, where single values
    cancel): |d| <= tol * max |want|."""
    want = want.float()
    err = (got.float() - want).abs()
    if rel_to_max:
        return float(err.max()), bool(err.max() <= tol * want.abs().max())
    return float(err.max()), bool((err <= tol + tol * want.abs()).all())


def _stat():
    return {'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0, 'bytes_ms': 0.0,
            'ops_ms': 0.0}


def _timed(st, mult, fn, plain, nbytes, flops, peak, line):
    """Times kernel and plain version once each; adds mult launches' worth
    to the per-call sums in ``st``; returns the line's entry."""
    ms, plain_ms, dev_ms = cuda_ms(fn, 20), cuda_ms(plain, 3, 1), device_ms(fn)
    b_ms, by = bound(nbytes, flops, peak)
    st['ms'] += mult * ms
    st['device_ms'] += mult * dev_ms
    st['plain_ms'] += mult * plain_ms
    st['bytes_ms'] += mult * nbytes / HBM_BPS * 1e3
    st['ops_ms'] += mult * flops / PEAK_FLOPS[peak] * 1e3
    line.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, per_call=mult)


def _per_den(blocks, den):
    """Head blocks [..., heads, dh, dh] over den [..., H] of their rows."""
    return blocks / den.reshape(blocks.shape[:-1])[..., None]


def _jvp_stats_pairs(got, want):
    """K6's outputs, merged: m per split and ctx / den elementwise (as K2's);
    the tangents dctx / den and dden / den against their largest value."""
    import gradtts_tpu_torch.ops.linear_attention as la

    def normed(out):
        ctx, den, dctx, dden = la.merge_jvp_stats(*out)
        return _per_den(ctx, den), _per_den(dctx, den), dden / den

    (c_k, dc_k, dd_k), (c_p, dc_p, dd_p) = normed(got), normed(want)
    return [(got[0], want[0], False), (c_k, c_p, False), (dc_k, dc_p, True),
            (dd_k, dd_p, True)]


def phase_kernels(device):
    """Every kernel against its plain version at the shapes its path gives
    it, f32 and bf16; times in bf16. K1-K3 at the synthesis shapes (B 8,
    Ty 768), the training shapes (B 16, 172-frame crops, whose F*T leave
    ragged row tiles) and the likelihood shapes (B 8, Ty 512); K4, K5 at
    the training shapes; K6 and K7 at the likelihood shapes, timed in the
    variant without weight tangents that the Hutchinson jvp runs and
    checked in both, and checked (untimed) at the training shapes, whose
    ragged 64-row tiles the likelihood shapes never leave; MAS at
    [16, 384, 1024] and [8, 128, 512]. Returns
    {kernel: {'max_abs_err', path: per-call sums}}."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.ops import groupnorm_mish as gn
    from gradtts_tpu_torch.ops import linear_attention as la

    rng = np.random.default_rng(0)
    H = la.HIDDEN
    stats = {k: {'max_abs_err': 0.0} for k in KERNELS}

    def rand(shape, scale=1.0, dtype=torch.float32):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32, device=device).to(dtype)

    for path, bsz, levels in (('synth', B, LEVELS),
                              ('train', TRAIN_B, TRAIN_LEVELS),
                              ('likelihood', LIK_B, LIK_LEVELS),
                              ('train_spk', TRAIN_B, SPK_LEVELS)):
        for (F, T, C), n_blocks, n_attn in levels:
            N = F * T
            lengths = torch.tensor([T] * (bsz - 2) + [T * 3 // 4, T // 3],
                                   device=device)
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split('.')[1]
                size = torch.tensor([], dtype=dtype).element_size()
                mask = (torch.arange(T, device=device)[None]
                        < lengths[:, None]).to(dtype).reshape(bsz, 1, T, 1)
                x = (rand((bsz, F, T, C), 2.0, dtype) + 0.5) * mask
                gamma, beta = rand((C,)), rand((C,))
                wq, wk, wv = (rand((C, H), 0.5 / math.sqrt(C), dtype)
                              for _ in range(3))
                w_out, b_out = rand((H, C), 1 / math.sqrt(H)), rand((C,), 0.1)
                g = torch.tensor([0.7], device=device)
                xr = x.view(bsz, N, C)
                chunk = la.split_chunk(bsz, N)       # K2, K3, K6, K7
                m_p, ctx_p, den_p = la.merge_stats(
                    *la.attention_stats_plain(xr, wk, wv, chunk))
                ctx2, bias = la.fold_context(ctx_p, den_p, w_out, b_out, g)
                ctx2 = ctx2.to(dtype)
                fns = {
                    'groupnorm_mish': (
                        lambda: gn._launch(x, mask, gamma, beta, 8, 1e-5),
                        lambda: gn.groupnorm_mish_plain(x, mask, gamma,
                                                        beta)),
                    'attention_stats': (
                        lambda: la.attention_stats(xr, wk, wv, chunk),
                        lambda: la.attention_stats_plain(xr, wk, wv,
                                                         chunk)),
                    'attention_apply': (
                        lambda: la.attention_apply(xr, wq, ctx2, bias),
                        lambda: la.attention_apply_plain(xr, wq, ctx2,
                                                         bias)),
                }
                elems = bsz * N * C
                work = {   # (launches per U-Net call, bytes, flops, peak)
                    'groupnorm_mish': (n_blocks, 2 * elems * size
                                       + bsz * T * size, 13 * elems,
                                       'float32'),
                    'attention_stats': (n_attn, elems * size
                                        + 2 * C * H * size
                                        + bsz * (H * 32 + 2 * H) * 4,
                                        bsz * N * (4 * C * H + 2 * H * 32
                                                   + 2 * H), dn),
                    'attention_apply': (n_attn, 2 * elems * size
                                        + C * H * size + bsz * H * C * size
                                        + C * 4, bsz * N * (4 * C * H + C),
                                        dn),
                }

                def stats_pairs(out):
                    # K2 writes only the head-diagonal blocks
                    require(tuple(out[1].shape[2:]) == (H // 32, 32, 32),
                            f'attention_stats: ctx {tuple(out[1].shape)}')
                    m_k, ctx_k, den_k = la.merge_stats(*out)
                    return [(_per_den(ctx_k, den_k), _per_den(ctx_p, den_p),
                             False), (m_k, m_p, False)]

                pairs = {
                    'groupnorm_mish': lambda got, want: [(got, want, False)],
                    'attention_stats': lambda got, want: stats_pairs(got),
                    'attention_apply': lambda got, want: [(got, want, False)],
                }
                if path in ('train', 'train_spk'):
                    dy = rand((bsz, N, C), 1.0, dtype)
                    a_pre = la.fold_context(ctx_p, den_p, w_out, b_out,
                                            torch.ones(1, device=device))[0]
                    a_full_t = (a_pre * 0.7).transpose(1, 2).to(dtype) \
                        .contiguous()
                    a_pre = a_pre.to(dtype).contiguous()
                    dctx = (rand((bsz, H, H), 0.01)
                            * la.head_blockdiag(H, 32, device)).to(dtype)
                    dden = rand((bsz, H), 1e-3)
                    fns['attention_bwd_sweep1'] = (
                        lambda: la.attention_bwd_sweep1(xr, dy, wq, a_full_t,
                                                        a_pre, b_out),
                        lambda: la.attention_bwd_sweep1_plain(
                            xr, dy, wq, a_full_t, a_pre, b_out))
                    fns['attention_bwd_sweep2'] = (
                        lambda: la.attention_bwd_sweep2(
                            xr, dy, wq, wk, wv, m_p, a_full_t, dctx, dden),
                        lambda: la.attention_bwd_sweep2_plain(
                            xr, dy, wq, wk, wv, m_p, a_full_t, dctx, dden))
                    pairs['attention_bwd_sweep1'] = (
                        lambda got, want: _sweep1_pairs(got, want, dn))
                    pairs['attention_bwd_sweep2'] = lambda got, want: [
                        (got[0], want[0], False)] + [
                        (a, b, True) for a, b in zip(got[1:], want[1:])]
                    work['attention_bwd_sweep1'] = (
                        n_attn, 2 * elems * size + C * H * size
                        + 2 * bsz * H * C * size + C * 4 + bsz * H * C * 4
                        + C * H * 4 + 2 * C * 4,
                        bsz * N * 10 * C * H, dn)
                    work['attention_bwd_sweep2'] = (
                        n_attn, 3 * elems * size + 3 * C * H * size
                        + bsz * (C * H + H * H) * size + 2 * bsz * H * 4
                        + 2 * C * H * 4,
                        bsz * N * (16 * C * H + 4 * H * 32), dn)
                variants, untimed = {}, ()
                if path in ('likelihood', 'train'):
                    dx = rand((bsz, N, C), 1.0, dtype)
                    dwq, dwk, dwv = (rand((C, H), 0.05, dtype)
                                     for _ in range(3))
                    a, da, abias, adbias = la.fold_context_jvp(
                        *la.merge_jvp_stats(*la.attention_jvp_stats_plain(
                            xr, dx, wk, wv, None, None, chunk)),
                        w_out, b_out, g, None, None, None)
                    a, da = a.to(dtype), da.to(dtype)
                    fns['attention_jvp_stats'] = (
                        lambda: la.attention_jvp_stats(xr, dx, wk, wv, None,
                                                       None, chunk),
                        lambda: la.attention_jvp_stats_plain(
                            xr, dx, wk, wv, None, None, chunk))
                    fns['attention_jvp_apply'] = (
                        lambda: la.attention_jvp_apply(xr, dx, wq, None, a,
                                                       da, abias, adbias),
                        lambda: la.attention_jvp_apply_plain(
                            xr, dx, wq, None, a, da, abias, adbias))
                    # the variants with weight tangents: checked, not on
                    # the path
                    variants = {
                        'attention_jvp_stats': (
                            lambda: la.attention_jvp_stats(
                                xr, dx, wk, wv, dwk, dwv, chunk),
                            lambda: la.attention_jvp_stats_plain(
                                xr, dx, wk, wv, dwk, dwv, chunk)),
                        'attention_jvp_apply': (
                            lambda: la.attention_jvp_apply(
                                xr, dx, wq, dwq, a, da, abias, adbias),
                            lambda: la.attention_jvp_apply_plain(
                                xr, dx, wq, dwq, a, da, abias, adbias))}
                    if path == 'train':
                        # the ragged 64-row tiles of the training crops,
                        # which the likelihood shapes never leave: checked,
                        # not timed (the training path launches neither)
                        untimed = ('attention_jvp_stats',
                                   'attention_jvp_apply')
                    pairs['attention_jvp_stats'] = _jvp_stats_pairs
                    pairs['attention_jvp_apply'] = lambda got, want: [
                        (a_, b_, False) for a_, b_ in zip(got, want)]
                    # per split: m, den, dden and the blocks of ctx, dctx
                    outs = bsz * -(-N // chunk) * (3 * H + 2 * H * 32) * 4
                    work['attention_jvp_stats'] = (
                        n_attn, 2 * elems * size + 2 * C * H * size + outs,
                        bsz * N * (8 * C * H + 6 * H * 32 + 2 * H), dn)
                    work['attention_jvp_apply'] = (
                        n_attn, 4 * elems * size + C * H * size
                        + 2 * bsz * H * C * size + 2 * C * 4,
                        bsz * N * (10 * C * H + 4 * C), dn)
                line = {'phase': 'kernels', 'path': path,
                        'shape': [bsz, F, T, C], 'dtype': dn}
                for name, (fn, plain) in fns.items():
                    got = fn()
                    torch.cuda.synchronize()
                    tol = TOL[name][dn]
                    errs = [_err(a, b, *((r, True) if isinstance(r, float)
                                         else (tol, r)))
                            for a, b, r in pairs[name](got, plain())]
                    err = max(e for e, _ in errs)
                    ok = all(o for _, o in errs)
                    line[name] = {'max_abs_err': err, 'tol': tol, 'ok': ok}
                    if name == 'attention_bwd_sweep1':
                        line[name]['dA_tol'] = TOL_K4_DA[dn]
                    st = stats[name]
                    st['max_abs_err'] = max(st['max_abs_err'], err)
                    require(ok, f'{name} {dn} {(bsz, F, T, C)}: max abs err '
                                f'{err} over tolerance {tol}')
                    if name in ('attention_bwd_sweep1',
                                'attention_bwd_sweep2'):
                        # per-split partials summed in a fixed order, no
                        # atomics: a second run gives the same bits
                        again = fn()
                        torch.cuda.synchronize()
                        same = all(torch.equal(a_, b_)
                                   for a_, b_ in zip(got, again))
                        line[name]['bitwise_repeatable'] = same
                        require(same, f'{name} {dn} {(bsz, F, T, C)}: two '
                                      'runs differ')
                    if dtype == torch.bfloat16 and name not in untimed \
                            and path != 'train_spk':
                        # the main paths' dtype
                        mult, nbytes, flops, peak = work[name]
                        _timed(st.setdefault(path, _stat()), mult, fn, plain,
                               nbytes, flops, peak, line[name])
                        if name == 'groupnorm_mish':
                            line[name].update(_gn_passes(x, mask, gamma,
                                                         beta))
                    if name in variants:
                        vfn, vplain = variants[name]
                        got = vfn()
                        torch.cuda.synchronize()
                        errs = [_err(a_, b_, tol, r) for a_, b_, r
                                in pairs[name](got, vplain())]
                        verr = max(e for e, _ in errs)
                        line[name]['weight_tangents'] = {
                            'max_abs_err': verr,
                            'ok': all(o for _, o in errs)}
                        st['max_abs_err'] = max(st['max_abs_err'], verr)
                        require(line[name]['weight_tangents']['ok'],
                                f'{name} with weight tangents {dn} '
                                f'{(bsz, F, T, C)}: max abs err {verr} over '
                                f'tolerance {tol}')
                if path == 'likelihood':
                    # K7's y is K3's output for the same A: a free check
                    y_k7 = la.attention_jvp_apply(xr, dx, wq, None, a, da,
                                                  abias, adbias)[0]
                    y_k3 = la.attention_apply(xr, wq, a, abias)
                    torch.cuda.synchronize()
                    diff = float((y_k7.float() - y_k3.float()).abs().max())
                    line['attention_jvp_apply']['y_vs_k3_max_abs'] = diff
                    require(_err(y_k7, y_k3, TOL['attention_apply'][dn],
                                 False)[1],
                            f'K7 y and K3 output differ by {diff} {dn} '
                            f'{(bsz, F, T, C)}')
                emit(line)
    _kernel_k4_channels(device, rng, stats['attention_bwd_sweep1'])
    _kernel_k1_blocks(device, rng, stats['groupnorm_mish'])
    _kernel_mas(device, rng, stats['maximum_path'], 'train', MAS_SHAPE)
    _kernel_mas(device, rng, stats['maximum_path'], 'likelihood',
                LIK_MAS_SHAPE)
    for shape in MAS_UNTIMED + (SPK_MAS_SHAPE,):
        _kernel_mas(device, rng, stats['maximum_path'], None, shape)
    return stats


def _kernel_k1_blocks(device, rng, st):
    """K1 against its plain version at the channel blocks that the Blocks
    give it on a 'model' axis of TP_MODEL, 8 / TP_MODEL groups, f32 and
    bf16, untimed: the tp step's (B 16, TP_BLOCK_LEVELS) and the
    likelihood cell's (B 8, LIK_BLOCK_LEVELS), the last two items of each
    batch 3/4 and 1/3 long."""
    for path, bsz, levels, frames in (
            ('tp', TRAIN_B, TP_BLOCK_LEVELS, 172),
            ('tp_likelihood', LIK_B, LIK_BLOCK_LEVELS, LIK_TY)):
        _k1_blocks(device, rng, st, path, bsz, levels, frames)


def _k1_blocks(device, rng, st, path, bsz, levels, frames):
    import torch
    from gradtts_tpu_torch.ops import groupnorm_mish as gn
    groups = 8 // TP_MODEL
    lengths = torch.tensor([frames] * (bsz - 2)
                           + [3 * frames // 4, frames // 3], device=device)
    line = {'phase': 'kernels', 'path': path, 'groups': groups}
    for F, T, C in levels:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split('.')[1]
            mask = (torch.arange(T, device=device)[None]
                    < (lengths[:, None] * T + frames - 1) // frames).to(
                dtype).reshape(bsz, 1, T, 1)
            x = ((torch.tensor(rng.standard_normal((bsz, F, T, C)) * 2,
                               dtype=torch.float32, device=device) + 0.5)
                 .to(dtype) * mask).contiguous()
            gamma, beta = (torch.tensor(rng.standard_normal(C),
                                        dtype=torch.float32, device=device)
                           for _ in range(2))
            got = gn._launch(x, mask, gamma, beta, groups, 1e-5)
            torch.cuda.synchronize()
            tol = TOL['groupnorm_mish'][dn]
            err, ok = _err(got, gn.groupnorm_mish_plain(
                x, mask, gamma, beta, groups), tol, False)
            line[f'{F}x{T}x{C} {dn}'] = {'max_abs_err': err, 'tol': tol,
                                         'ok': ok}
            st['max_abs_err'] = max(st['max_abs_err'], err)
            require(ok, f'groupnorm_mish {dn} block {(bsz, F, T, C)} '
                        f'{groups} groups: max abs err {err} over '
                        f'tolerance {tol}')
    emit(line)


def _sweep1_pairs(got, want, dn):
    """K4's outputs in dtype ``dn``: dA against TOL_K4_DA of its largest
    value, dWq, db and dg against the kernel's TOL of theirs (a float in
    place of the flag is a tolerance of the largest value)."""
    return [(got[0], want[0], TOL_K4_DA[dn])] + [
        (a, b, True) for a, b in zip(got[1:], want[1:])]


def _gn_passes(x, mask, gamma, beta):
    """K1's two passes timed apart, ms each: CUDA events over back-to-back
    calls, and the device time alone (profiler)."""
    from gradtts_tpu_torch.ops import groupnorm_mish as gn
    chunk, tiles = gn._tiling(x)
    part = gn._stats_pass(x, 8, chunk, tiles)

    def stats():
        gn._stats_pass(x, 8, chunk, tiles)

    def apply():
        gn._apply_pass(x, mask, part, gamma, beta, 8, 1e-5, chunk, tiles)

    return {'stats_ms': cuda_ms(stats, 20), 'apply_ms': cuda_ms(apply, 20),
            'stats_device_ms': device_ms(stats),
            'apply_device_ms': device_ms(apply), 'tiles': tiles}


def _kernel_k4_channels(device, rng, st):
    """K4 at every channel count (the U-Net's levels use 64, 128 and 256),
    B 4 and a ragged N of 1001 rows, f32 and bf16, untimed: within
    tolerance of its plain version (dA within TOL_K4_DA), the same bits
    twice."""
    import torch
    from gradtts_tpu_torch.ops import linear_attention as la
    B, N, H = 4, 1001, la.HIDDEN
    line = {'phase': 'kernels', 'path': None, 'shape': [B, N],
            'attention_bwd_sweep1': {}}
    for C in la._CHANNELS:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split('.')[1]

            def t(shape, scale=1.0, dt=dtype):
                return torch.tensor(rng.standard_normal(shape) * scale,
                                    dtype=torch.float32,
                                    device=device).to(dt)

            args = (t((B, N, C), 2.0), t((B, N, C)),
                    t((C, H), 0.5 / math.sqrt(C)), t((B, C, H), 0.1),
                    t((B, H, C), 0.1), t((C,), 0.1, torch.float32))
            got = la.attention_bwd_sweep1(*args)
            again = la.attention_bwd_sweep1(*args)
            torch.cuda.synchronize()
            want = la.attention_bwd_sweep1_plain(*args)
            errs = [_err(a, b, *((r, True) if isinstance(r, float)
                                 else (TOL['attention_bwd_sweep1'][dn], r)))
                    for a, b, r in _sweep1_pairs(got, want, dn)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            err = max(e for e, _ in errs)
            line['attention_bwd_sweep1'][f'{dn},{C}'] = {
                'max_abs_err': err, 'ok': all(o for _, o in errs),
                'bitwise_repeatable': same}
            st['max_abs_err'] = max(st['max_abs_err'], err)
            require(all(o for _, o in errs), f'attention_bwd_sweep1 {dn} '
                    f'{(B, N, C)}: max abs err {err} over tolerance')
            require(same, f'attention_bwd_sweep1 {dn} {(B, N, C)}: two runs '
                          'differ')
    emit(line)


def _sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi), MHz."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, 'nvidia-smi gave no SM clock')
    return float(smi.stdout.split()[0])


def _kernel_mas(device, rng, st, path, shape):
    """MAS at ``shape`` [B, Tx, Ty]: bit-exact against its plain version;
    timed where ``path`` names the path whose shape it is. The one-warp
    route's chain estimate: its frames (the largest t_y) times the
    instructions of its SASS frame loop at the card's maximum SM clock, one
    instruction a cycle (an estimate, not a bound)."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.ops import _build
    from gradtts_tpu_torch.ops import mas
    bsz, tx, ty = shape
    t_x = rng.integers(tx // 2, tx + 1, bsz)
    t_y = np.minimum(t_x * rng.uniform(2.0, 4.0, bsz), ty).astype(int)
    t_x[0], t_y[0] = tx, ty
    mask = torch.zeros((bsz, tx, ty), device=device)
    for i in range(bsz):
        mask[i, :t_x[i], :t_y[i]] = 1.0
    value = torch.tensor(rng.standard_normal((bsz, tx, ty)) * 30.0 - 100.0,
                         dtype=torch.float32, device=device)
    got = mas.maximum_path(value, mask)
    torch.cuda.synchronize()
    want = mas.maximum_path_plain(value, mask)
    err = float((got - want).abs().max())
    route, K = mas.mas_route(tx, ty)
    line = {'phase': 'kernels', 'path': path, 'shape': list(shape),
            'dtype': 'float32',
            'maximum_path': {'max_abs_err': err, 'tol': 0.0,
                             'exact': bool(torch.equal(got, want)),
                             'path_cells': int(want.sum()), 'route': route,
                             'cells_a_lane': K}}
    require(torch.equal(got, want), f'maximum_path {shape}: kernel and plain '
                                    f'paths differ (max abs err {err})')
    st['max_abs_err'] = max(st['max_abs_err'], err)
    if path is not None:
        cells = bsz * tx * ty
        _timed(st.setdefault(path, _stat()), 1,
               lambda: mas.maximum_path(value, mask),
               lambda: mas.maximum_path_plain(value, mask), 3 * cells * 4,
               4 * int((mask != 0).sum()), 'float32', line['maximum_path'])
        if route == 'register':
            loop = sass_loop_with(_build.library_path('mas'),
                                  f'mas_dp<{K}>', r'SHFL\.UP')
            est = int(t_y.max()) * loop / (_sm_clock_mhz() * 1e3)
            line['maximum_path'].update(frame_loop_instructions=loop,
                                        chain_estimate_ms=est)
            st[path]['chain_estimate_ms'] = est
    emit(line)


# ---- conv3x3 ----------------------------------------------------------------

# the f32 cells whose Block convolutions take the conv3x3 kernel: (B, frames
# at the U-Net's top level), the benchmark's tedlium-spk-nbest-b50 and
# tedlium-spk-generate-b32
CONV_CELLS = {'nbest': (50, 512), 'generate': (32, 768)}
# a launch's output against the plain version in float64: within 2^-18 of
# sum |w| |x * mask| + |b| (tests/test_torch_conv3x3.py _err_bound says why)
CONV_TOL = 2.0 ** -18


def _conv_inputs(device, B, c_in, c_out, F, T, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, c_in, F, T), generator=g, device=device) \
        .contiguous(memory_format=torch.channels_last)
    mask = torch.ones((B, 1, 1, T), device=device)
    mask[-1, ..., T - T // 3:] = 0
    w = torch.randn((c_out, c_in, 3, 3), generator=g, device=device) \
        * (9 * c_in) ** -0.5
    b = torch.randn((c_out,), generator=g, device=device) * 0.1
    return x, mask, w, b


def _conv_err(outs, x, mask, w, b):
    """The largest error of the kernel's outputs ``outs`` (with the bias,
    without it) over sum |w| |x * mask| + |b|, against the plain version
    in float64."""
    from gradtts_tpu_torch.ops import conv3x3 as c3
    import torch
    d = [v.double() for v in (x, mask, w)]
    bias = b.double().view(-1, 1, 1)
    want = c3.conv3x3_plain(*d)
    mag = c3.conv3x3_plain((d[0] * d[1]).abs(), torch.ones_like(d[1]),
                           d[2].abs()).clamp_min(1e-30)
    errs = [float(((out.double() - want - c).abs() / (mag + c.abs())).max())
            for out, c in zip(outs, (bias, bias * 0))]
    del want, mag, d
    return max(errs)


def phase_conv3x3(device):
    """The Block convolution's kernel (ops/conv3x3.py): at every Block
    width against the plain version in float64 (B 2, the cells' F and
    frames), within CONV_TOL of sum |w| |x| (tests/test_torch_conv3x3.py
    says why), primal and tangent; then timed at each width of the n-best
    and generate cells (B 50 x 512 and B 32 x 768 frames at the top level)
    against cuDNN's f32 call with TF32 off (``library_ms``; the widths
    where it is not faster are listed) and the plain version (x * mask,
    then that call), the timed launch's output and a launch without the
    bias (the tangent's) held to the float64 version at CONV_TOL too. Its
    launches are counted on each path below, from 0 (``_counted``).
    Returns the kernels line's figures, the n-best cell's sums per U-Net
    evaluation."""
    import torch
    from torch.nn import functional as F
    from gradtts_tpu_torch.models.diffusion import GradLogPEstimator2d
    from gradtts_tpu_torch.ops import conv3x3 as c3
    torch.backends.cudnn.allow_tf32 = False
    blocks = GradLogPEstimator2d(64, n_spks=675,
                                 spk_emb_dim=128).block_widths()
    widths = sorted(set(blocks), key=blocks.index)
    worst = 0.0
    for c_in, c_out, level in widths:
        for T in (CONV_CELLS['nbest'][1], CONV_CELLS['generate'][1]):
            F_, T_ = 80 >> level, T >> level
            x, mask, w, b = _conv_inputs(device, 2, c_in, c_out, F_, T_,
                                         c_in + T_)
            got = c3.conv3x3(x, mask, w, b)
            with torch.no_grad():
                _, tan = torch.func.jvp(lambda a: c3.conv3x3(a, mask, w, b),
                                        (x,), (x * 0.5,))
            torch.cuda.synchronize()
            rel = max(_conv_err((got,), x, mask, w, b),
                      _conv_err((tan,), x * 0.5, mask, w, b * 0))
            worst = max(worst, rel)
            require(rel <= CONV_TOL, f'conv3x3 {(c_in, c_out, F_, T_)}: '
                                     f'error {rel} of sum |w x|')
    lines, sums, slower, worst_timed = {}, {}, [], 0.0
    for cell, (B, T) in CONV_CELLS.items():
        st = sums[cell] = {'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0,
                           'library_ms': 0.0, 'bytes_ms': 0.0, 'ops_ms': 0.0}
        for c_in, c_out, level in widths:
            F_, T_ = 80 >> level, T >> level
            mult = blocks.count((c_in, c_out, level))
            x, mask, w, b = _conv_inputs(device, B, c_in, c_out, F_, T_, 0)
            taps = c3.tap_major(w)
            xm = x * mask
            out = {}

            def kern():
                out['y'] = c3._launch(x, mask, taps, b)

            ms, dev_ms = cuda_ms(kern, 20), device_ms(kern)
            plain_ms = cuda_ms(lambda: c3.conv3x3_plain(x, mask, w, b), 3, 1)
            lib_ms = cuda_ms(lambda: F.conv2d(xm, w, b, padding=1), 3, 1)
            del xm
            rel = _conv_err((out.pop('y'), c3._launch(x, mask, taps, None)),
                            x, mask, w, b)
            worst_timed = max(worst_timed, rel)
            flops = 18 * B * F_ * T_ * c_in * c_out
            nbytes = 4 * (B * F_ * T_ * (c_in + c_out) + B * T_
                          + 9 * c_in * c_out + c_out)
            b_ms, by = bound(nbytes, flops, 'float32')
            key = f'{c_in}->{c_out} F{F_} T{T_}'
            lines[f'{cell} {key}'] = {
                'blocks': mult, 'ms': ms, 'device_ms': dev_ms,
                'plain_ms': plain_ms, 'library_ms': lib_ms,
                'bound_ms': b_ms, 'bound_by': by,
                'tflops': flops / dev_ms * 1e-9,
                'share_of_f32_peak': flops / PEAK_FLOPS['float32']
                / (dev_ms * 1e-3), 'max_err_of_sum_abs': rel}
            require(rel <= CONV_TOL, f'conv3x3 {cell} {key}: error {rel} of '
                                     'sum |w x|')
            if ms >= lib_ms:
                slower.append(f'{cell} {key}')
            for k, v in (('ms', ms), ('device_ms', dev_ms),
                         ('plain_ms', plain_ms), ('library_ms', lib_ms),
                         ('bytes_ms', nbytes / HBM_BPS * 1e3),
                         ('ops_ms', flops / PEAK_FLOPS['float32'] * 1e3)):
                st[k] += mult * v
            del x, mask, w, b, taps
            torch.cuda.empty_cache()
    emit({'phase': 'conv3x3', 'max_err_of_sum_abs': worst,
          'max_err_of_sum_abs_timed': worst_timed,
          'per_evaluation': sums, 'widths': lines,
          'slower_than_cudnn': slower})
    st = sums['nbest']
    return {'name': 'conv3x3', 'route': 'cuda',
            'source': 'gradtts_tpu_torch/csrc/conv3x3.cu',
            'replaces': None,
            'max_err_of_sum_abs': max(worst, worst_timed), 'ms': st['ms'],
            'device_ms': st['device_ms'], 'plain_ms': st['plain_ms'],
            'bound_ms': max(st['bytes_ms'], st['ops_ms']),
            'bound_by': 'bytes' if st['bytes_ms'] >= st['ops_ms']
            else 'operations',
            'library_ms': st['library_ms'],
            'per': 'sum over the 25 Block convolutions of one U-Net '
                   'evaluation (primal), B 50, Ty 512, f32'}


# ---- slice ------------------------------------------------------------------


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


def _counted():
    """{kernel: its wrapper}, each wrapper counting its launches."""
    from gradtts_tpu_torch.ops import conv3x3 as c3
    from gradtts_tpu_torch.ops import groupnorm_mish as gn
    from gradtts_tpu_torch.ops import linear_attention as la
    from gradtts_tpu_torch.ops import mas
    return {'groupnorm_mish': gn.groupnorm_mish,
            'attention_stats': la.attention_stats,
            'attention_apply': la.attention_apply,
            'attention_bwd_sweep1': la.attention_bwd_sweep1,
            'attention_bwd_sweep2': la.attention_bwd_sweep2,
            'attention_jvp_stats': la.attention_jvp_stats,
            'attention_jvp_apply': la.attention_jvp_apply,
            'maximum_path': mas.maximum_path, 'conv3x3': c3.conv3x3}


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counted().items()}


# launches per synthesis (10 U-Net calls of 25 Blocks and 6 attentions),
# per training step (one U-Net forward and backward, one MAS) and per
# likelihood score of ``steps`` Euler steps (one MAS; every step one U-Net
# forward, whose jvp adds K6 and K7 to each attention and recomputes K1's
# plain version for its tangent), in bf16: no Block convolution takes the
# conv3x3 kernel (``in_f32`` gives the f32 counts)
EXPECTED_COUNTS = {'groupnorm_mish': 25 * STEPS, 'attention_stats': 6 * STEPS,
                   'attention_apply': 6 * STEPS, 'attention_bwd_sweep1': 0,
                   'attention_bwd_sweep2': 0, 'attention_jvp_stats': 0,
                   'attention_jvp_apply': 0, 'maximum_path': 0, 'conv3x3': 0}
TRAIN_COUNTS = {'groupnorm_mish': 25, 'attention_stats': 6,
                'attention_apply': 6, 'attention_bwd_sweep1': 6,
                'attention_bwd_sweep2': 6, 'attention_jvp_stats': 0,
                'attention_jvp_apply': 0, 'maximum_path': 1, 'conv3x3': 0}


def likelihood_counts(steps):
    return {'groupnorm_mish': 25 * steps, 'attention_stats': 6 * steps,
            'attention_apply': 6 * steps, 'attention_bwd_sweep1': 0,
            'attention_bwd_sweep2': 0, 'attention_jvp_stats': 6 * steps,
            'attention_jvp_apply': 6 * steps, 'maximum_path': 1,
            'conv3x3': 0}


# conv3x3 launches a U-Net evaluation in f32 with cuDNN's TF32 off, one a
# Block whose conv ``ops.conv3x3.fits``: all 25 at the published width
# (dim 64); 1 with the convs split over a 2-wide 'model' axis, where
# ``parallel.mesh.split_dim`` leaves final_block's whole; 8 at the quality
# gate's dec_dim 16 (the level-2 and middle Blocks, C_out 64)
CONVS_WHOLE, CONVS_SPLIT, CONVS_GATE = 25, 1, 8


def in_f32(counts, convs=CONVS_WHOLE, tangent=False):
    """``counts`` of a path (bf16's) on the same path in f32 with cuDNN's
    TF32 off: ``convs`` conv3x3 launches each U-Net evaluation (each
    evaluation runs 25 K1), twice that in forward mode (``tangent``)."""
    evals = counts['groupnorm_mish'] // 25
    return {**counts, 'conv3x3': evals * convs * (2 if tangent else 1)}


def _slice_batch(cfg, rng, bsz=2, t_x=64):
    """Token ids [2, 64] of the slices, the second item 40 long."""
    import torch
    x = torch.from_numpy(rng.integers(1, cfg.n_vocab, (bsz, t_x)))
    x[1, 40:] = 0
    return x, torch.tensor([t_x, 40])


def _on(dev, kw):
    import torch
    return {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}


def _check(line, checks):
    """Emits ``line``, then requires each (condition, message)."""
    emit(line)
    for cond, msg in checks:
        require(cond, msg)


def _gpu_vs_cpu_synthesis(make_model, device, x, x_lengths, t_y, what, **kw):
    """10-step synthesis (temperature 1.5) of ``make_model(dev)`` on the GPU
    and on the CPU (plain versions) with the same inputs ``kw`` (noise,
    speakers, sampler). Returns (line entries, checks): y_lengths and attn
    equal, the mel finite and within SLICE_TOL of its largest value (f32
    on both sides with TF32 off; cuDNN and oneDNN pick other conv
    algorithms and sum orders, ~1e-5 relative per U-Net call, and the
    steps grow the mel and its error alike: 1e-3 of the largest value
    leaves a wide margin), the kernels launched as EXPECTED_COUNTS in f32
    (``in_f32``) on the GPU and never on the CPU."""
    import torch
    from gradtts_tpu_torch.models.tts import synthesize
    outs = []
    for dev in (device, torch.device('cpu')):
        model = make_model(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = synthesize(model, x.to(dev), x_lengths.to(dev), STEPS, t_y,
                         temperature=1.5, **_on(dev, kw))
        outs.append(([t.cpu() for t in res], read_counts(),
                     time.perf_counter() - t0))
    (g, counts, g_s), (c, cpu_counts, c_s) = outs
    enc_g, dec_g, attn_g, yl_g, _ = g
    enc_c, dec_c, attn_c, yl_c, _ = c
    scale = float(dec_c.abs().max())
    err = float((dec_g - dec_c).abs().max())
    entry = {'y_lengths': yl_g.tolist(),
             'y_lengths_equal': bool(torch.equal(yl_g, yl_c)),
             'attn_equal': bool(torch.equal(attn_g, attn_c)),
             'encoder_max_abs_err': float((enc_g - enc_c).abs().max()),
             'decoder_max_abs_err': err, 'decoder_max_abs': scale,
             'tol': SLICE_TOL * scale, 'gpu_launches': counts,
             'cpu_launches': cpu_counts, 'gpu_s': g_s, 'cpu_s': c_s}
    checks = [
        (entry['y_lengths_equal'] and entry['attn_equal'],
         f'{what}: y_lengths or attn differ between GPU and CPU'),
        (bool(torch.isfinite(dec_g).all()) and scale > 0,
         f'{what}: mel not finite'),
        (err <= SLICE_TOL * scale,
         f'{what}: decoder max abs err {err} over {SLICE_TOL * scale}'),
        (counts == in_f32(EXPECTED_COUNTS), f'{what}: GPU launches {counts}'),
        (not any(cpu_counts.values()), f'{what}: the CPU run launched '
                                       'kernels')]
    return entry, checks


def phase_slice(device):
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import GradTTS

    cfg = get_config('ljspeech')
    sd = seeded_state_dict(GradTTS.from_config(cfg), seed=0)
    os.makedirs(WORK, exist_ok=True)
    ckpt = os.path.join(WORK, 'ljspeech_seeded.pt')
    torch.save(sd, ckpt)

    rng = np.random.default_rng(1)
    x, x_lengths = _slice_batch(cfg, rng)
    noise = torch.from_numpy(
        rng.standard_normal((2, 256, cfg.data.n_feats)).astype(np.float32))
    entry, checks = _gpu_vs_cpu_synthesis(
        lambda dev: _seeded_model(cfg, ckpt, dev), device, x, x_lengths, 256,
        'slice', noise=noise)
    _check({'phase': 'slice', 'params': sum(v.numel() for v in sd.values()),
            **entry}, checks)
    return ckpt


# ---- cli --------------------------------------------------------------------


def _cli_outputs(out, n, wav):
    """The shapes of ``mel_{i}.npy`` (and, with ``wav``, of
    ``sample_{i}.wav``) for the n texts, each read back, non-empty and
    finite."""
    import numpy as np
    from scipy.io import wavfile
    shapes = []
    for i in range(n):
        mel = np.load(os.path.join(out, f'mel_{i}.npy'))
        require(mel.ndim == 2 and mel.shape[1] == 80 and mel.shape[0] > 0
                and np.isfinite(mel).all(), f'cli: {out} mel_{i} malformed')
        shapes.append(list(mel.shape))
        if wav:
            _, samples = wavfile.read(os.path.join(out, f'sample_{i}.wav'))
            require(samples.dtype == np.int16 and samples.shape
                    == (mel.shape[0] * HOP,) and samples.any(),
                    f'cli: {out} sample_{i}.wav malformed')
            shapes[-1].append(int(samples.shape[0]))
    return shapes


def phase_cli(ckpt, spk_ckpt, vocoder_ckpt):
    """python -m gradtts_tpu_torch.cli.inference, in this process, on the
    seeded checkpoints: the Euler ODE, DPM with the vocoder, the SDE
    (--stoc) with the vocoder, and a speaker of the seeded tedlium-spk
    model (-s 3)."""
    texts = os.path.join(WORK, 'texts.txt')
    with open(texts, 'w', encoding='utf-8') as f:
        f.write('The quick brown fox jumps over the lazy dog.\n'
                'Grad-TTS synthesizes a mel-spectrogram from text.\n'
                'It ran on the GPU in 2026.\n')
    vocoder = ['--vocoder', vocoder_ckpt]
    runs = {'euler': (ckpt, []), 'dpm_vocoder': (ckpt, ['--sampler', 'dpm',
                                                        *vocoder]),
            'stoc_vocoder': (ckpt, ['--stoc', *vocoder]),
            'tedlium_spk_s3': (spk_ckpt, ['--preset', 'tedlium-spk', '-s',
                                          '3'])}
    line = {'phase': 'cli'}
    for name, (c, extra) in runs.items():
        out = os.path.join(WORK, f'cli_out_{name}')
        _, seconds = _cli_main('gradtts_tpu_torch.cli.inference', [
            '-f', texts, '-c', c, '-o', out, '-t', str(STEPS), *extra])
        line[name] = {'args': extra, 'seconds': seconds,
                      'outputs': _cli_outputs(out, 3, '--vocoder' in extra)}
    emit(line)


# ---- synth ------------------------------------------------------------------


def phase_synth(device, card):
    """bf16 synthesis at bench.py's shape: launches per synthesis (counts
    set to 0 just before the main path's run, read just after), the median
    of 5 calls (``time_jitted``), audio-s/s (``Throughput``) and the device
    share. Returns (the launches, the synthesis as a function)."""
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

    per_call, timing = median_call(run, 5)          # a warm-up, 5 timed
    reset_counts()
    res = run()                                     # the main path's run
    counts = read_counts()
    require(counts == EXPECTED_COUNTS,
            f'synth: launches per synthesis {counts}, expected '
            f'{EXPECTED_COUNTS}')
    require(bool(torch.isfinite(res.decoder_outputs).all()),
            'synth: mel not finite')
    tp = throughput(B * TY, B, per_call)
    share = _device_share(run, per_call * 1e3, 'synth')
    emit({'phase': 'synth', 'card': card, 'batch': B, 'tx': TX, 'ty': TY,
          'steps': STEPS,
          'dtype': 'bfloat16', 'seconds_per_call': per_call,
          'timing': timing, 'audio_s_per_s': tp.audio_sec_per_sec,
          'rtf': tp.rtf, 'launches_per_synthesis': counts,
          'y_lengths': res.y_lengths.tolist(), **share})
    return counts, run


# ---- profiling ----------------------------------------------------------


def phase_profiling(run, card):
    """``utils.profiling.trace`` over one synthesis of phase synth (bf16,
    B 8, Tx 128, Ty 768, 10 Euler steps): the trace file is written and
    not empty, and its device events name K1's and K2/K3's kernels."""
    import tempfile
    from torch.autograd import DeviceType
    from gradtts_tpu_torch.utils.profiling import trace

    with tempfile.TemporaryDirectory(dir=WORK) as logdir:
        t0 = time.perf_counter()
        with trace(logdir, create_perfetto_link=True) as prof:
            run()
        trace_s = time.perf_counter() - t0
        files = os.listdir(logdir)
        sizes = [os.path.getsize(os.path.join(logdir, f)) for f in files]
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    seen = {k: sum(k in n for n in device) for k in (
        'gn_stats_kernel', 'gn_apply_kernel', 'la_stats_kernel',
        'la_apply_kernel')}
    line = {'phase': 'profiling', 'card': card, 'trace_files': files,
            'trace_bytes': sizes, 'trace_seconds': trace_s,
            'events': len(prof.events()), 'device_events': len(device),
            'hand_kernel_events': seen}
    _check(line, [
        (len(files) == 1 and files[0].endswith('.pt.trace.json')
         and sizes[0] > 0, f'profiling: trace files {files} {sizes}'),
        (all(seen.values()), f'profiling: kernels in the trace {seen}')])


# ---- train_slice ------------------------------------------------------------

# GPU vs CPU, f32 with TF32 off: the losses are means over ~27k squared U-Net
# outputs (~1e-5 relative apart, as in phase slice); each grad within 1e-3
# of its tensor's largest value, since the backward sums over many more
# terms in other orders. The key biases of the encoder's attention have an exact
# grad of zero (the softmax cancels a shift of a whole score row), so both
# sides hold rounding noise there: each below 1e-7 of the largest grad
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-4, 1e-3


def _gpu_vs_cpu_loss(make_model, device, batch, what, convs=CONVS_WHOLE,
                     **kw):
    """compute_loss + backward of ``make_model(dev)`` on both devices with
    the same crop offsets, diffusion times and noise (``kw``). Returns
    (line entries, checks) at TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL, the MAS
    paths equal and the kernels launched as TRAIN_COUNTS in f32 (``convs``
    conv3x3 launches in the forward) on the GPU and never on the CPU."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.models.tts import compute_loss
    results = []
    for dev in (device, torch.device('cpu')):
        model = make_model(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = compute_loss(model, *(a.to(dev) for a in batch),
                           **_on(dev, kw))
        (res.dur_loss + res.prior_loss + res.diff_loss).backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        results.append(([float(v.detach()) for v in res[:3]], res.attn.cpu(),
                        grads, read_counts(), time.perf_counter() - t0))
    (g_loss, g_attn, g_grads, counts, g_s), \
        (c_loss, c_attn, c_grads, cpu_counts, c_s) = results
    largest = max(float(v.abs().max()) for v in c_grads.values())
    worst, worst_name, noise, finite = 0.0, None, 0.0, True
    for name, want in c_grads.items():
        got = g_grads.get(name, torch.zeros_like(want))
        finite = finite and bool(torch.isfinite(got).all())
        if name.endswith('conv_k.bias'):
            noise = max(noise, float(got.abs().max()),
                        float(want.abs().max()))
            continue
        frac = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if frac > worst:
            worst, worst_name = frac, name
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss)]
    entry = {'losses_gpu': g_loss, 'losses_cpu': c_loss,
             'loss_rel_err': loss_rel, 'loss_rtol': TRAIN_LOSS_RTOL,
             'attn_equal': bool(torch.equal(g_attn, c_attn)),
             'attn_cells': int(g_attn.sum()), 'grad_tensors': len(c_grads),
             'grad_worst_frac': worst, 'grad_worst_name': worst_name,
             'grad_tol': TRAIN_GRAD_TOL, 'zero_grad_noise_frac':
             noise / largest, 'gpu_launches': counts,
             'cpu_launches': cpu_counts, 'gpu_s': g_s, 'cpu_s': c_s}
    checks = [
        (set(g_grads) == set(c_grads), f'{what}: the GPU and the CPU gave '
                                       'grads to other parameters'),
        (finite, f'{what}: a grad is not finite'),
        (all(np.isfinite(g_loss)), f'{what}: loss not finite'),
        (max(loss_rel) <= TRAIN_LOSS_RTOL,
         f'{what}: losses {g_loss} vs {c_loss}'),
        (entry['attn_equal'], f'{what}: MAS paths differ'),
        (worst <= TRAIN_GRAD_TOL, f'{what}: grad of {worst_name} off by '
                                  f'{worst} of its largest value'),
        (noise <= 1e-7 * largest, f'{what}: a key bias grad is not rounding '
                                  'noise'),
        (counts == in_f32(TRAIN_COUNTS, convs),
         f'{what}: GPU launches {counts}'),
        (not any(cpu_counts.values()), f'{what}: the CPU run launched '
                                       'kernels')]
    return entry, checks


def phase_train_slice(device, ckpt):
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config

    cfg = get_config('ljspeech')
    rng = np.random.default_rng(3)
    x, x_lengths = _slice_batch(cfg, rng)
    t_y = 256
    y_lengths = torch.tensor([t_y, 200])
    y = torch.from_numpy(rng.standard_normal(
        (2, t_y, cfg.data.n_feats)).astype(np.float32) - 5.0)
    y[1, 200:] = 0
    z = torch.from_numpy(rng.standard_normal(
        (2, cfg.out_size, cfg.data.n_feats)).astype(np.float32))
    entry, checks = _gpu_vs_cpu_loss(
        lambda dev: _seeded_model(cfg, ckpt, dev), device,
        (x, x_lengths, y, y_lengths), 'train_slice', out_size=cfg.out_size,
        offset=torch.tensor([40, 11]), t=torch.tensor([0.3, 0.8]), z=z)
    _check({'phase': 'train_slice', **entry}, checks)


# ---- train ------------------------------------------------------------------

CORPUS_ITEMS, TRAIN_STEPS = 64, 2


def write_corpus(directory, n_items, texts=None, sr=SR,
                 seconds=(1.5, 10.0)):
    """``n_items`` wavs at ``sr`` (a sine plus noise), each as long as its
    text (``texts``, or the first of the ljspeech training filelist) takes
    at ~15 characters a second, within ``seconds``, and their
    ``path|text`` filelist."""
    import wave
    import numpy as np
    os.makedirs(directory, exist_ok=True)
    if texts is None:
        with open(os.path.join(REPO, 'resources', 'filelists', 'ljspeech',
                               'train.txt'), encoding='utf-8') as f:
            texts = [ln.rstrip('\n').split('|')[1] for _, ln in zip(
                range(n_items), f)]
    rng = np.random.default_rng(4)
    lines = []
    for i, text in enumerate(texts[:n_items]):
        length = min(max(len(text) / 15.0, seconds[0]), seconds[1])
        tt = np.arange(int(sr * length)) / sr
        wav = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * tt)
               + 0.05 * rng.standard_normal(tt.shape))
        path = os.path.join(directory, f'{i:03d}.wav')
        with wave.open(path, 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((wav * 32767).astype('<i2').tobytes())
        lines.append(f'{path}|{text}')
    filelist = os.path.join(directory, 'filelist.txt')
    with open(filelist, 'w', encoding='utf-8') as f:
        f.write('\n'.join(lines) + '\n')
    return filelist


def _run_cli(module, args):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    require(proc.returncode == 0, f'{module} exited {proc.returncode}:\n'
                                  f'{proc.stderr[-3000:]}')
    return proc, time.perf_counter() - t0


def _train_log(log_dir, what):
    """The per-epoch metrics of a training run's train.log, all finite."""
    epochs = []
    with open(os.path.join(log_dir, 'train.log'), encoding='utf-8') as f:
        for ln in f:
            values = dict(kv.split('=') for kv in re.findall(
                r'[\w/]+=[-\d.e+naif]+', ln))
            epochs.append({k: float(v) for k, v in values.items()})
    require(epochs and all(math.isfinite(v) for e in epochs
                           for v in e.values()),
            f'{what}: losses not finite: {epochs}')
    return epochs


def _input_pipeline(proc, what):
    """The mels a cli.train run took, from its log: on the card the auto
    rule (train.device_mel None) must pick the device's."""
    found = re.search(r'input pipeline: (\w+) mels', proc.stderr)
    require(found and found.group(1) == 'device',
            f'{what}: the CLI did not take device mels: '
            f'{found.group(0) if found else "no input pipeline line"}')
    return found.group(0)


def phase_train(device, card):
    import shutil
    import numpy as np

    filelist = write_corpus(os.path.join(WORK, 'corpus'), CORPUS_ITEMS)
    log_dir = os.path.join(WORK, 'train')
    shutil.rmtree(log_dir, ignore_errors=True)
    common = ['--preset', 'ljspeech', '--log-dir', log_dir, '--no-previews',
              '--set', f'data.train_filelist_path={filelist}']
    proc, train_s = _run_cli('gradtts_tpu_torch.cli.train',
                             common + ['--max-steps', str(TRAIN_STEPS)])
    route = _input_pipeline(proc, 'train')
    _, resume_s = _cli_main('gradtts_tpu_torch.cli.train',
                            common + ['--max-steps', '1'])
    epochs = _train_log(log_dir, 'train')
    ckpt = os.path.join(log_dir, 'ckpt', f'step_{TRAIN_STEPS + 1:08d}.pt')
    require(os.path.exists(ckpt), 'train: the resumed run wrote no '
                                  f'{os.path.basename(ckpt)}')
    texts = os.path.join(WORK, 'train_texts.txt')
    with open(texts, 'w', encoding='utf-8') as f:
        f.write('Printing, in the only sense with which we are at present '
                'concerned.\n')
    out = os.path.join(WORK, 'train_cli_out')
    _, infer_s = _cli_main('gradtts_tpu_torch.cli.inference',
                           ['-f', texts, '-c', ckpt, '-o', out, '-t',
                            str(STEPS), '--bf16'])
    mel = np.load(os.path.join(out, 'mel_0.npy'))
    require(mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all(),
            'train: inference from the trained checkpoint is malformed')
    return phase_train_step(device, card, filelist, {
        'cli_steps': TRAIN_STEPS, 'cli_seconds': train_s,
        'input_pipeline': route, 'resume_seconds': resume_s,
        'inference_seconds': infer_s, 'epochs': epochs})


def train_cell(filelist, device, preset='ljspeech', compute='bfloat16'):
    """The train cell's config, model and batch: ``preset`` on the corpus
    ``filelist``, the model drawn from the config's seed with ``compute``
    (bf16 in the cell) on ``device``, and the collated batch of the
    corpus's first TRAIN_B utterances (host numpy)."""
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import GradTTS, set_compute_dtype

    cfg = get_config(preset, **{'data.train_filelist_path': filelist})
    batch = _cell_batch(filelist, preset)
    torch.manual_seed(cfg.train.seed)
    model = GradTTS.from_config(cfg).to(device).train()
    set_compute_dtype(model, getattr(torch, compute))
    return cfg, model, batch


@functools.lru_cache(maxsize=None)
def _cell_batch(filelist, preset):
    """The collated batch of :func:`train_cell`, collated once a process
    (its host mels take seconds; callers do not change it)."""
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.data.dataset import (BatchCollate,
                                                dataset_from_config)
    cfg = get_config(preset, **{'data.train_filelist_path': filelist})
    dataset = dataset_from_config(cfg)
    return BatchCollate(cfg.data.x_buckets, cfg.data.y_buckets)(
        [dataset[i] for i in range(TRAIN_B)])


def phase_train_step(device, card, filelist=None, cli=None,
                     preset='ljspeech', phase='train'):
    """The train step of ``preset`` in-process on one collated batch of the
    corpus (written here when ``filelist`` is None): launches per step,
    steps/s, utterances/s, audio-s trained per second and the device
    share. Emits the ``phase`` line (with the CLI run's figures ``cli``,
    where given). Returns (launches per step, utterances/s)."""
    import torch
    from gradtts_tpu_torch.train.loop import batch_to
    from gradtts_tpu_torch.train.state import make_optimizer, train_step

    if filelist is None:
        filelist = write_corpus(os.path.join(WORK, 'corpus'), TRAIN_B)
    cfg, model, batch = train_cell(filelist, device, preset)
    batch = batch_to(batch, device)
    optimizer = make_optimizer(model.parameters(), cfg.train.learning_rate)
    gen = torch.Generator(device=device).manual_seed(0)

    def run():
        metrics = train_step(model, optimizer, batch, cfg.out_size,
                             cfg.train.grad_clip_norm, gen)
        torch.cuda.synchronize()
        return metrics

    torch.cuda.reset_peak_memory_stats(device)
    per_step, timing = median_call(run, 5, warmup=2)
    peak = torch.cuda.max_memory_allocated(device)
    reset_counts()
    metrics = run()                                 # the main path's run
    counts = read_counts()
    require(counts == TRAIN_COUNTS, f'{phase}: launches per step {counts}, '
                                    f'expected {TRAIN_COUNTS}')
    require(all(math.isfinite(float(v)) for v in metrics.values()),
            f'{phase}: step metrics not finite: {metrics}')
    require(all(p.dtype == torch.float32 for p in model.parameters()),
            f'{phase}: a parameter left f32')
    share = _device_share(run, per_step * 1e3, phase)
    tp = throughput(TRAIN_B * cfg.out_size, TRAIN_B, per_step,
                    cfg.data.sample_rate, cfg.data.hop_length)
    audio_s = tp.audio_seconds
    emit({'phase': phase, 'card': card, 'preset': preset, 'batch': TRAIN_B,
          'crop': cfg.out_size, 'x_shape': list(batch['x'].shape),
          'y_shape': list(batch['y'].shape),
          'speakers': batch['spk'].tolist() if 'spk' in batch else None,
          'dtype': 'bfloat16 compute, float32 parameters',
          **(cli or {}), 'seconds_per_step': per_step,
          'timing': timing, 'steps_per_s': 1 / per_step,
          'utterances_per_s': TRAIN_B / per_step,
          'audio_s_per_step': audio_s,
          'audio_s_trained_per_s': tp.audio_sec_per_sec,
          'launches_per_step': counts, 'peak_memory_gib': peak / 2 ** 30,
          'metrics': {k: float(v) for k, v in metrics.items()}, **share})
    return counts, TRAIN_B / per_step


# ---- likelihood_slice -------------------------------------------------------

# GPU vs CPU, f32 with TF32 off, the same probe: each drift evaluation
# differs by ~1e-5 relative (phase slice), and the random model's flow grows
# that over the 4 steps; scores are sums of ~41k terms that partly cancel:
# 1e-3 relative on score, prior_logp and delta_logp, and 1e-3 of max |z|
LIK_SLICE_RTOL = 1e-3
LIK_SLICE_STEPS = 4
# tp_likelihood: the likelihood cell scored on two ranks (data 1 x model
# 2, and data 2 x model 1) against one process on the same global batch
# and probe, with __graft_entry__.py:165's 2 Euler steps. f32: the ranks'
# convolutions and K1 run on blocks or rows of the same inputs, so only
# their sums' order differs (the tp step's f32 losses are bit-equal): 1e-5
# relative, z 1e-5 of its largest. bf16 rounds those sums: the GPU-vs-CPU
# bound, 1e-3. The adaptive run's scores: 1e-3 (tests/test_torch_
# likelihood.py's bound for ~60 evaluations); its nfe and converged equal
LIK_MESH_STEPS = 2
LIK_MESH_SEED = 3
LIK_MESH_RTOL = {'float32': 1e-5, 'bfloat16': LIK_SLICE_RTOL}
# z, of its largest |z|: f32 as above; in bf16 z is not a sum but each
# element's own drift, rounded to bf16 in the U-Net's last conv, so a sum
# that rounds the other way moves it by a bf16 ulp (2^-8 relative): two
# ulps, as K1's bf16 outputs (2.9e-3 in this phase on an H100)
LIK_MESH_Z_TOL = {'float32': 1e-5, 'bfloat16': 2 ** -7}


def _likelihood_batch(cfg, rng, bsz, t_x, t_y, y_lengths):
    """Token ids, lengths and log-mel-like frames (N(-5, 2), zero past each
    length) for score_batch."""
    import numpy as np
    import torch
    x = torch.from_numpy(rng.integers(1, cfg.n_vocab, (bsz, t_x)))
    x_lengths = torch.full((bsz,), t_x)
    y = rng.standard_normal((bsz, t_y, cfg.data.n_feats)) * 2.0 - 5.0
    for i, n in enumerate(y_lengths):
        y[i, n:] = 0.0
    return (x, x_lengths, torch.from_numpy(y.astype(np.float32)),
            torch.tensor(y_lengths))


def _seeded_model(cfg, ckpt, device):
    import torch
    from gradtts_tpu_torch.models.tts import GradTTS
    model = GradTTS.from_config(cfg)
    model.load_state_dict(torch.load(ckpt, weights_only=True), strict=True)
    return model.to(device).eval()


def _gpu_vs_cpu_score(make_model, device, batch, eps, what, **kw):
    """A LIK_SLICE_STEPS-step score_batch of ``make_model(dev)`` on both
    devices with the same probe ``eps``. Returns (line entries, checks) at
    LIK_SLICE_RTOL, the kernels launched as likelihood_counts in f32
    (``in_f32``, forward mode) on the GPU and never on the CPU."""
    import torch
    from gradtts_tpu_torch.nbest.scoring import score_batch
    outs = []
    for dev in (device, torch.device('cpu')):
        model = make_model(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = score_batch(model, *(a.to(dev) for a in batch),
                          n_euler=LIK_SLICE_STEPS, epsilon=eps.to(dev),
                          **_on(dev, kw))
        outs.append(({k: getattr(res, k).cpu() for k in (
            'score', 'prior_logp', 'delta_logp', 'z')}, read_counts(),
            time.perf_counter() - t0))
    (g, counts, g_s), (c, cpu_counts, c_s) = outs
    rel = {k: float(((g[k] - c[k]).abs() / c[k].abs()).max())
           for k in ('score', 'prior_logp', 'delta_logp')}
    z_frac = float((g['z'] - c['z']).abs().max() / c['z'].abs().max())
    entry = {'steps': LIK_SLICE_STEPS, 'score_gpu': g['score'].tolist(),
             'score_cpu': c['score'].tolist(),
             'prior_logp_gpu': g['prior_logp'].tolist(),
             'delta_logp_gpu': g['delta_logp'].tolist(), 'rel_err': rel,
             'z_err_of_max': z_frac, 'rtol': LIK_SLICE_RTOL,
             'gpu_launches': counts, 'cpu_launches': cpu_counts,
             'gpu_s': g_s, 'cpu_s': c_s}
    checks = [
        (all(bool(torch.isfinite(v).all()) for v in g.values()),
         f'{what}: GPU result not finite'),
        (max(rel.values()) <= LIK_SLICE_RTOL and z_frac <= LIK_SLICE_RTOL,
         f'{what}: GPU vs CPU {rel}, z {z_frac}'),
        (counts == in_f32(likelihood_counts(LIK_SLICE_STEPS), tangent=True),
         f'{what}: GPU launches {counts}'),
        (not any(cpu_counts.values()), f'{what}: the CPU run launched '
                                       'kernels')]
    return entry, checks


def phase_likelihood_slice(device, ckpt):
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config

    cfg = get_config('ljspeech')
    rng = np.random.default_rng(5)
    bsz, t_x, t_y = 2, 64, 256
    x, x_lengths, y, y_lengths = _likelihood_batch(cfg, rng, bsz, t_x, t_y,
                                                   [t_y, 200])
    x_lengths[1] = 40
    x[1, 40:] = 0
    eps = torch.from_numpy((rng.integers(0, 2, y.shape) * 2 - 1).astype(
        np.float32))
    entry, checks = _gpu_vs_cpu_score(
        lambda dev: _seeded_model(cfg, ckpt, dev), device,
        (x, x_lengths, y, y_lengths), eps, 'likelihood_slice')
    _check({'phase': 'likelihood_slice', **entry}, checks)


# ---- nbest_cli --------------------------------------------------------------

NBEST_UTTS, NBEST_N = 4, 2


def phase_nbest_cli(ckpt, spk_ckpt):
    """cli.nbest score, compile and rescore with --preset ljspeech on
    22.05 kHz wavs; then score alone with the CLI's default preset
    (tedlium-spk) on a 16 kHz speaker filelist (``path|text|speaker``),
    its shards compiled; every CLI in this process."""
    _nbest_cli(ckpt, 'nbest', write_corpus, ['--preset', 'ljspeech'])
    _nbest_cli(spk_ckpt, 'nbest_spk', write_speaker_corpus, [],
               score_only=True)


def _nbest_cli(ckpt, name, corpus, preset_args, score_only=False):
    import numpy as np
    from gradtts_tpu_torch.nbest import (compile_scores,
                                         make_synthetic_n_best, save_n_best)

    directory = os.path.join(WORK, name)
    filelist = corpus(os.path.join(directory, 'wavs'), NBEST_UTTS)
    with open(filelist, encoding='utf-8') as f:
        texts = [ln.rstrip('\n').split('|')[1] for ln in f]
    # hypothesis 0 is the transcript, 1 drops its second word
    entries = [{'target': t, 'hyps': [t, ' '.join(
        w for k, w in enumerate(t.split()) if k != 1)]} for t in texts]
    pkl = os.path.join(directory, 'nbest.pkl')
    save_n_best(make_synthetic_n_best(entries, seed=6), pkl)
    out_dir = os.path.join(directory, 'scores')
    npy = os.path.join(directory, 'scores.npy')
    if os.path.isdir(out_dir):
        for fname in os.listdir(out_dir):
            os.unlink(os.path.join(out_dir, fname))
    module = 'gradtts_tpu_torch.cli.nbest'
    _, score_s = _cli_main(module, [
        'score', '--n-best', pkl, '--checkpoint', ckpt, '--filelist',
        filelist, '--out-dir', out_dir, *preset_args, '-N', str(NBEST_N),
        '--n-euler', str(STEPS)])
    line = {'phase': 'nbest_cli', 'preset': preset_args[1:] or 'default',
            'utterances': NBEST_UTTS, 'N': NBEST_N, 'euler_steps': STEPS,
            'score_seconds': score_s}
    if score_only:
        compile_scores(out_dir, NBEST_UTTS, NBEST_N, npy)
    else:
        # compile and rescore are host-side: in this process
        _, line['compile_seconds'] = _cli_main(module, [
            'compile', '--directory', out_dir, '-I', str(NBEST_UTTS), '-N',
            str(NBEST_N), '--out', npy])
        rescored, _ = _cli_main(module, [
            'rescore', '--n-best', pkl, '--diff-scores', npy, '-n',
            str(NBEST_N), '--weight', 'diffusion_score=-0.001'])
        line['rescored_wer'] = json.loads(rescored)['wer']
    mat = np.load(npy)
    shards = sorted(f for f in os.listdir(out_dir) if f.endswith('.json'))
    emit({**line, 'pairs_scored': len(shards), 'scores': mat.tolist()})
    require(len(shards) == NBEST_UTTS * NBEST_N,
            f'nbest_cli {name}: {len(shards)} score shards')
    require(mat.shape == (NBEST_UTTS, NBEST_N) and np.isfinite(mat).all()
            and (mat != 0).all(), f'nbest_cli {name}: a pair has no finite '
                                  'score')
    require(bool((mat[:, 0] != mat[:, 1]).all()),
            f'nbest_cli {name}: two hypotheses of one utterance scored the '
            'same')


# ---- likelihood -------------------------------------------------------------


def phase_likelihood(device, card, ckpt):
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import set_compute_dtype
    from gradtts_tpu_torch.nbest.scoring import score_batch

    cfg = get_config('ljspeech')
    model = set_compute_dtype(_seeded_model(cfg, ckpt, device),
                              torch.bfloat16)
    rng = np.random.default_rng(7)
    batch = [a.to(device) for a in _likelihood_batch(
        cfg, rng, LIK_B, LIK_TX, LIK_TY, [LIK_TY] * LIK_B)]
    gen = torch.Generator(device=device).manual_seed(0)

    def run():
        res = score_batch(model, *batch, n_euler=LIK_STEPS, generator=gen)
        torch.cuda.synchronize()
        return res

    per_call, timing = median_call(run, 2)          # a warm-up, 2 timed
    reset_counts()
    res = run()                                     # the main path's run
    counts = read_counts()
    require(counts == likelihood_counts(LIK_STEPS),
            f'likelihood: launches per call {counts}, expected '
            f'{likelihood_counts(LIK_STEPS)}')
    require(bool(torch.isfinite(res.score).all()),
            'likelihood: score not finite')
    share = _device_share(run, per_call * 1e3, 'likelihood')
    emit({'phase': 'likelihood', 'card': card, 'batch': LIK_B,
          'k1_tangent_per_call': _k1_tangent_share(device),
          'tx': LIK_TX, 'ty': LIK_TY, 'euler_steps': LIK_STEPS,
          'dtype': 'bfloat16 compute, float32 ODE state',
          'seconds_per_call': per_call, 'timing': timing,
          'hypotheses_per_s': LIK_B / per_call,
          'launches_per_call': counts, 'scores': res.score.tolist(), **share})
    return counts


def _k1_tangent_share(device):
    """Kernels and device ms of K1's forward-mode rule (its plain version
    differentiated by torch.func.jvp) over the 25 Blocks of one drift
    evaluation at the likelihood shapes, times the 10 Euler steps."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gradtts_tpu_torch.ops import groupnorm_mish as gn
    rng = np.random.default_rng(9)
    n_kernels, busy = 0, 0.0
    for (F, T, C), n_blocks, _ in LIK_LEVELS:
        x, dx = (torch.tensor(rng.standard_normal((LIK_B, F, T, C)),
                              device=device).to(torch.bfloat16)
                 for _ in range(2))
        mask = torch.ones((LIK_B, 1, T, 1), device=device,
                          dtype=torch.bfloat16)
        gamma, beta = (torch.ones(C, device=device) for _ in range(2))
        rule = gn.GroupNormMishFn.jvp
        ctx = type('Ctx', (), {'saved_tensors': (x, mask, gamma, beta),
                               'groups': 8, 'eps': 1e-5})()
        rule(ctx, dx, None, None, None)                  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rule(ctx, dx, None, None, None)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not getattr(e, 'is_user_annotation', False)]
        n_kernels += n_blocks * len(kern)
        busy += n_blocks * sum(e.time_range.elapsed_us() for e in kern) / 1e3
    return {'kernels': n_kernels * LIK_STEPS, 'device_ms': busy * LIK_STEPS}


# ---- adaptive ---------------------------------------------------------------

ADAPTIVE_TOL, ADAPTIVE_MAX_STEPS = 1e-2, 280


def phase_adaptive(device, ckpt):
    """One adaptive ``score_batch`` (B 2, Ty 256): its result, which
    phase ddp's two data ranks repeat."""
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.nbest.scoring import score_batch

    cfg = get_config('ljspeech')
    model = _seeded_model(cfg, ckpt, device)
    batch = [a.to(device) for a in _adaptive_batch(cfg)]
    t0 = time.perf_counter()
    res = score_batch(model, *batch, n_euler=0, rtol=ADAPTIVE_TOL,
                      atol=ADAPTIVE_TOL, max_steps=ADAPTIVE_MAX_STEPS,
                      generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    emit({'phase': 'adaptive', 'rtol': ADAPTIVE_TOL, 'atol': ADAPTIVE_TOL,
          'max_steps': ADAPTIVE_MAX_STEPS, 'nfe': res.nfe,
          'converged': res.converged, 'score': res.score.tolist(),
          'seconds': time.perf_counter() - t0})
    require(bool(torch.isfinite(res.score).all()),
            'adaptive: score not finite')
    return res


# ---- the samplers, the speaker set-ups and the vocoder ----------------------

# every speaker set-up of the JAX package, each at its preset's full width:
# a speaker-id table (tedlium-spk: 675 x 128), external speaker vectors
# (tedlium: 192-d) and the upstream encoder-side concat (libri-tts with
# encoder_speaker: a 192 + 64 = 256-wide encoder)
SPEAKER_SETUPS = (('tedlium-spk', {}), ('tedlium', {}),
                  ('libri-tts', {'encoder_speaker': True}))
# GPU vs CPU, f32 with TF32 off: the HiFi-GAN waveform (in [-1, 1]) passes
# ~20 cuDNN and oneDNN convolutions a sample, each ~1e-6 relative apart
VOCODER_TOL = 1e-4
# bf16 against f32 on the card: tests/test_hifigan.py's bounds
VOCODER_BF16_MAX, VOCODER_BF16_MEAN = 0.05, 5e-3


def phase_samplers_slice(device, ckpt):
    """The slice model (ljspeech, B 2, Tx 64, Ty 256, f32): 10-step
    ``stoc`` Euler with the same per-step draws on both devices, and
    10-step DPM-Solver-2M, each on the GPU against the CPU."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config

    cfg = get_config('ljspeech')
    rng = np.random.default_rng(11)
    x, x_lengths = _slice_batch(cfg, rng)
    t_y, n_feats = 256, cfg.data.n_feats
    noise = torch.from_numpy(rng.standard_normal(
        (2, t_y, n_feats)).astype(np.float32))
    draws = torch.from_numpy(rng.standard_normal(
        (STEPS, 2, t_y, n_feats)).astype(np.float32))
    line, checks = {'phase': 'samplers_slice', 'steps': STEPS}, []
    for name, kw in (('stoc_euler', {'stoc': True, 'stoc_noise': draws}),
                     ('dpm', {'sampler': 'dpm'})):
        line[name], c = _gpu_vs_cpu_synthesis(
            lambda dev: _seeded_model(cfg, ckpt, dev), device, x, x_lengths,
            t_y, f'samplers_slice {name}', noise=noise, **kw)
        checks += c
    _check(line, checks)


def _speaker_inputs(cfg, rng, bsz=2):
    """Distinct speaker ids of the table, or 192-d vectors."""
    import numpy as np
    import torch
    if cfg.n_spks > 1:
        return torch.from_numpy(rng.choice(cfg.n_spks, bsz, replace=False))
    return torch.from_numpy(rng.standard_normal(
        (bsz, cfg.spk_emb_dim)).astype(np.float32))


def phase_speakers_slice(device):
    """Each speaker set-up at its preset's full width, weights drawn from a
    seed: 10-step synthesis, compute_loss + backward (its preset's crop)
    and a 4-step score_batch with one probe, each on the GPU against the
    CPU. Returns the seeded tedlium-spk checkpoint."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import GradTTS

    spk_ckpt = None
    for k, (preset, over) in enumerate(SPEAKER_SETUPS):
        cfg = get_config(preset, **over)
        sd = seeded_state_dict(GradTTS.from_config(cfg), seed=20 + k)
        if preset == 'tedlium-spk':
            spk_ckpt = os.path.join(WORK, 'tedlium_spk_seeded.pt')
            torch.save(sd, spk_ckpt)

        def make_model(dev, cfg=cfg, sd=sd):
            model = GradTTS.from_config(cfg)
            model.load_state_dict(sd, strict=True)
            return model.to(dev).eval()

        rng = np.random.default_rng(30 + k)
        x, x_lengths = _slice_batch(cfg, rng)
        spk = _speaker_inputs(cfg, rng)
        t_y, n_feats = 256, cfg.data.n_feats
        line = {'phase': 'speakers_slice', 'preset': preset, **over,
                'n_spks': cfg.n_spks, 'spk_emb_dim': cfg.spk_emb_dim,
                'params': sum(v.numel() for v in sd.values()),
                'spk': spk.tolist() if cfg.n_spks > 1 else 'vectors'}
        noise = torch.from_numpy(rng.standard_normal(
            (2, t_y, n_feats)).astype(np.float32))
        line['synthesis'], checks = _gpu_vs_cpu_synthesis(
            make_model, device, x, x_lengths, t_y,
            f'speakers_slice {preset} synthesis', noise=noise, spk=spk)
        y = torch.from_numpy(rng.standard_normal(
            (2, t_y, n_feats)).astype(np.float32) - 5.0)
        y[1, 200:] = 0
        y_lengths = torch.tensor([t_y, 200])
        z = torch.from_numpy(rng.standard_normal(
            (2, cfg.out_size, n_feats)).astype(np.float32))
        line['loss'], c = _gpu_vs_cpu_loss(
            make_model, device, (x, x_lengths, y, y_lengths),
            f'speakers_slice {preset} loss', out_size=cfg.out_size,
            offset=torch.tensor([40, 11]), t=torch.tensor([0.3, 0.8]), z=z,
            spk=spk)
        checks += c
        eps = torch.from_numpy((rng.integers(0, 2, y.shape) * 2 - 1).astype(
            np.float32))
        line['score'], c = _gpu_vs_cpu_score(
            make_model, device, (x, x_lengths, y, y_lengths), eps,
            f'speakers_slice {preset} score', spk=spk)
        checks += c
        _check(line, checks)
    return spk_ckpt


def _seeded_vocoder():
    """The V1 generator with every weight and bias drawn from a seed."""
    from gradtts_tpu_torch.models.hifigan import Generator
    vocoder = Generator()
    vocoder.load_state_dict(seeded_state_dict(vocoder, seed=40), strict=True)
    return vocoder


def phase_vocoder_slice(device):
    """The HiFi-GAN V1 generator (512 initial channels) on B 2 x 256 frames:
    f32 on the GPU against the CPU within VOCODER_TOL, bf16 against f32 on
    the GPU within the JAX package's bf16 bounds. Returns a reference-
    layout checkpoint of it (weight_g / weight_v under 'generator')."""
    import numpy as np
    import torch

    vocoder = _seeded_vocoder().eval()
    mel = torch.from_numpy((np.random.default_rng(41).standard_normal(
        (2, 256, 80)) * 2.0 - 5.0).astype(np.float32))
    with torch.no_grad():
        t0 = time.perf_counter()
        want = vocoder(mel)
        c_s = time.perf_counter() - t0
        gpu = vocoder.to(device)
        got = gpu(mel.to(device))
        gpu.compute_dtype = torch.bfloat16
        got16 = gpu(mel.to(device)).float()
        torch.cuda.synchronize()
    err = float((got.cpu() - want).abs().max())
    d16 = (got16 - got).abs()
    line = {'phase': 'vocoder_slice', 'batch': 2, 'frames': 256,
            'samples': list(got.shape), 'f32_max_abs_err': err,
            'f32_tol': VOCODER_TOL, 'wave_max_abs': float(want.abs().max()),
            'wave_mean_abs': float(want.abs().mean()),
            'bf16_max_abs_diff': float(d16.max()),
            'bf16_mean_abs_diff': float(d16.mean()), 'cpu_s': c_s}
    emit(line)
    require(tuple(got.shape) == (2, 256 * 256) and bool(
        torch.isfinite(got).all()), 'vocoder_slice: malformed waveform')
    require(err <= VOCODER_TOL, f'vocoder_slice: f32 GPU vs CPU {err}')
    require(line['bf16_max_abs_diff'] < VOCODER_BF16_MAX
            and line['bf16_mean_abs_diff'] < VOCODER_BF16_MEAN,
            f'vocoder_slice: bf16 vs f32 {line}')
    sd = {}
    for key, w in _seeded_vocoder().state_dict().items():
        if key.endswith('.weight'):
            base = key[:-len('.weight')]
            sd[base + '.weight_v'] = w
            sd[base + '.weight_g'] = w.pow(2).sum(
                tuple(range(1, w.ndim)), keepdim=True).sqrt()
        else:
            sd[key] = w
    path = os.path.join(WORK, 'hifigan_seeded.pt')
    torch.save({'generator': sd}, path)
    return path


def _timed_synthesis(device, card, phase, preset, steps, **kw):
    """bf16 synthesis at B 8, Tx 128, Ty 768 of the seeded ``preset``:
    launches per call (counts set to 0 just before the main path's run,
    read just after), the median of 5 calls (``time_jitted``), audio-s/s
    (``Throughput``) at the preset's
    sample rate and the device share. Returns (line, run, model, counts)."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import (GradTTS, set_compute_dtype,
                                              synthesize)

    cfg = get_config(preset)
    model = GradTTS.from_config(cfg)
    model.load_state_dict(seeded_state_dict(model, seed=0), strict=True)
    model = set_compute_dtype(model.to(device).eval(), torch.bfloat16)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(1, cfg.n_vocab, (B, TX))).to(device)
    x_lengths = torch.full((B,), TX, device=device)
    spk = (torch.from_numpy(rng.integers(0, cfg.n_spks, B)).to(device)
           if cfg.n_spks > 1 else None)
    gen = torch.Generator(device=device).manual_seed(0)

    def run():
        res = synthesize(model, x, x_lengths, steps, TY, temperature=1.5,
                         generator=gen, spk=spk, **kw)
        torch.cuda.synchronize()
        return res

    per_call, timing = median_call(run, 5)          # a warm-up, 5 timed
    reset_counts()
    res = run()                                     # the main path's run
    counts = read_counts()
    want = {k: v * steps // STEPS for k, v in EXPECTED_COUNTS.items()}
    require(counts == want, f'{phase}: launches per synthesis {counts}, '
                            f'expected {want}')
    require(bool(torch.isfinite(res.decoder_outputs).all()),
            f'{phase}: mel not finite')
    tp = throughput(B * TY, B, per_call, cfg.data.sample_rate,
                    cfg.data.hop_length)
    line = {'phase': phase, 'card': card, 'preset': preset, 'batch': B,
            'tx': TX, 'ty': TY, 'steps': steps, 'dtype': 'bfloat16',
            'sample_rate': cfg.data.sample_rate,
            'seconds_per_call': per_call, 'timing': timing,
            'audio_s_per_s': tp.audio_sec_per_sec,
            'launches_per_synthesis': counts}
    return line, run, per_call, counts


def phase_dpm8(device, card):
    """bench_suite.py's dpm8: 8-step DPM-Solver-2M, ljspeech, B 8 x 768."""
    line, run, per_call, counts = _timed_synthesis(device, card, 'dpm8',
                                                   'ljspeech', 8,
                                                   sampler='dpm')
    emit({**line, **_device_share(run, per_call * 1e3, 'dpm8')})
    return counts


def phase_multispeaker(device, card):
    """bench_suite.py's multispeaker: libri-tts (247 speakers, 24 kHz), B 8
    x 768, 10-step Euler, one speaker id an item."""
    line, run, per_call, counts = _timed_synthesis(
        device, card, 'multispeaker', 'libri-tts', STEPS)
    emit({**line, **_device_share(run, per_call * 1e3, 'multispeaker')})
    return counts


def phase_waveform(device, card):
    """bench_suite.py's waveform: 50-step Euler synthesis then the V1
    vocoder, bf16, B 8 x 768 frames, per call; then the vocoder alone on
    the same shape in f32 (TF32 off) and bf16: times real time and its
    device time by kernel family (one profiled call)."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config

    cfg = get_config('ljspeech')
    vocoder = _seeded_vocoder().to(device).eval()
    vocoder.compute_dtype = torch.bfloat16
    line, run_mel, mel_s, counts = _timed_synthesis(device, card,
                                                    'waveform', 'ljspeech',
                                                    50)

    def run():
        res = run_mel()
        with torch.no_grad():
            wav = vocoder(res.decoder_outputs)
        torch.cuda.synchronize()
        return wav

    reset_counts()
    wav = run()
    require(read_counts() == counts, 'waveform: the vocoder launched a hand '
                                     'kernel')
    require(tuple(wav.shape) == (B, TY * 256)
            and bool(torch.isfinite(wav).all()), 'waveform: malformed wave')
    per_call, timing = median_call(run, 3)
    tp = throughput(B * TY, B, per_call)
    audio_s = tp.audio_seconds
    line.update(seconds_per_call=per_call, timing=timing,
                audio_s_per_s=tp.audio_sec_per_sec,
                mel_seconds_per_call=mel_s)
    mel = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (B, TY, cfg.data.n_feats)) * 2.0 - 5.0).astype(np.float32)).to(device)
    line['vocoder_alone'] = {}
    for dtype in (torch.float32, torch.bfloat16):
        vocoder.compute_dtype = dtype

        def run_voc():
            with torch.no_grad():
                out = vocoder(mel)
            torch.cuda.synchronize()
            return out

        v_s, _ = median_call(run_voc, 5)
        share = _device_share(run_voc, v_s * 1e3, 'waveform vocoder')
        line['vocoder_alone'][str(dtype).split('.')[1]] = {
            'seconds_per_call': v_s, 'x_real_time': audio_s / v_s,
            'device_busy_ms': share['device_busy_ms'],
            'device_idle_share': share['device_idle_share'],
            'device_kernels': share['device_kernels'],
            'family_ms': share['family_ms'],
            'top_device_ms': share['top_device_ms']}
    emit(line)
    return counts


# ---- train_spk -------------------------------------------------------------

SPK_CORPUS_ITEMS, SPK_TRAIN_STEPS = 32, 4


def write_speaker_corpus(directory, n_items, n_spks=675, sr=16000):
    """``n_items`` 16 kHz wavs (a sine plus noise) of bench_suite.py:143's
    ~5.5 s utterances: 344 mel frames each, and a text of the ljspeech
    training filelist whose token ids (blanks interspersed) number 129-192,
    so a batch fills the 192 x 384 bucket; their ``path|text|speaker``
    filelist, speakers drawn from the preset's 675."""
    import wave
    import numpy as np
    from gradtts_tpu_torch.text import (CMUDict, intersperse_blank,
                                        text_to_sequence)
    from gradtts_tpu_torch.text.symbols import symbols
    os.makedirs(directory, exist_ok=True)
    cmu = CMUDict(os.path.join(REPO, 'resources', 'cmu_dictionary'))
    texts = []
    with open(os.path.join(REPO, 'resources', 'filelists', 'ljspeech',
                           'train.txt'), encoding='utf-8') as f:
        for ln in f:
            text = ln.rstrip('\n').split('|')[1]
            n = len(intersperse_blank(text_to_sequence(text, dictionary=cmu),
                                      len(symbols)))
            if 128 < n <= 192:
                texts.append(text)
            if len(texts) == n_items:
                break
    rng = np.random.default_rng(12)
    lines = []
    for i, text in enumerate(texts):
        tt = np.arange(344 * HOP) / sr
        wav = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * tt)
               + 0.05 * rng.standard_normal(tt.shape))
        path = os.path.join(directory, f'{i:03d}.wav')
        with wave.open(path, 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((wav * 32767).astype('<i2').tobytes())
        lines.append(f'{path}|{text}|{int(rng.integers(0, n_spks))}')
    filelist = os.path.join(directory, 'filelist.txt')
    with open(filelist, 'w', encoding='utf-8') as f:
        f.write('\n'.join(lines) + '\n')
    return filelist


def phase_train_spk(device, card):
    """bench_suite.py's train: python -m gradtts_tpu_torch.cli.train
    --preset tedlium-spk on a synthetic speaker corpus (B 16, 128-frame
    crops, bf16 compute, f32 parameters, MAS in the loop), a few steps
    through the CLI; then the step timed in-process."""
    import shutil
    filelist = write_speaker_corpus(os.path.join(WORK, 'spk_corpus'),
                                    SPK_CORPUS_ITEMS)
    log_dir = os.path.join(WORK, 'train_spk')
    shutil.rmtree(log_dir, ignore_errors=True)
    proc, train_s = _run_cli('gradtts_tpu_torch.cli.train', [
        '--preset', 'tedlium-spk', '--log-dir', log_dir, '--max-steps',
        str(SPK_TRAIN_STEPS), '--no-previews', '--set',
        f'data.train_filelist_path={filelist}'])
    route = _input_pipeline(proc, 'train_spk')
    epochs = _train_log(log_dir, 'train_spk')
    ckpt = os.path.join(log_dir, 'ckpt', f'step_{SPK_TRAIN_STEPS:08d}.pt')
    require(os.path.exists(ckpt), f'train_spk: no {os.path.basename(ckpt)}')
    return phase_train_step(device, card, filelist, {
        'cli_steps': SPK_TRAIN_STEPS, 'cli_seconds': train_s,
        'input_pipeline': route, 'epochs': epochs}, preset='tedlium-spk',
        phase='train_spk')


# ---- mel_slice and device_mel -------------------------------------------------

MEL_TOL = 1e-4          # absolute on the log-mel: GPU vs CPU, and TF32 on/off
MEL_GRAD_TOL = 1e-3     # of the largest |d mean|mel| / dy|
# the synthesis bucket (B 8 x 768 frames) and the training one (B 16 x 1024)
MEL_BUCKETS = ((8, 768), (16, 1024))
DEVICE_MEL_TOL = 2e-3   # device against host mels (tests/test_data.py:170)


def _mel_inputs(rng, bsz, frames):
    """PCM16 audio at the padded lengths that DeviceMelCollate gives each
    utterance, zero past them ([bsz, (frames - 1) * HOP + 1024] int16),
    and the frame lengths (the first item fills the bucket)."""
    import numpy as np
    import torch
    S = (frames - 1) * HOP + 1024
    lengths = np.linspace(frames, frames // 3, bsz).astype(np.int64)
    pcm = np.zeros((bsz, S), np.int16)
    for i, n in enumerate(lengths):
        t = np.arange((n - 1) * HOP + 1024) / SR
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) \
            + 0.05 * rng.standard_normal(t.shape)
        pcm[i, :t.size] = np.round(wav * 32767)
    return torch.from_numpy(pcm), torch.from_numpy(lengths)


def phase_mel_slice(device, card):
    """The mel front end on the card against the CPU: ``mel_from_padded``
    (f32 and int16 wire, with lengths) and ``mel_spectrogram`` at the
    synthesis and training buckets, with TF32 off and on; the gradient of
    mean |mel(y)| with respect to y; the time of one call (CUDA events,
    host included)."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.data.mel import mel_from_padded, mel_spectrogram

    rng = np.random.default_rng(50)
    line, checks = {'phase': 'mel_slice', 'card': card, 'buckets': {}}, []
    for bsz, frames in MEL_BUCKETS:
        pcm, lengths = _mel_inputs(rng, bsz, frames)
        gpu_pcm, gpu_lengths = pcm.to(device), lengths.to(device)
        entry = {'samples': list(pcm.shape)}
        for wire, y, gy in (('int16', pcm, gpu_pcm),
                            ('float32', pcm.float() / 32768.0,
                             gpu_pcm.float() / 32768.0)):
            want = mel_from_padded(y, lengths)
            got = {}
            for tf32 in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                got[tf32] = mel_from_padded(gy, gpu_lengths).cpu()
            torch.backends.cuda.matmul.allow_tf32 = False
            err = float((got[False] - want).abs().max())
            tf32_diff = float((got[True] - got[False]).abs().max())
            tails = all(bool((got[False][i, n:] == 0).all())
                        for i, n in enumerate(lengths.tolist()))
            ms = cuda_ms(lambda: mel_from_padded(gy, gpu_lengths), 10)
            entry[wire] = {'max_abs_err': err, 'tf32_on_vs_off': tf32_diff,
                           'tails_zero': tails, 'ms': ms,
                           'mel_range': [float(want.min()),
                                         float(want.max())]}
            checks += [(tuple(got[False].shape) == (bsz, frames, 80),
                        f'mel_slice: shape {tuple(got[False].shape)}'),
                       (err <= MEL_TOL, f'mel_slice {bsz}x{frames} {wire}: '
                                        f'GPU vs CPU {err}'),
                       (tf32_diff <= MEL_TOL, f'mel_slice: TF32 moved the '
                                              f'mel by {tf32_diff}'),
                       (tails, 'mel_slice: a tail frame is not 0')]
        # the unpadded front end on whole utterances, and its gradient
        y = (pcm[:, 384:384 + frames * HOP].float() / 32768.0)
        want = mel_spectrogram(y)
        got = mel_spectrogram(y.to(device)).cpu()
        err = float((got - want).abs().max())
        grads = []
        for dev in (device, torch.device('cpu')):
            w = y.to(dev).requires_grad_(True)
            mel_spectrogram(w).abs().mean().backward()
            grads.append(w.grad.cpu())
        gscale = float(grads[1].abs().max())
        gerr = float((grads[0] - grads[1]).abs().max())
        entry['mel_spectrogram'] = {'max_abs_err': err,
                                    'grad_max_abs_err': gerr,
                                    'grad_max_abs': gscale}
        checks += [(tuple(got.shape) == (bsz, frames, 80),
                    f'mel_slice: mel_spectrogram shape {tuple(got.shape)}'),
                   (err <= MEL_TOL, f'mel_slice: mel_spectrogram {err}'),
                   (gscale > 0 and gerr <= MEL_GRAD_TOL * gscale,
                    f'mel_slice: gradient {gerr} of {gscale}')]
        line['buckets'][f'{bsz}x{frames}'] = entry
    line['tol'] = {'mel': MEL_TOL, 'grad_of_max': MEL_GRAD_TOL}
    _check(line, checks)


def phase_device_mel(device, card, train_rate):
    """The loader over the ``train`` corpus with host mels, device mels in
    f32 and in int16: epoch 1's batches equal in shapes, lengths and ids,
    ``y`` within DEVICE_MEL_TOL of the host mel; then the sustained feed
    rate (the best of epochs 2-3, each batch forced onto the device) beside
    the train step's own utterances/s."""
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.data.dataset import (BatchCollate, DataLoader,
                                                dataset_from_config)
    from gradtts_tpu_torch.train.loop import batch_to

    filelist = write_corpus(os.path.join(WORK, 'corpus'), CORPUS_ITEMS)
    cfg = get_config('ljspeech', **{'data.train_filelist_path': filelist})
    line = {'phase': 'device_mel', 'card': card, 'utterances': CORPUS_ITEMS,
            'batch': TRAIN_B, 'train_step_utterances_per_s': train_rate}
    first, checks = {}, []
    for name, kw in (('host', {}),
                     ('device_f32', {'device_mel': True, 'device': device}),
                     ('device_int16', {'device_mel': True, 'device': device,
                                       'mel_upload_dtype': 'int16'})):
        loader = DataLoader(dataset_from_config(cfg), TRAIN_B,
                            BatchCollate(cfg.data.x_buckets,
                                         cfg.data.y_buckets),
                            shuffle=True, seed=cfg.train.seed, **kw)
        seconds = []
        for epoch in range(3):
            t0 = time.perf_counter()
            batches = [batch_to(b, device) for b in loader]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if epoch == 0:
                first[name] = batches
        n = len(first[name]) * TRAIN_B
        line[name] = {'epoch_seconds': seconds,
                      'utterances_per_s_epoch1': n / seconds[0],
                      'utterances_per_s_sustained': n / min(seconds[1:])}
    for name in ('device_f32', 'device_int16'):
        errs = []
        for h, d in zip(first['host'], first[name]):
            checks += [(h['y'].shape == d['y'].shape and all(
                torch.equal(h[k], d[k]) for k in ('x', 'x_lengths',
                                                  'y_lengths')),
                f'device_mel {name}: shapes, lengths or ids differ')]
            errs.append(float((h['y'] - d['y']).abs().max()))
        line[name]['y_max_abs_err'] = err = max(errs, default=math.inf)
        checks.append((len(first[name]) == len(first['host'])
                       and err <= DEVICE_MEL_TOL,
                       f'device_mel {name}: y differs by {err}'))
    line['y_shapes'] = [list(b['y'].shape) for b in first['host']]
    line['tol'] = DEVICE_MEL_TOL
    _check(line, checks)


# ---- vocoder_train_slice and vocoder_train ------------------------------------

VOC_SEGMENT = 8192
VOC_SLICE_B = 2
VOC_LOSS_RTOL = 1e-4     # the seven losses, GPU vs CPU (f32, TF32 off)
VOC_GRAD_TOL = 1e-3      # of each gradient's largest value
# The GAN gradient is not continuous in its inputs: where a leaky ReLU's
# input lies within rounding of 0, the two devices may take other slopes,
# and that element's upstream gradient moves by 0.9 of itself. So the CPU
# step replays the card's slopes (slope_replay), and every element whose
# slope that flips must lie within VOC_FLIP_TOL of its call's largest
# input; f64 steps, where rounding is ~1e-16, are held without the replay.
VOC_FLIP_TOL = 1e-4
VOC_B, VOC_CORPUS_ITEMS, VOC_CLI_STEPS = 16, 32, 2


def _vocoder_batch(rng, bsz):
    """Audio segments and their input and loss mels, as VocoderMelDataset
    makes them."""
    import numpy as np
    from gradtts_tpu_torch.data.mel import mel_spectrogram_np
    t = np.arange(VOC_SEGMENT) / SR
    audio = np.stack([0.5 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
                      + 0.05 * rng.standard_normal(t.shape)
                      for _ in range(bsz)]).astype(np.float32)
    return {'mel': mel_spectrogram_np(audio), 'audio': audio,
            'mel_loss': mel_spectrogram_np(audio, fmax=SR / 2.0)}


def slope_record():
    """A torch function mode that records, call by call, which inputs of
    ``F.leaky_relu`` are > 0: the elements that take slope 1."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class SlopeRecord(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.masks = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is F.leaky_relu:
                self.masks.append(args[0].detach() > 0)
            return func(*args, **(kwargs or {}))

    return SlopeRecord()


def slope_replay(masks):
    """A torch function mode that computes ``F.leaky_relu`` with the slopes
    of ``masks`` (slope_record's, call by call) and counts the elements
    whose own slope differs (``flipped`` of ``elements``), with the largest
    such input over its call's largest (``worst_flip``)."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class SlopeReplay(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = self.flipped = self.elements = 0
            self.worst_flip = 0.0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is not F.leaky_relu:
                return func(*args, **kwargs)
            x = args[0]
            slope = args[1] if len(args) > 1 else \
                kwargs.get('negative_slope', 0.01)
            mask = masks[self.calls].to(x.device)
            self.calls += 1
            flip = (x.detach() > 0) != mask
            self.flipped += int(flip.sum())
            self.elements += x.numel()
            if flip.any():
                self.worst_flip = max(self.worst_flip, float(
                    x.detach()[flip].abs().max() / x.detach().abs().max()))
            return torch.where(mask, x, x * slope)

    return SlopeReplay()


def _gan_step_grads(cfg, device, batch, dtype=None, slopes=None):
    """One GAN step from the seeded state on ``device`` in ``dtype`` (f32
    unless given), inside the torch function mode ``slopes`` where given:
    (losses, {leaf: gradient on the CPU}, seconds)."""
    import contextlib
    import torch
    from gradtts_tpu_torch.train.vocoder import (init_vocoder_state,
                                                 make_vocoder_train_step)
    dtype = dtype or torch.float32
    state = init_vocoder_state(cfg, device, steps_per_epoch=100, seed=52)
    for module in (state.generator, state.mpd, state.msd):
        module.to(dtype)
    state.generator.compute_dtype = dtype
    batch = {k: torch.from_numpy(v).to(device, dtype)
             for k, v in batch.items()}
    t0 = time.perf_counter()
    with slopes or contextlib.nullcontext():
        metrics = make_vocoder_train_step(cfg)(state, batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    return metrics, {f'{m}.{n}': p.grad.cpu()
                     for m in ('generator', 'mpd', 'msd')
                     for n, p in getattr(state, m).named_parameters()}, \
        time.perf_counter() - t0


def grad_errors(got, want):
    """{leaf: max |got - want| over max |want|}."""
    return {k: float((got[k] - v).abs().max() / v.abs().max())
            for k, v in want.items()}


def gan_step_on_card_and_cpu(cfg, device, batch):
    """One f32 GAN step on the card (slopes recorded) and on the CPU
    (the card's slopes replayed): (card losses, CPU losses, {leaf: gradient
    error}, the replay, seconds on the card, seconds on the CPU)."""
    record = slope_record()
    g_m, g_g, g_s = _gan_step_grads(cfg, device, batch, slopes=record)
    replay = slope_replay([m.cpu() for m in record.masks])
    c_m, c_g, c_s = _gan_step_grads(cfg, 'cpu', batch, slopes=replay)
    assert replay.calls == len(record.masks), (replay.calls,
                                               len(record.masks))
    return g_m, c_m, grad_errors(g_g, c_g), replay, g_s, c_s


def phase_vocoder_train_slice(device):
    """One full GAN step of HiFi-GAN V1 with MPD and MSD at full width on
    the card against the CPU, from the same seeded weights and batch (B 2 x
    8192 samples, TF32 off): in f32, the seven losses within VOC_LOSS_RTOL
    and each gradient within VOC_GRAD_TOL of its largest value, the CPU
    taking the card's leaky-ReLU slopes, each flipped slope's input within
    VOC_FLIP_TOL of its call's largest; in f64, each gradient within
    VOC_GRAD_TOL with no replay."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.models.hifigan import HiFiGANConfig

    cfg = HiFiGANConfig()
    batch = _vocoder_batch(np.random.default_rng(51), VOC_SLICE_B)
    cpu = torch.device('cpu')
    g_m, c_m, f32, replay, g_s, c_s = gan_step_on_card_and_cpu(cfg, device,
                                                               batch)
    g64_m, g64_g, _ = _gan_step_grads(cfg, device, batch, dtype=torch.float64)
    c64_m, c64_g, c64_s = _gan_step_grads(cfg, cpu, batch,
                                          dtype=torch.float64)
    f64 = grad_errors(g64_g, c64_g)
    loss_err = {k: abs(g_m[k] - v) / abs(v) for k, v in c_m.items()}
    worst32, worst64 = (max(e, key=e.get) for e in (f32, f64))
    line = {'phase': 'vocoder_train_slice', 'batch': VOC_SLICE_B,
            'segment': VOC_SEGMENT, 'metrics_gpu': g_m, 'metrics_cpu': c_m,
            'loss_rel_err': loss_err, 'grad_leaves': len(f32),
            'f32_grad_worst': [worst32, f32[worst32]],
            'leaky_relu_calls': replay.calls,
            'leaky_relu_elements': replay.elements,
            'slopes_flipped': replay.flipped,
            'flip_input_of_max': replay.worst_flip,
            'f64_grad_worst': [worst64, f64[worst64]],
            'f64_loss_rel_err': max(abs(g64_m[k] - v) / abs(v)
                                    for k, v in c64_m.items()),
            'seconds': {'gpu_first_step': g_s, 'cpu': c_s, 'cpu_f64': c64_s},
            'tol': {'loss_rel': VOC_LOSS_RTOL, 'grad_of_max': VOC_GRAD_TOL,
                    'flip_input_of_max': VOC_FLIP_TOL}}
    _check(line, [(all(np.isfinite(v) for v in c_m.values()),
                   f'vocoder_train_slice: CPU losses {c_m}'),
                  (max(loss_err.values()) <= VOC_LOSS_RTOL,
                   f'vocoder_train_slice: losses {loss_err}'),
                  (replay.worst_flip <= VOC_FLIP_TOL,
                   f'vocoder_train_slice: a flipped slope\'s input is '
                   f'{replay.worst_flip} of its largest'),
                  (f32[worst32] <= VOC_GRAD_TOL,
                   f'vocoder_train_slice: f32 gradient {worst32} '
                   f'{f32[worst32]}'),
                  (f64[worst64] <= VOC_GRAD_TOL,
                   f'vocoder_train_slice: f64 gradient {worst64} '
                   f'{f64[worst64]}')])


def write_vocoder_corpus(directory, n_items):
    """``n_items`` 22.05 kHz wavs of 0.3-2 s (some shorter than the 8192
    sample segment) and their ``name|text`` filelist."""
    import numpy as np
    from scipy.io import wavfile
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(53)
    lines = []
    for i in range(n_items):
        t = np.arange(int(SR * (0.3 + 1.7 * i / (n_items - 1)))) / SR
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) \
            + 0.05 * rng.standard_normal(t.shape)
        wavfile.write(os.path.join(directory, f'v{i:03d}.wav'), SR,
                      (wav * 32767).astype(np.int16))
        lines.append(f'v{i:03d}|synthetic utterance {i}')
    filelist = os.path.join(directory, 'train.txt')
    with open(filelist, 'w', encoding='utf-8') as f:
        f.write('\n'.join(lines) + '\n')
    return filelist


def phase_vocoder_train(device, card, ckpt):
    """python -m gradtts_tpu_torch.cli.train_vocoder (V1, B 16, segment
    8192) on a synthetic corpus: a few steps, one resumed step, then
    cli.inference --vocoder on its checkpoint; then the GAN step timed
    in-process, f32 with TF32 off (the held setting) and on."""
    import shutil
    import numpy as np
    import torch
    from gradtts_tpu_torch.data.dataset import DataLoader
    from gradtts_tpu_torch.data.vocoder_dataset import (VocoderBatchCollate,
                                                        VocoderMelDataset,
                                                        vocoder_filelists)
    from gradtts_tpu_torch.models.hifigan import HiFiGANConfig
    from gradtts_tpu_torch.train.loop import batch_to
    from gradtts_tpu_torch.train.vocoder import (init_vocoder_state,
                                                 make_vocoder_train_step)

    wav_dir = os.path.join(WORK, 'vocoder_corpus')
    filelist = write_vocoder_corpus(wav_dir, VOC_CORPUS_ITEMS)
    log_dir = os.path.join(WORK, 'vocoder_train')
    shutil.rmtree(log_dir, ignore_errors=True)
    common = ['--input-wavs-dir', wav_dir, '--input-training-file',
              filelist, '--log-dir', log_dir, '--batch-size', str(VOC_B),
              '--epochs', '1']
    _, train_s = _run_cli('gradtts_tpu_torch.cli.train_vocoder',
                          common + ['--max-steps', str(VOC_CLI_STEPS)])
    _, resume_s = _cli_main('gradtts_tpu_torch.cli.train_vocoder',
                            common + ['--max-steps', '1'])
    epochs = _train_log(log_dir, 'vocoder_train')
    vckpt = os.path.join(log_dir, 'ckpt', f'step_{VOC_CLI_STEPS + 1:08d}.pt')
    require(os.path.exists(vckpt), 'vocoder_train: the resumed run wrote no '
                                   f'{os.path.basename(vckpt)}')
    texts = os.path.join(WORK, 'vocoder_texts.txt')
    with open(texts, 'w', encoding='utf-8') as f:
        f.write('A vocoder trained on the card.\n')
    out = os.path.join(WORK, 'vocoder_cli_out')
    _, infer_s = _cli_main('gradtts_tpu_torch.cli.inference', [
        '-f', texts, '-c', ckpt, '-o', out, '-t', str(STEPS), '--vocoder',
        vckpt])
    wav_shape = _cli_outputs(out, 1, wav=True)

    cfg = HiFiGANConfig()
    dataset = VocoderMelDataset(vocoder_filelists(filelist, filelist,
                                                  wav_dir)[0], seed=54)
    batch = batch_to(next(iter(DataLoader(dataset, VOC_B,
                                          VocoderBatchCollate(), seed=54))),
                     device)
    state = init_vocoder_state(cfg, device, steps_per_epoch=100, seed=55)
    step = make_vocoder_train_step(cfg)
    audio_s = VOC_B * VOC_SEGMENT / SR
    line = {'phase': 'vocoder_train', 'card': card, 'batch': VOC_B,
            'segment': VOC_SEGMENT, 'audio_s_per_step': audio_s,
            'cli_steps': VOC_CLI_STEPS, 'cli_seconds': train_s,
            'resume_seconds': resume_s, 'inference_seconds': infer_s,
            'inference_outputs': wav_shape, 'epochs': epochs}

    def run():
        metrics = step(state, batch)
        torch.cuda.synchronize()
        return metrics

    counts = None
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.reset_peak_memory_stats(device)
        per_step, timing = median_call(run, 5, warmup=2)
        reset_counts()
        metrics = run()                             # the main path's run
        counts = read_counts()
        require(not any(counts.values()), 'vocoder_train: the GAN step '
                                          f'launched a hand kernel {counts}')
        require(all(np.isfinite(float(v)) for v in metrics.values()),
                f'vocoder_train: losses not finite {metrics}')
        # steps queued back to back: the device's own time a step (the
        # profiler's sum of kernel times is reported beside it)
        dev_ms = device_ms(lambda: step(state, batch), reps=5)
        share = _device_share(run, per_step * 1e3, 'vocoder_train')
        line['tf32_on' if tf32 else 'tf32_off'] = {
            'seconds_per_step': per_step, 'timing': timing,
            'device_ms_per_step': dev_ms,
            'device_idle_share_queued': max(0.0, 1 - dev_ms / (per_step
                                                              * 1e3)),
            'steps_per_s': 1 / per_step,
            'audio_s_trained_per_s': throughput(
                VOC_B * VOC_SEGMENT // HOP, VOC_B,
                per_step).audio_sec_per_sec,
            'peak_memory_gib': torch.cuda.max_memory_allocated(device)
            / 2 ** 30,
            'metrics': {k: float(v) for k, v in metrics.items()},
            'device_busy_ms': share['device_busy_ms'],
            'device_idle_share': share['device_idle_share'],
            'device_kernels': share['device_kernels'],
            'family_ms': share['family_ms'],
            'top_device_ms': share['top_device_ms']}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(line)
    return counts


# ---- checkpoints, remat, previews and the generate, inference_zero and
# playground CLIs ------------------------------------------------------------


def _cli_main(module, argv):
    """``module``'s ``main(argv)`` in this process, the entry point a user
    calls, so that its launches are counted: (its standard output,
    seconds). The output is echoed; a parser error fails the phase."""
    import contextlib
    import importlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            importlib.import_module(module).main(argv)
    except SystemExit as e:
        raise SmokeFailure(f'{module} exited {e.code}') from e
    finally:
        print(buf.getvalue(), end='', flush=True)
    return buf.getvalue(), time.perf_counter() - t0


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block: two runs of the same
    weights then compare bit for bit. cuDNN's default picks for some of
    the U-Net's convolutions are not bit-repeatable (two 10-step
    syntheses part by ~3e-7 of the largest mel); the hand kernels are
    bit-repeatable either way."""
    import torch
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _texts_file():
    texts = os.path.join(WORK, 'texts.txt')
    with open(texts, 'w', encoding='utf-8') as f:
        f.write('The quick brown fox jumps over the lazy dog.\n'
                'Grad-TTS synthesizes a mel-spectrogram from text.\n'
                'It ran on the GPU in 2026.\n')
    return texts


def _mels_equal(dir_a, dir_b, names):
    """Each mel file of ``names`` in both directories, read back: whether
    all are bit-equal, and the largest difference."""
    import numpy as np
    worst, equal = 0.0, True
    for name in names:
        a, b = (np.load(os.path.join(d, name)) for d in (dir_a, dir_b))
        require(a.shape == b.shape and np.isfinite(a).all(),
                f'{dir_a}/{name}: shape {a.shape} against {b.shape}')
        equal = equal and bool((a == b).all())
        worst = max(worst, float(np.abs(a - b).max()))
    return equal, worst


def _default_cudnn_spread(device, ckpt):
    """The largest difference between two 10-step syntheses of the slice
    model on the same inputs and seed with cuDNN's default algorithms:
    the spread that ``deterministic_cudnn`` removes."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import synthesize
    cfg = get_config('ljspeech')
    model = _seeded_model(cfg, ckpt, device)
    x, x_lengths = _slice_batch(cfg, np.random.default_rng(1))
    mels = [synthesize(model, x.to(device), x_lengths.to(device), STEPS,
                       256, temperature=1.5, generator=torch.Generator(
                           device=device).manual_seed(0)).decoder_outputs
            for _ in range(2)]
    return float((mels[0] - mels[1]).abs().max())


def phase_checkpoint_slice(device, ckpt):
    """The seeded ljspeech checkpoint exported to .npz (the JAX package's
    layout) with utils.io on this machine, which has no tensorstore; then
    cli.inference -c x.npz against -c x.pt with the same seed: the same
    mels, bit for bit. Returns the launches of the .npz run."""
    import importlib.util
    import torch
    from gradtts_tpu_torch.utils.convert import (load_checkpoint,
                                                 state_dict_to_flax_params)
    from gradtts_tpu_torch.utils.io import save_params_npz

    sd = torch.load(ckpt, weights_only=True)
    npz = os.path.join(WORK, 'ljspeech_seeded.npz')
    t0 = time.perf_counter()
    save_params_npz(npz, state_dict_to_flax_params(sd))
    export_s = time.perf_counter() - t0
    back = load_checkpoint(npz)
    require(set(back) == set(sd) and all(torch.equal(back[k], sd[k])
                                         for k in sd),
            'checkpoint_slice: the .npz does not read back as the .pt')
    texts = _texts_file()
    line = {'phase': 'checkpoint_slice', 'npz_mib':
            os.path.getsize(npz) / 2 ** 20, 'export_seconds': export_s,
            'tensorstore_installed':
                importlib.util.find_spec('tensorstore') is not None,
            'tensorstore_imported': 'tensorstore' in sys.modules}
    with deterministic_cudnn():
        for name, c in (('pt', ckpt), ('npz', npz)):
            reset_counts()
            _, line[f'{name}_seconds'] = _cli_main(
                'gradtts_tpu_torch.cli.inference',
                ['-f', texts, '-c', c, '-o',
                 os.path.join(WORK, f'ckpt_{name}'), '-t', str(STEPS)])
            counts = read_counts()
    line['mels_equal'], line['mel_max_abs_diff'] = _mels_equal(
        os.path.join(WORK, 'ckpt_npz'), os.path.join(WORK, 'ckpt_pt'),
        [f'mel_{i}.npy' for i in range(3)])
    line['launches'] = counts
    line['default_cudnn_repeat_max_abs_diff'] = _default_cudnn_spread(
        device, ckpt)
    _check(line, [
        (line['mels_equal'], 'checkpoint_slice: -c x.npz and -c x.pt give '
                             'other mels'),
        (not line['tensorstore_imported'], 'checkpoint_slice: tensorstore '
                                           'was imported'),
        (counts == in_f32({k: 3 * v for k, v in EXPECTED_COUNTS.items()}),
         f'checkpoint_slice: launches {counts}')])
    return counts


# a train step with remat: the U-Net's forward twice (K1-K3), its backward
# once (K4, K5), MAS once
REMAT_COUNTS = {**TRAIN_COUNTS, 'groupnorm_mish': 50, 'attention_stats': 12,
                'attention_apply': 12}
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_TOL = 1e-5     # of each gradient's largest value
REMAT_CLI_STEPS = 3


def _train_batch(device):
    """The train cell's batch: 16 utterances of the synthetic corpus,
    collated to their buckets, on ``device``; and the preset's config."""
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.data.dataset import (BatchCollate,
                                                dataset_from_config)
    from gradtts_tpu_torch.train.loop import batch_to
    filelist = os.path.join(WORK, 'corpus', 'filelist.txt')
    cfg = get_config('ljspeech', **{'data.train_filelist_path': filelist})
    dataset = dataset_from_config(cfg)
    batch = BatchCollate(cfg.data.x_buckets, cfg.data.y_buckets)(
        [dataset[i] for i in range(TRAIN_B)])
    return cfg, filelist, batch_to(batch, device)


def phase_remat(device, card):
    """train.remat_estimator at the train cell's shape (ljspeech, B 16,
    172-frame crops, bf16 compute, f32 parameters): the losses and every
    gradient with remat against without (the same draws), then the train
    step both ways (peak memory, wall and device time, launches), then
    cli.train --set train.remat_estimator=True --no-previews for a few
    steps. Returns the launches of one remat step."""
    import shutil
    import numpy as np
    import torch
    from gradtts_tpu_torch.models.tts import (GradTTS, compute_loss,
                                              set_compute_dtype)
    from gradtts_tpu_torch.train.state import make_optimizer, train_step

    cfg, filelist, batch = _train_batch(device)
    torch.manual_seed(cfg.train.seed)
    model = GradTTS.from_config(cfg).to(device).train()
    set_compute_dtype(model, torch.bfloat16)
    rng = np.random.default_rng(9)
    offset = torch.from_numpy(rng.integers(0, 1 << 30, TRAIN_B)).to(device)
    t = torch.from_numpy(rng.uniform(0, 1, TRAIN_B).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal(
        (TRAIN_B, cfg.out_size, cfg.data.n_feats)).astype(np.float32))
    offset = offset % (batch['y_lengths'] - cfg.out_size).clamp_min(1)

    def loss_and_grads(remat):
        model.zero_grad(set_to_none=True)
        res = compute_loss(model, batch['x'], batch['x_lengths'], batch['y'],
                           batch['y_lengths'], out_size=cfg.out_size,
                           offset=offset, t=t.to(device), z=z.to(device),
                           generator=torch.Generator(
                               device=device).manual_seed(0), remat=remat)
        (res.dur_loss + res.prior_loss + res.diff_loss).backward()
        return ([float(v.detach()) for v in res[:3]],
                {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()})

    plain_losses, plain = loss_and_grads(False)
    remat_losses, remat = loss_and_grads(True)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(remat_losses,
                                                       plain_losses))
    grad_err = {n: float((remat[n] - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                for n, g in plain.items()}
    line = {'phase': 'remat', 'card': card, 'batch': TRAIN_B,
            'crop': cfg.out_size, 'y_shape': list(batch['y'].shape),
            'dtype': 'bfloat16 compute, float32 parameters',
            'losses': plain_losses, 'remat_losses': remat_losses,
            'loss_max_rel_err': loss_err, 'loss_rtol': REMAT_LOSS_RTOL,
            'losses_exact': remat_losses == plain_losses,
            'grads': len(grad_err), 'grads_exact': sum(
                bool(torch.equal(remat[n], plain[n])) for n in plain),
            'grad_max_err_of_largest': max(grad_err.values()),
            'grad_worst': max(grad_err, key=grad_err.get),
            'grad_tol': REMAT_GRAD_TOL}
    checks = [(loss_err <= REMAT_LOSS_RTOL,
               f'remat: losses {remat_losses} against {plain_losses}'),
              (line['grad_max_err_of_largest'] <= REMAT_GRAD_TOL,
               f'remat: grad {line["grad_worst"]} off by '
               f'{line["grad_max_err_of_largest"]} of its largest value')]

    optimizer = make_optimizer(model.parameters(), cfg.train.learning_rate)
    gen = torch.Generator(device=device).manual_seed(0)
    counts = {}
    for way, flag in (('plain', False), ('remat', True)):
        def run(flag=flag):
            metrics = train_step(model, optimizer, batch, cfg.out_size,
                                 cfg.train.grad_clip_norm, gen, remat=flag)
            torch.cuda.synchronize()
            return metrics

        torch.cuda.reset_peak_memory_stats(device)
        per_step, timing = median_call(run, 5, warmup=2)
        peak = torch.cuda.max_memory_allocated(device)
        reset_counts()
        metrics = run()                             # the main path's run
        counts[way] = read_counts()
        share = _device_share(run, per_step * 1e3, f'remat {way}')
        line[way] = {
            'seconds_per_step': per_step, 'timing': timing,
            'peak_memory_gib': peak / 2 ** 30,
            'device_busy_ms': share['device_busy_ms'],
            'device_idle_share': share['device_idle_share'],
            'kernel_ms': share['kernel_ms'], 'launches_per_step': counts[way],
            'metrics': {k: float(v) for k, v in metrics.items()}}
        checks.append((all(math.isfinite(v) for v in
                           line[way]['metrics'].values()),
                       f'remat: {way} step metrics not finite'))
    checks += [(counts['plain'] == TRAIN_COUNTS,
                f'remat: plain launches per step {counts["plain"]}'),
               (counts['remat'] == REMAT_COUNTS,
                f'remat: launches per step {counts["remat"]}, expected '
                f'{REMAT_COUNTS}')]

    log_dir = os.path.join(WORK, 'train_remat')
    shutil.rmtree(log_dir, ignore_errors=True)
    reset_counts()
    _, line['cli_seconds'] = _cli_main('gradtts_tpu_torch.cli.train', [
        '--preset', 'ljspeech', '--log-dir', log_dir, '--max-steps',
        str(REMAT_CLI_STEPS), '--no-previews', '--set',
        f'data.train_filelist_path={filelist}',
        'train.remat_estimator=True'])
    cli_counts = read_counts()
    line['cli_steps'], line['cli_launches'] = REMAT_CLI_STEPS, cli_counts
    line['cli_epochs'] = _train_log(log_dir, 'remat cli')
    checks.append((cli_counts == {k: REMAT_CLI_STEPS * v for k, v in
                                  REMAT_COUNTS.items()},
                   f'remat: cli.train launches {cli_counts}'))
    _check(line, checks)
    return counts['remat']


# 50 Euler steps over a budget of 8 frames a token (train/loop.py
# preview_budget) run at the CPU's pace too: short texts keep it to
# seconds an item
PREVIEW_TEXTS = ('Hello world.', 'Good morning to you.', 'It is late.',
                 'The port runs here.', 'A short one.', 'Read it back.')
PREVIEW_TOL = SLICE_TOL   # of max |mel|: GPU vs CPU, f32, TF32 off
PREVIEW_CPU_ITEMS = 1     # of the 4 preview items, synthesized again on the CPU


def phase_previews(device, ckpt):
    """train.loop.synthesis_preview at ljspeech full width (the seeded
    checkpoint, f32): the 4 items sample_test_batch picks of a synthetic
    corpus of short texts, 50 Euler steps, on the GPU, and the first
    PREVIEW_CPU_ITEMS of them on the CPU with the same noise (an item's
    preview depends on no other item). Returns the GPU run's launches."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.data.dataset import dataset_from_config
    from gradtts_tpu_torch.train.loop import preview_budget, synthesis_preview

    filelist = write_corpus(os.path.join(WORK, 'preview_corpus'),
                            len(PREVIEW_TEXTS), texts=PREVIEW_TEXTS)
    cfg = get_config('ljspeech', **{'data.train_filelist_path': filelist})
    items = dataset_from_config(cfg).sample_test_batch(cfg.train.test_size)
    rng = np.random.default_rng(10)
    noise = [torch.from_numpy(rng.standard_normal(
        (1, preview_budget(len(it['x'])), cfg.data.n_feats)).astype(
            np.float32)) for it in items]
    runs = []
    for dev, n in ((device, len(items)),
                   (torch.device('cpu'), PREVIEW_CPU_ITEMS)):
        model = _seeded_model(cfg, ckpt, dev)
        reset_counts()
        t0 = time.perf_counter()
        out = synthesis_preview(cfg, model, items[:n], 50, noise=noise[:n])
        runs.append((out, read_counts(), time.perf_counter() - t0))
    (gpu, counts, gpu_s), (cpu, cpu_counts, cpu_s) = runs
    scale = max(float(np.abs(d).max()) for _, d, _ in cpu)
    err = max(float(np.abs(g[1] - c[1]).max()) for g, c in zip(gpu, cpu))
    line = {'phase': 'previews', 'items': len(items),
            'cpu_items': PREVIEW_CPU_ITEMS, 'steps': 50,
            'tokens': [len(it['x']) for it in items],
            'budgets': [n.shape[1] for n in noise],
            'frames': [int(g[1].shape[0]) for g in gpu],
            'attn_equal': all(g[2].shape == c[2].shape
                              and bool((g[2] == c[2]).all())
                              for g, c in zip(gpu, cpu)),
            'encoder_max_abs_err': max(
                float(np.abs(g[0] - c[0]).max()) for g, c in zip(gpu, cpu)),
            'decoder_max_abs_err': err, 'decoder_max_abs': scale,
            'tol': PREVIEW_TOL * scale, 'gpu_s': gpu_s, 'cpu_s': cpu_s,
            'gpu_launches': counts}
    steps = 50 * len(items)
    _check(line, [
        (line['attn_equal'], 'previews: the alignments differ'),
        (all(np.isfinite(g[1]).all() for g in gpu) and scale > 0,
         'previews: mel not finite'),
        (err <= PREVIEW_TOL * scale,
         f'previews: decoder max abs err {err} over {PREVIEW_TOL * scale}'),
        (counts == in_f32({k: v * steps // STEPS for k, v in
                           EXPECTED_COUNTS.items()}),
         f'previews: launches {counts}'),
        (not any(cpu_counts.values()), 'previews: the CPU run launched')])
    return counts


GEN_ITEMS, GEN_BATCH = 20, 8       # batches of 8, 8 and a tail of 4
GEN_CPU_ROWS = 1                   # rows of batch 0 synthesized again on the CPU


def write_vector_corpus(directory, n_items, sr=16000):
    """The first ``n_items`` texts of the tedlium test filelist, each with a
    16 kHz wav (a sine plus noise) as long as ``write_corpus`` makes it
    (~15 characters a second, 1.5-10 s), their ``path|text`` filelist, and
    a [n_items, 192] matrix of speaker vectors (.npy). Returns (filelist,
    vectors path)."""
    import numpy as np
    with open(os.path.join(REPO, 'resources', 'filelists', 'tedlium',
                           'test.txt'), encoding='utf-8') as f:
        texts = [ln.rstrip('\n').split('|')[1] for _, ln in zip(
            range(n_items), f)]
    filelist = write_corpus(directory, n_items, texts=texts, sr=sr)
    vectors = os.path.join(directory, 'spk.npy')
    np.save(vectors, np.random.default_rng(11).standard_normal(
        (n_items, 192)).astype(np.float32))
    return filelist, vectors


def phase_generate(device, card, vocoder_ckpt):
    """python -m gradtts_tpu_torch.cli.generate on a synthetic tedlium
    test split (the first 20 texts of its test filelist, 192-d speaker
    vectors, 16 kHz wavs of 1.5-10 s) with the seeded tedlium model at
    --batch-size 8 and the seeded V1 vocoder: a wav an utterance, seconds a
    batch and audio-s/s; then the same without the vocoder, and the first
    GEN_CPU_ROWS rows of its first batch against the CPU with the same
    noise (a row's synthesis depends on no other row of its batch). Returns
    the launches of the vocoder run, the mel run's directory and the
    arguments both runs share."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    from gradtts_tpu_torch.cli.generate import frame_budget, pad_batch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.data.dataset import (BatchCollate, DataLoader,
                                                dataset_from_config)
    from gradtts_tpu_torch.models.tts import GradTTS, synthesize

    filelist, vectors = write_vector_corpus(
        os.path.join(WORK, 'gen_corpus'), GEN_ITEMS)
    sets = [f'data.test_filelist_path={filelist}',
            f'data.test_spk_path={vectors}']
    cfg = get_config('tedlium', **dict(s.split('=') for s in sets))
    ckpt = os.path.join(WORK, 'tedlium_seeded.pt')
    torch.save(seeded_state_dict(GradTTS.from_config(cfg), seed=12), ckpt)
    common = ['-c', ckpt, '--batch-size', str(GEN_BATCH), '-t', str(STEPS),
              '--set', *sets]
    wav_dir, mel_dir = (os.path.join(WORK, d) for d in ('gen_wav',
                                                        'gen_mel'))
    reset_counts()
    out, wav_s = _cli_main('gradtts_tpu_torch.cli.generate',
                           ['-o', wav_dir, '--vocoder', vocoder_ckpt, *common])
    counts = read_counts()
    batches = [dict(zip(('n', 'audio_s', 'seconds', 'audio_s_per_s'),
                        map(float, m))) for m in re.findall(
        r'batch \d+: (\d+) utterances, ([\d.]+) s of audio in ([\d.]+) s '
        r'\(([\d.]+) audio-s/s\)', out)]
    wavs = {b: sorted(os.listdir(os.path.join(wav_dir, b)))
            for b in sorted(os.listdir(wav_dir))}
    samples = []
    for b, names in wavs.items():
        for name in names:
            sr, wav = wavfile.read(os.path.join(wav_dir, b, name))
            require(sr == 16000 and wav.dtype == np.int16 and wav.size
                    and wav.size % HOP == 0, f'generate: {b}/{name}')
            samples.append(int(wav.size))
    _cli_main('gradtts_tpu_torch.cli.generate', ['-o', mel_dir, *common])

    # the first batch again, on the CPU, with the noise the CLI drew
    loader = DataLoader(dataset_from_config(cfg, 'test'), GEN_BATCH,
                        BatchCollate(cfg.data.x_buckets, cfg.data.y_buckets),
                        shuffle=True, seed=0, drop_last=False)
    batch, n_real = pad_batch(next(iter(loader)), GEN_BATCH)
    budget = frame_budget(batch)
    noise = torch.randn((GEN_BATCH, budget, cfg.data.n_feats),
                        generator=torch.Generator(device=device).manual_seed(
                            0), device=device).cpu()
    model = _seeded_model(cfg, ckpt, torch.device('cpu'))
    rows = slice(0, GEN_CPU_ROWS)
    t0 = time.perf_counter()
    res = synthesize(model, torch.from_numpy(batch['x'][rows]).long(),
                     torch.from_numpy(batch['x_lengths'][rows]).long(),
                     STEPS, budget, temperature=1.5, noise=noise[rows],
                     spk=torch.from_numpy(batch['spk'][rows]))
    cpu_s = time.perf_counter() - t0
    scale = float(res.decoder_outputs.abs().max())
    err, lengths_equal = 0.0, True
    for j in range(min(GEN_CPU_ROWS, n_real)):
        n = int(res.y_lengths[j])
        got = np.load(os.path.join(mel_dir, '0', f'{j}.npy'))
        lengths_equal = lengths_equal and got.shape[0] == n
        if got.shape[0] == n:
            err = max(err, float(np.abs(
                got - res.decoder_outputs[j, :n].numpy()).max()))
    line = {'phase': 'generate', 'card': card, 'preset': 'tedlium',
            'utterances': GEN_ITEMS, 'batch_size': GEN_BATCH,
            'steps': STEPS, 'dtype': 'float32', 'budget_batch0': budget,
            'frames_batch0': [int(n) for n in res.y_lengths],
            'cpu_rows': GEN_CPU_ROWS,
            'wavs_per_batch': {b: len(n) for b, n in wavs.items()},
            'batches': batches, 'seconds_wav_run': wav_s,
            'audio_s': sum(samples) / 16000,
            'audio_s_per_s': sum(samples) / 16000 / wav_s,
            'batch0_lengths_equal': lengths_equal,
            'batch0_max_abs_err': err, 'batch0_max_abs': scale,
            'tol': SLICE_TOL * scale, 'cpu_s': cpu_s, 'launches': counts}
    three = in_f32({k: 3 * v for k, v in EXPECTED_COUNTS.items()})
    _check(line, [
        (list(line['wavs_per_batch'].values()) == [8, 8, 4],
         f'generate: wavs per batch {line["wavs_per_batch"]}'),
        (len(batches) == 3, f'generate: {len(batches)} batch lines'),
        (lengths_equal and scale > 0, 'generate: frames differ from the '
                                      'CPU'),
        (err <= SLICE_TOL * scale,
         f'generate: batch 0 max abs err {err} over {SLICE_TOL * scale}'),
        (counts == three, f'generate: launches {counts}')])
    return counts, mel_dir, common


def _zero_reference(cfg, ckpt, device, texts, vec):
    """The mel of each text of ``texts`` as cli.inference_zero computes it,
    by ``synthesize`` called here: the same vector, inputs
    (``cli.inference.text_inputs``), temperature and generator (seeded 0,
    drawn text by text)."""
    import torch
    from gradtts_tpu_torch.cli.inference import text_inputs
    from gradtts_tpu_torch.models.tts import synthesize
    from gradtts_tpu_torch.text import CMUDict
    model = _seeded_model(cfg, ckpt, device)
    cmu = CMUDict(cfg.data.cmudict_path)
    gen = torch.Generator(device=device).manual_seed(0)
    spk = torch.from_numpy(vec[None]).to(device)
    mels = []
    with open(texts, encoding='utf-8') as f:
        for text in (ln.strip() for ln in f if ln.strip()):
            x, n_ids, budget = text_inputs(text, cmu, cfg)
            res = synthesize(model, x.to(device),
                             torch.tensor([n_ids], device=device), STEPS,
                             budget, temperature=1.5, generator=gen, spk=spk)
            mels.append(res.decoder_outputs[0, :int(res.y_lengths[0])]
                        .cpu().numpy())
    return mels


def phase_inference_zero(device, vocoder_ckpt):
    """python -m gradtts_tpu_torch.cli.inference_zero --spk-emb on the
    seeded tedlium model (phase generate's): the three texts with the
    vocoder (the wavs), then without it, each mel against synthesize called
    here with the same vector and generator. Returns the launches of the
    vocoder run."""
    import numpy as np
    from gradtts_tpu_torch.config import get_config

    cfg = get_config('tedlium')
    ckpt = os.path.join(WORK, 'tedlium_seeded.pt')
    texts = _texts_file()
    vec = np.random.default_rng(13).standard_normal(192).astype(np.float32)
    emb = os.path.join(WORK, 'spk_emb.npy')
    np.save(emb, vec)
    common = ['-f', texts, '-c', ckpt, '--spk-emb', emb, '-t', str(STEPS)]
    wav_dir, mel_dir = (os.path.join(WORK, d) for d in ('zero_wav',
                                                        'zero_mel'))
    reset_counts()
    out, wav_s = _cli_main('gradtts_tpu_torch.cli.inference_zero',
                           ['-o', wav_dir, '--vocoder', vocoder_ckpt,
                            *common])
    counts = read_counts()
    with deterministic_cudnn():
        _cli_main('gradtts_tpu_torch.cli.inference_zero', ['-o', mel_dir,
                                                           *common])
        reference = _zero_reference(cfg, ckpt, device, texts, vec)
    exact, err, scale = True, 0.0, 0.0
    for i, want in enumerate(reference):
        require(os.path.getsize(os.path.join(wav_dir, f'sample_{i}.wav'))
                > 44, f'inference_zero: sample_{i}.wav empty')
        got = np.load(os.path.join(mel_dir, f'mel_{i}.npy'))
        require(got.shape == want.shape, f'inference_zero: mel_{i} shape')
        exact = exact and bool((got == want).all())
        err = max(err, float(np.abs(got - want).max()))
        scale = max(scale, float(np.abs(want).max()))
    rtf = [float(r) for r in re.findall(r'RTF: ([\d.e-]+)', out)]
    line = {'phase': 'inference_zero', 'texts': len(reference),
            'spk_emb_dim': 192, 'rtf': rtf, 'seconds_wav_run': wav_s,
            'mels_exact': exact, 'mel_max_abs_err': err,
            'mel_max_abs': scale, 'launches': counts}
    _check(line, [
        (len(rtf) == len(reference), 'inference_zero: no RTF line a text'),
        (exact, f'inference_zero: mels off synthesize by {err}'),
        (counts == in_f32({k: len(reference) * v
                           for k, v in EXPECTED_COUNTS.items()}),
         f'inference_zero: launches {counts}')])
    return counts


PLAY_UTTERANCES, PLAY_EULER, PLAY_REPEATS = 3, 10, 3


def phase_playground(ckpt):
    """python -m gradtts_tpu_torch.cli.playground on the seeded ljspeech
    checkpoint: 3 utterances of the train corpus, 10 Euler steps, 3
    probes each: finite scores and bits per dimension, K6 and K7 in every
    drift evaluation. Returns its launches."""
    filelist = os.path.join(WORK, 'corpus', 'filelist.txt')
    reset_counts()
    out, seconds = _cli_main('gradtts_tpu_torch.cli.playground', [
        '--checkpoint', ckpt, '--filelist', filelist, '--n-utterances',
        str(PLAY_UTTERANCES), '--n-euler', str(PLAY_EULER), '--repeats',
        str(PLAY_REPEATS)])
    counts = read_counts()
    rows = [tuple(map(float, m)) for m in re.findall(
        r'utt \d+: score=(\S+) \(std (\S+) over \d+ probes\), (\S+) bpd',
        out)]
    calls = PLAY_UTTERANCES * PLAY_REPEATS
    line = {'phase': 'playground', 'utterances': PLAY_UTTERANCES,
            'euler_steps': PLAY_EULER, 'repeats': PLAY_REPEATS,
            'scores': [r[0] for r in rows], 'stds': [r[1] for r in rows],
            'bpd': [r[2] for r in rows], 'seconds': seconds,
            'seconds_per_score': seconds / calls, 'launches': counts}
    _check(line, [
        (len(rows) == PLAY_UTTERANCES and all(
            math.isfinite(v) for r in rows for v in r),
         f'playground: lines {rows}'),
        (counts == in_f32({k: calls * v for k, v in
                           likelihood_counts(PLAY_EULER).items()},
                          tangent=True),
         f'playground: launches {counts}')])
    return counts


# ---- ddp and ddp_generate: data parallelism over torch.distributed ----------

# (a) NCCL, one rank, against the plain step: the same arithmetic (a
# one-rank all_reduce is a copy), so the losses agree to f32 rounding
DDP_RTOL = 1e-6
# (b) gloo, two ranks on the one card, each B 8 of the global B 16, against
# one process on the global batch with the same draws: PERF.md section 2's
# GPU-against-CPU bounds, losses 1e-4 relative and gradients 1e-3 of the
# largest, since the ranks' convolutions and reductions run at another
# batch (cuDNN's picks, the K4/K5 and DDP sums in another order). In bf16
# (the cell) the two batch sizes round each element differently, within
# one bf16 rounding; the gradients and parameters are held in an f32 step
# (TF32 off) from the same start.
DDP2_LOSS_RTOL = 1e-4
DDP2_GRAD_TOL = 1e-3     # of the largest gradient
# Adam's first update is lr * g / (|g| + eps) (eps 1e-8): where |g| nears
# eps, a gradient difference d moves the update by up to lr * d / eps, so
# no bound of the update holds there; the parameters are held within 1e-3
# of the largest update where both gradients exceed 1e3 * eps (there the
# update moves by at most 1e-5 lr per 1e-7 of gradient difference), and
# the rest is counted and reported. Both sides round the updated parameter
# to f32, so one ulp of it (up to 1.2e-7 at |p| near 1, the largest
# update's scale) comes on top
DDP2_PARAM_TOL = 1e-3    # of the largest update of the step
ADAM_FLAT = 1e-5         # |g| below which Adam's first step amplifies rounding
DDP_GEN_TOL = 1e-4       # of each mel's largest value: generate's rows at B 4
RANK_TIMEOUT = 600


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _start_ranks(target, spec, ranks=2):
    """Starts ``ranks`` processes of :func:`rank_main` (``target``,
    ``spec``), each told its rank as torchrun tells it; returns them for
    :func:`_finish`."""
    path = os.path.join(WORK, f'{target}.json')
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(spec, f)
    env = {**os.environ, 'MASTER_ADDR': 'localhost',
           'MASTER_PORT': str(_free_port()), 'WORLD_SIZE': str(ranks)}
    code = ('import sys, chip_smoke; '
            'sys.exit(chip_smoke.rank_main(sys.argv[1], sys.argv[2]))')
    return [subprocess.Popen([sys.executable, '-c', code, target, path],
                             cwd=REPO, env={**env, 'RANK': str(r),
                                            'LOCAL_RANK': str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(ranks)]


def _finish(procs, what):
    """Waits for ``procs`` (RANK_TIMEOUT seconds), kills what is left, and
    requires each to have exited 0: their (stdout, stderr)."""
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f'{what}: process {r} exited '
                                   f'{p.returncode}:\n{err[-3000:]}')
    return outs


def _rank_lines(outs):
    """The JSON line each rank printed last."""
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def rank_main(target, spec_path):
    """One rank of a two-process phase on the one card: joins the process
    group over gloo on cuda:0 (NCCL takes no two ranks on one GPU; gloo
    carries CUDA tensors by way of the host), runs ``target`` of the spec
    in ``spec_path`` and prints its JSON line."""
    import torch
    from gradtts_tpu_torch.parallel.mesh import initialize_distributed, world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path, encoding='utf-8') as f:
        spec = json.load(f)
    initialize_distributed(device='cuda:0', backend='gloo')
    try:
        line = {'ddp_train': _rank_train_step,
                'ddp_generate': _rank_generate}[target](spec)
        emit({'rank': world()[0], **line})
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _rank_train_step(spec):
    """This rank's block of the train cell's global batch: one DDP step in
    bf16 (launches counted; metrics) and the wall time a step, then one
    f32 step from the same start (its parameters and gradients saved)."""
    import torch
    from torch.nn.parallel import DistributedDataParallel
    from gradtts_tpu_torch.parallel.mesh import make_mesh, shard_batch, world
    from gradtts_tpu_torch.train.loop import batch_to
    from gradtts_tpu_torch.train.state import make_optimizer, train_step

    device = torch.device('cuda', 0)
    mesh = make_mesh(device_type='cuda')
    line = {}
    for compute in ('bfloat16', 'float32'):
        cfg, model, glob = train_cell(spec['filelist'], device,
                                      compute=compute)
        batch = batch_to(shard_batch(mesh, glob), device)
        ddp = DistributedDataParallel(model, device_ids=[0],
                                      process_group=mesh.get_group('data'))
        optimizer = make_optimizer(model.parameters(),
                                   cfg.train.learning_rate)
        gen = torch.Generator(device=device).manual_seed(0)

        def run():
            metrics = train_step(ddp, optimizer, batch, cfg.out_size,
                                 cfg.train.grad_clip_norm, gen)
            torch.cuda.synchronize()
            return metrics

        reset_counts()
        metrics = run()                             # the compared step
        line[compute] = {'metrics': {k: float(v) for k, v in
                                     metrics.items()},
                         'launches': read_counts()}
        if compute == 'float32':
            path = os.path.join(WORK, f'ddp_rank{world()[0]}.pt')
            torch.save({'params': {k: v.cpu() for k, v in
                                   model.state_dict().items()},
                        'grads': {k: p.grad.cpu() for k, p in
                                  model.named_parameters()
                                  if p.grad is not None}}, path)
            line[compute]['saved'] = path
        else:
            line.update(x_shape=list(batch['x'].shape),
                        y_shape=list(batch['y'].shape))
            line['seconds_per_step'], line['timing'] = median_call(run, 3)
    line['tp'] = _rank_tp_step(spec, device)
    line['tp_likelihood'] = _rank_score(spec, device)
    return line


def _rank_tp_step(spec, device):
    """This rank's part of the train cell's step on a data 1 x model 2
    mesh (``shard_model``, DDP over the one-rank 'data' axis), the whole
    global batch on both ranks, the same draws as one process: a bf16 step
    (launches counted; metrics, peak memory over what the process held
    before, parameter and Adam elements) and the wall time a step, then an
    f32 step from the same start (its blocks and gradients saved)."""
    import gc
    import torch
    from torch.nn.parallel import DistributedDataParallel
    from gradtts_tpu_torch.parallel.mesh import (make_mesh, shard_batch,
                                                 shard_model, world)
    from gradtts_tpu_torch.parallel.tensor import split_parameters
    from gradtts_tpu_torch.train.loop import batch_to
    from gradtts_tpu_torch.train.state import make_optimizer, train_step

    mesh = make_mesh(1, TP_MODEL, device_type='cuda')
    line = {'coord': [mesh.get_local_rank(a) for a in ('data', 'model')]}
    for compute in ('bfloat16', 'float32'):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        cfg, model, glob = train_cell(spec['filelist'], device,
                                      compute=compute)
        shard_model(model, mesh)
        batch = batch_to(shard_batch(mesh, glob), device)
        ddp = DistributedDataParallel(model, device_ids=[0],
                                      process_group=mesh.get_group('data'))
        optimizer = make_optimizer(model.parameters(),
                                   cfg.train.learning_rate)
        gen = torch.Generator(device=device).manual_seed(0)

        def run():
            metrics = train_step(ddp, optimizer, batch, cfg.out_size,
                                 cfg.train.grad_clip_norm, gen)
            torch.cuda.synchronize()
            return metrics

        reset_counts()
        metrics = run()                             # the compared step
        entry = {
            'metrics': {k: float(v) for k, v in metrics.items()},
            'launches': read_counts(),
            'peak_bytes': torch.cuda.max_memory_allocated(device) - base,
            'split_tensors': len(split_parameters(model)),
            'parameter_elements': sum(p.numel() for p in model.parameters()),
            'adam_elements': sum(st[k].numel()
                                 for st in optimizer.state.values()
                                 for k in ('exp_avg', 'exp_avg_sq'))}
        if compute == 'float32':
            path = os.path.join(WORK, f'tp_rank{world()[0]}.pt')
            torch.save({'params': {k: v.cpu() for k, v in
                                   model.state_dict().items()},
                        'grads': {k: p.grad.cpu() for k, p in
                                  model.named_parameters()
                                  if p.grad is not None}}, path)
            entry['saved'] = path
        else:
            entry['seconds_per_step'], entry['timing'] = median_call(run, 1)
        line[compute] = entry
        del ddp, model, optimizer, batch
    return line


def _lik_mesh_batch(cfg):
    """The likelihood cell's global batch (phase likelihood's)."""
    import numpy as np
    return _likelihood_batch(cfg, np.random.default_rng(7), LIK_B, LIK_TX,
                             LIK_TY, [LIK_TY] * LIK_B)


def _adaptive_batch(cfg):
    """Phase adaptive's batch: B 2, Tx 64, Ty 256, the second row 200
    frames long."""
    import numpy as np
    return _likelihood_batch(cfg, np.random.default_rng(8), 2, 64, 256,
                             [256, 200])


def _score_fields(res):
    return {k: getattr(res, k) for k in ('score', 'prior_logp',
                                         'delta_logp', 'z', 'nfe',
                                         'converged')}


def _rank_score(spec, device):
    """``score_batch`` of the likelihood cell (ljspeech at full width,
    B 8, Tx 128, Ty 512, LIK_MESH_STEPS Euler steps) on a data 1 x model 2
    mesh (``shard_model``; the whole batch on both ranks) and on a data 2
    x model 1 mesh (B 4 a rank), each in bf16 and f32 with the probe drawn
    at the global shape from one seeded generator (``RowShard``); then the
    adaptive integrator on the data 2 mesh at phase adaptive's shape,
    tolerances and probe (one row a rank). Each mesh's first call is a
    bf16 warm-up, untimed and uncounted: a process's first forward-mode
    call pays first-use costs that would swamp the timed one. One model a
    mesh (the compute dtype set a run). Each run's launches counted, its
    wall seconds and peak memory over what the process held before it
    (the model's parameters included); its results saved."""
    import gc
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.layers import RowShard
    from gradtts_tpu_torch.models.tts import set_compute_dtype
    from gradtts_tpu_torch.nbest.scoring import score_batch
    from gradtts_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                 shard_model, world)

    cfg = get_config('ljspeech')
    line = {}

    def run(name, model, mesh, batch, compute, seed, warmup=False, **kw):
        set_compute_dtype(model, getattr(torch, compute))

        def call():
            gen = RowShard(torch.Generator(device=device).manual_seed(seed),
                           mesh.get_local_rank('data'), mesh.size(0))
            return score_batch(model, *batch, mesh=mesh, generator=gen,
                               **kw)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        if warmup:
            call()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        path = os.path.join(WORK, f'lik_{name}_{compute}_rank{world()[0]}.pt')
        torch.save({k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in _score_fields(res).items()}, path)
        return {'launches': read_counts(), 'seconds': seconds,
                'peak_bytes': torch.cuda.max_memory_allocated(device) - base,
                'saved': path}

    for name, shape in (('tp', (1, TP_MODEL)), ('dp', (TP_MODEL, 1))):
        mesh = make_mesh(*shape, device_type='cuda')
        rows = batch_sharding(mesh)
        batch = [rows(a).to(device) for a in _lik_mesh_batch(cfg)]
        model = shard_model(_seeded_model(cfg, spec['ckpt'], device), mesh)
        line[name] = {'coord': [mesh.get_local_rank(a)
                                for a in ('data', 'model')]}
        for compute in ('bfloat16', 'float32'):
            line[name][compute] = run(name, model, mesh, batch, compute,
                                      LIK_MESH_SEED,
                                      warmup=compute == 'bfloat16',
                                      n_euler=LIK_MESH_STEPS)
    # the data 2 mesh's model in f32: phase adaptive's call, a row a rank
    batch = [rows(a).to(device) for a in _adaptive_batch(cfg)]
    line['adaptive'] = run('adaptive', model, mesh, batch, 'float32', 0,
                           n_euler=0, rtol=ADAPTIVE_TOL, atol=ADAPTIVE_TOL,
                           max_steps=ADAPTIVE_MAX_STEPS)
    return line


def _rank_generate(spec):
    """``cli.generate`` in this process with the spec's argv (launches
    counted)."""
    reset_counts()
    _, seconds = _cli_main('gradtts_tpu_torch.cli.generate', spec['argv'])
    return {'launches': read_counts(), 'seconds': seconds}


def _one_process_step(filelist, device, compute):
    """The train cell's step on the global batch in this process, the same
    draws as the ranks': (metrics, the parameters before and after, the
    gradients, the step's peak memory over what the process held before,
    the parameters' copy left out)."""
    import torch
    from gradtts_tpu_torch.train.loop import batch_to
    from gradtts_tpu_torch.train.state import make_optimizer, train_step
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    cfg, model, glob = train_cell(filelist, device, compute=compute)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    base += sum(v.numel() * v.element_size() for v in before.values())
    optimizer = make_optimizer(model.parameters(), cfg.train.learning_rate)
    metrics = train_step(model, optimizer, batch_to(glob, device),
                         cfg.out_size, cfg.train.grad_clip_norm,
                         torch.Generator(device=device).manual_seed(0))
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    return ({k: float(v) for k, v in metrics.items()}, before,
            model.state_dict(), grads,
            torch.cuda.max_memory_allocated(device) - base)


def _held_to_one_process(saved, before, want, grads, device):
    """The f32 ranks' gradients and parameters against one process's: the
    gradients' worst difference of the largest; the parameters' worst
    difference where both gradients exceed ADAM_FLAT, and the same less one
    f32 epsilon of the parameter (its rounding); the largest update; the
    elements below ADAM_FLAT (their count, worst difference)."""
    import torch
    scale = max(float(g.abs().max()) for g in grads.values())
    grad_err = param_err = beyond_ulp = largest = flat_err = 0.0
    flat = 0
    ulp = torch.finfo(torch.float32).eps
    for k, w in want.items():
        got = saved['params'][k].to(device)
        update = (w - before[k]).abs()
        largest = max(largest, float(update.max()))
        steady = torch.ones_like(w, dtype=torch.bool)
        if k in grads:
            g, h = grads[k], saved['grads'][k].to(device)
            grad_err = max(grad_err, float((h - g).abs().max()) / scale)
            steady = (g.abs() >= ADAM_FLAT) & (h.abs() >= ADAM_FLAT)
        diff = (got - w).abs()
        if bool(steady.any()):
            param_err = max(param_err, float(diff[steady].max()))
            beyond_ulp = max(beyond_ulp, float(
                (diff - ulp * w.abs())[steady].max()))
        if not bool(steady.all()):
            flat += int((~steady).sum())
            flat_err = max(flat_err, float(diff[~steady].max()))
    return {'grad_max_err_of_largest': grad_err, 'param_max_err': param_err,
            'param_max_err_beyond_ulp': beyond_ulp,
            'largest_update': largest, 'flat_elements': flat,
            'flat_param_max_err': flat_err}


def phase_ddp(device, card, ckpt, beside):
    """Data-parallel training of the train cell (ljspeech at full width,
    bf16 compute, f32 parameters, 172-frame crops; the train phase's
    corpus). (a) NCCL, one rank: ``torchrun --standalone --nproc-per-node
    1 -m gradtts_tpu_torch.cli.train --mesh-data 1`` for TRAIN_STEPS
    steps against the train phase's plain ``cli.train`` (its checkpoint
    at the same step, and its log); then in this process the DDP step
    against the plain step on one batch (metrics within DDP_RTOL; wall
    and device ms of both). (b) gloo, two ranks on cuda:0, one step on the
    global B 16 against this process's step on it with the same draws:
    bf16 losses, f32 losses, gradients and parameters, the ranks'
    parameters bit-equal, launches a rank and wall s a step. The torchrun
    run and the two ranks run at once, before the in-process timing; the
    ranks then run the tp step (:func:`_rank_tp_step`, held in
    :func:`_tp_held`), and score the likelihood cell on two meshes
    (:func:`_rank_score`, held in :func:`_lik_mesh_held` against this
    process, ``ckpt`` its weights). While the subprocesses work, this
    process runs ``beside()``, which returns phase adaptive's result
    (the ranks' adaptive run is held to it); a failure there stops the
    subprocesses. Returns the launches of the in-process DDP step, of the
    tp step's two ranks, and of the ranks' bf16 scoring on the data 1 x
    model 2 and the data 2 x model 1 mesh."""
    import shutil
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel
    from gradtts_tpu_torch.parallel.mesh import (initialize_distributed,
                                                 make_mesh)
    from gradtts_tpu_torch.train.loop import batch_to
    from gradtts_tpu_torch.train.state import make_optimizer, train_step

    filelist = os.path.join(WORK, 'corpus', 'filelist.txt')
    plain_dir = os.path.join(WORK, 'train')
    ckpt_name = os.path.join('ckpt', f'step_{TRAIN_STEPS:08d}.pt')
    require(os.path.exists(os.path.join(plain_dir, ckpt_name)),
            'ddp: the train phase left no plain checkpoint')
    log_dir = os.path.join(WORK, 'ddp_train')
    shutil.rmtree(log_dir, ignore_errors=True)
    t0 = time.perf_counter()
    torchrun = subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc-per-node', '1', '-m', 'gradtts_tpu_torch.cli.train',
         '--mesh-data', '1', '--preset', 'ljspeech', '--log-dir', log_dir,
         '--no-previews', '--max-steps', str(TRAIN_STEPS), '--set',
         f'data.train_filelist_path={filelist}'], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = _start_ranks('ddp_train', {'filelist': filelist,
                                       'ckpt': ckpt})

    def finish(procs, what):
        return _finish(procs, what), time.perf_counter() - t0

    # threads drain the subprocesses' pipes while this process works
    pool = concurrent.futures.ThreadPoolExecutor(2)
    waits = [pool.submit(finish, [torchrun], 'ddp: torchrun cli.train'),
             pool.submit(finish, ranks, 'ddp: gloo ranks')]
    try:
        adaptive = beside()
        beside_s = time.perf_counter() - t0
    except BaseException:
        for proc in (torchrun, *ranks):
            proc.kill()
        raise
    finally:
        pool.shutdown()
    ((_, err),), torchrun_s = waits[0].result()
    ranks, ranks_s = waits[1].result()
    ranks = _rank_lines(ranks)

    # (a) torchrun: the plain run's checkpoint and log
    route = re.search(r'input pipeline: (\w+) mels', err)
    got = torch.load(os.path.join(log_dir, ckpt_name), weights_only=True)
    want = torch.load(os.path.join(plain_dir, ckpt_name), weights_only=True)
    ckpt_err = max(float((got['model'][k] - w).abs().max())
                   / max(float(w.abs().max()), 1e-30)
                   for k, w in want['model'].items())
    logged, plain_logged = (_train_log(d, 'ddp')[0]
                            for d in (log_dir, plain_dir))
    # train.log keeps 4 decimals, as the JAX package's: equal within
    # DDP_RTOL and the log's rounding
    log_err = max(abs(logged[k] - v) - DDP_RTOL * abs(v)
                  for k, v in plain_logged.items())
    line = {'phase': 'ddp', 'card': card, 'preset': 'ljspeech',
            'batch': TRAIN_B, 'crop': 172,
            'dtype': 'bfloat16 compute, float32 parameters',
            'seconds_torchrun': torchrun_s, 'seconds_ranks': ranks_s,
            'seconds_beside': beside_s,
            'nccl_one_rank': {
                'steps': TRAIN_STEPS,
                'input_pipeline': route.group(0) if route else None,
                'distributed_line': 'distributed: process 0/1' in err,
                'ddp_line': 'data parallel: rank 0 of 1' in err,
                'logged': logged, 'plain_logged': plain_logged,
                'checkpoint_max_err_of_largest': ckpt_err}}
    checks = [(line['nccl_one_rank']['distributed_line']
               and line['nccl_one_rank']['ddp_line'],
               'ddp: torchrun cli.train did not join a process group'),
              (route is not None and route.group(1) == 'device',
               'ddp: torchrun cli.train took no device mels'),
              (log_err <= 0.5e-4, f'ddp: logged {logged} against the plain '
                                  f'run\'s {plain_logged}'),
              (ckpt_err <= DDP_RTOL, f'ddp: the checkpoint parts from the '
                                     f'plain run\'s by {ckpt_err}')]

    # (a) in this process: one NCCL rank, the DDP step beside the plain one
    initialize_distributed(f'localhost:{_free_port()}', 1, 0,
                           device=device)
    try:
        cfg, plain, glob = train_cell(filelist, device)
        _, model, _ = train_cell(filelist, device)
        batch = batch_to(glob, device)
        mesh = make_mesh(device_type='cuda')
        ddp = DistributedDataParallel(
            model, device_ids=[torch.cuda.current_device()],
            process_group=mesh.get_group('data'))
        steps = {}
        for way, net, params in (('ddp', ddp, model.parameters()),
                                 ('plain', plain, plain.parameters())):
            optimizer = make_optimizer(params, cfg.train.learning_rate)
            gen = torch.Generator(device=device).manual_seed(0)

            def run(net=net, optimizer=optimizer, gen=gen):
                metrics = train_step(net, optimizer, batch, cfg.out_size,
                                     cfg.train.grad_clip_norm, gen)
                torch.cuda.synchronize()
                return metrics

            reset_counts()
            metrics = run()                         # the main path's run
            counts = read_counts()
            per_step, timing = median_call(run, 5, warmup=2)
            share = _device_share(run, per_step * 1e3, f'ddp {way}')
            steps[way] = {'metrics': {k: float(v) for k, v in
                                      metrics.items()},
                          'launches': counts, 'seconds_per_step': per_step,
                          'timing': timing,
                          'device_busy_ms': share['device_busy_ms'],
                          'device_idle_share': share['device_idle_share'],
                          'device_kernels': share['device_kernels'],
                          'kernel_ms': share['kernel_ms']}
        ddp_counts = steps['ddp']['launches']
    finally:
        dist.destroy_process_group()
    rel = max(abs(steps['ddp']['metrics'][k] - v) / abs(v)
              for k, v in steps['plain']['metrics'].items())
    line['in_process'] = {**steps, 'metrics_max_rel_err': rel}
    checks += [(rel <= DDP_RTOL, f'ddp: the DDP step\'s metrics part from '
                                 f'the plain step\'s by {rel}'),
               (ddp_counts == TRAIN_COUNTS,
                f'ddp: launches per DDP step {ddp_counts}')]

    # (b) gloo, two ranks on the one card, against one process
    gloo = {'ranks': [{k: v for k, v in r.items() if k != 'tp'}
                      for r in ranks]}
    one = {}
    for compute in ('bfloat16', 'float32'):
        one[compute] = _one_process_step(filelist, device, compute)
        want_metrics, before, want, grads, _ = one[compute]
        got = ranks[0][compute]['metrics']
        gloo[compute] = {'one_process_metrics': want_metrics,
                         'loss_max_rel_err': max(
                             abs(got[k] - v) / abs(v) for k, v in
                             want_metrics.items() if k.startswith('loss'))}
        checks += [
            (gloo[compute]['loss_max_rel_err'] <= DDP2_LOSS_RTOL,
             f'ddp: two ranks\' {compute} losses part from one '
             f'process\'s by {gloo[compute]["loss_max_rel_err"]}'),
            (got == ranks[1][compute]['metrics'],
             f'ddp: the two ranks report different {compute} metrics'),
            (all(r[compute]['launches'] == (
                TRAIN_COUNTS if compute == 'bfloat16'
                else in_f32(TRAIN_COUNTS)) for r in ranks),
             f'ddp: {compute} launches a rank '
             f'{[r[compute]["launches"] for r in ranks]}')]
    saved = [torch.load(r['float32']['saved'], weights_only=True)
             for r in ranks]
    equal = all(torch.equal(saved[0][part][k], saved[1][part][k])
                for part in ('params', 'grads') for k in saved[0][part])
    held = _held_to_one_process(saved[0], before, want, grads, device)
    gloo['float32'].update(held, ranks_bit_equal=equal)
    line['gloo_two_ranks'] = gloo
    checks += [
        (equal, 'ddp: the two ranks hold different parameters'),
        (held['grad_max_err_of_largest'] <= DDP2_GRAD_TOL,
         f'ddp: two ranks\' gradients part from one process\'s by '
         f'{held["grad_max_err_of_largest"]} of the largest'),
        (held['param_max_err_beyond_ulp']
         <= DDP2_PARAM_TOL * held['largest_update'],
         f'ddp: two ranks\' parameters part from one process\'s by '
         f'{held["param_max_err_beyond_ulp"]} beyond their rounding, of a '
         f'largest update {held["largest_update"]}')]
    _check(line, checks)
    return (ddp_counts, _tp_held(card, [r['tp'] for r in ranks], one, device),
            *_lik_mesh_held(card, [r['tp_likelihood'] for r in ranks],
                            device, ckpt, adaptive))


def _lik_mesh_held(card, ranks, device, ckpt, adaptive):
    """The tp_likelihood line: each rank's scores on the data 1 x model 2
    and the data 2 x model 1 mesh against its rows of this process's
    ``score_batch`` on the global batch with the same probe (computed here
    once, bf16 and f32), at LIK_MESH_RTOL; the two model ranks against each
    other; the adaptive run against ``adaptive``. Returns the bf16 runs'
    launches over both ranks, model 2 then data 2."""
    import torch
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.models.tts import set_compute_dtype
    from gradtts_tpu_torch.nbest.scoring import score_batch

    cfg = get_config('ljspeech')
    batch = [a.to(device) for a in _lik_mesh_batch(cfg)]
    line = {'phase': 'tp_likelihood', 'card': card, 'preset': 'ljspeech',
            'batch': LIK_B, 'tx': LIK_TX, 'ty': LIK_TY,
            'euler_steps': LIK_MESH_STEPS, 'ranks': ranks}
    checks = []
    want = {}
    for compute in ('bfloat16', 'float32'):
        model = set_compute_dtype(_seeded_model(cfg, ckpt, device),
                                  getattr(torch, compute))
        t0 = time.perf_counter()
        want[compute] = _score_fields(score_batch(
            model, *batch, n_euler=LIK_MESH_STEPS,
            generator=torch.Generator(device=device).manual_seed(
                LIK_MESH_SEED)))
        torch.cuda.synchronize()
        line[f'one_process_{compute}_seconds'] = time.perf_counter() - t0
    expected = likelihood_counts(LIK_MESH_STEPS)
    for name in ('tp', 'dp'):
        for compute in ('bfloat16', 'float32'):
            tol, w = LIK_MESH_RTOL[compute], want[compute]
            launches = expected if compute == 'bfloat16' else in_f32(
                expected, CONVS_SPLIT if name == 'tp' else CONVS_WHOLE,
                tangent=True)
            got = [torch.load(r[name][compute]['saved'], weights_only=True)
                   for r in ranks]
            n = LIK_B // (TP_MODEL if name == 'dp' else 1)
            errs = []
            for r, g in zip(ranks, got):
                i = r[name]['coord'][0]
                errs.append(_score_err(g, w, slice(i * n, (i + 1) * n)))
            entry = {'max_rel_err': {k: max(e[k] for e in errs)
                                     for k in errs[0]},
                     'launches': [r[name][compute]['launches']
                                  for r in ranks],
                     'seconds': [r[name][compute]['seconds'] for r in ranks],
                     'peak_bytes': [r[name][compute]['peak_bytes']
                                    for r in ranks],
                     'scores': [g['score'].tolist() for g in got],
                     'one_process_scores': w['score'].tolist()}
            what = f'tp_likelihood {name} {compute}'
            z_tol = LIK_MESH_Z_TOL[compute]
            checks += [
                (all(bool(torch.isfinite(g[k]).all()) for g in got
                     for k in ('score', 'z')), f'{what}: not finite'),
                (_within(entry['max_rel_err'], tol, z_tol),
                 f'{what}: the ranks part from one process by '
                 f'{entry["max_rel_err"]} (bounds {tol}, z {z_tol})'),
                (all(c == launches for c in entry['launches']),
                 f'{what}: launches a rank {entry["launches"]}')]
            if name == 'tp':
                # both model ranks score the whole batch
                gap = _score_err(got[1], got[0], slice(None))
                entry.update(model_ranks_bit_equal=all(
                    torch.equal(got[0][k], got[1][k])
                    for k in ('score', 'prior_logp', 'delta_logp', 'z')),
                    model_ranks_max_rel_err=gap)
                checks.append((_within(gap, tol, z_tol),
                               f'{what}: the model ranks part by {gap}'))
            line[f'{name} {compute}'] = entry
    got = [torch.load(r['adaptive']['saved'], weights_only=True)
           for r in ranks]
    w = _score_fields(adaptive)
    errs = [_score_err(g, w, slice(i, i + 1), with_z=False)
            for i, g in enumerate(got)]
    line['adaptive'] = {
        'rtol': ADAPTIVE_TOL, 'max_steps': ADAPTIVE_MAX_STEPS,
        'nfe': [g['nfe'] for g in got], 'one_process_nfe': adaptive.nfe,
        'converged': [g['converged'] for g in got],
        'max_rel_err': {k: max(e[k] for e in errs) for k in errs[0]},
        'seconds': [r['adaptive']['seconds'] for r in ranks],
        'launches': [r['adaptive']['launches'] for r in ranks]}
    checks += [
        (all((g['nfe'], g['converged']) == (adaptive.nfe, adaptive.converged)
             for g in got), 'tp_likelihood adaptive: nfe and converged '
                            f'{line["adaptive"]["nfe"]} '
                            f'{line["adaptive"]["converged"]} against one '
                            f'process\'s {adaptive.nfe} {adaptive.converged}'),
        (max(line['adaptive']['max_rel_err'].values()) <= LIK_SLICE_RTOL,
         'tp_likelihood adaptive: the ranks part from one process by '
         f'{line["adaptive"]["max_rel_err"]}')]
    _check(line, checks)
    return ({k: sum(r[name]['bfloat16']['launches'][k] for r in ranks)
             for k in TRAIN_COUNTS} for name in ('tp', 'dp'))


def _within(errs, tol, z_tol):
    """``_score_err``'s errors within ``tol``, z within ``z_tol``."""
    return all(v <= (z_tol if k == 'z' else tol) for k, v in errs.items())


def _score_err(got, want, rows, with_z=True):
    """A rank's scoring fields (on the host) against ``rows`` of
    ``want``'s: the largest relative difference of score, prior_logp and
    delta_logp, and (``with_z``) of z against the largest |z| of
    ``want``."""
    out = {}
    for k in ('score', 'prior_logp', 'delta_logp'):
        w = want[k][rows].cpu()
        out[k] = float(((got[k] - w).abs() / w.abs()).max())
    if with_z:
        out['z'] = float((got['z'] - want['z'][rows].cpu()).abs().max()
                         / want['z'].abs().max().cpu())
    return out


def _tp_held(card, ranks, one, device):
    """The tp line: the two ranks' step on the data 1 x model 2 mesh
    against this process's step on the same batch (``one``: compute ->
    :func:`_one_process_step`'s result), at phase ddp's two-rank bounds.
    Returns the launches of both ranks."""
    import torch
    from gradtts_tpu_torch.parallel.mesh import split_dim
    from gradtts_tpu_torch.utils.convert import (gather_state_dict,
                                                 shard_state_dict)
    ranks = sorted(ranks, key=lambda r: r['coord'][1])
    line = {'phase': 'tp', 'card': card, 'preset': 'ljspeech',
            'batch': TRAIN_B, 'crop': 172, 'mesh': [1, TP_MODEL],
            'dtype': 'bfloat16 compute, float32 parameters',
            'ranks': ranks}
    checks = []
    for compute in ('bfloat16', 'float32'):
        want_metrics, _, _, _, plain_peak = one[compute]
        got = ranks[0][compute]['metrics']
        rel = {k: abs(got[k] - v) / abs(v) for k, v in want_metrics.items()}
        line[compute] = {
            'one_process_metrics': want_metrics,
            'loss_max_rel_err': max(v for k, v in rel.items()
                                    if k.startswith('loss')),
            'grad_norm_max_rel_err': max(v for k, v in rel.items()
                                         if k.startswith('grad_norm')),
            'one_process_peak_bytes': plain_peak,
            'peak_over_one_process': [r[compute]['peak_bytes'] / plain_peak
                                      for r in ranks]}
        checks += [
            (line[compute]['loss_max_rel_err'] <= DDP2_LOSS_RTOL,
             f'tp: {compute} losses part from one process\'s by '
             f'{line[compute]["loss_max_rel_err"]}'),
            (got == ranks[1][compute]['metrics'],
             f'tp: the two ranks report different {compute} metrics'),
            (all(r[compute]['launches'] == (
                TRAIN_COUNTS if compute == 'bfloat16'
                else in_f32(TRAIN_COUNTS, CONVS_SPLIT)) for r in ranks),
             f'tp: {compute} launches a rank '
             f'{[r[compute]["launches"] for r in ranks]}')]
    _, before, want, grads, _ = one['float32']
    checks.append((line['float32']['grad_norm_max_rel_err']
                   <= DDP2_LOSS_RTOL,
                   f'tp: f32 clip norms part from one process\'s by '
                   f'{line["float32"]["grad_norm_max_rel_err"]}'))
    # each rank holds its blocks of the split tensors, the rest whole
    elements = sum(w.numel() // (TP_MODEL if split_dim(k, w.shape, TP_MODEL)
                                 is not None else 1) for k, w in want.items())
    n_split = sum(split_dim(k, w.shape, TP_MODEL) is not None
                  for k, w in want.items())
    saved = [torch.load(r['float32']['saved'], weights_only=True)
             for r in ranks]
    shapes = all({k: v.shape for k, v in s['params'].items()}
                 == {k: v.shape for k, v in shard_state_dict(
                     want, j, TP_MODEL).items()}
                 for j, s in enumerate(saved))
    replicated = [k for k, w in want.items()
                  if split_dim(k, w.shape, TP_MODEL) is None]
    differ = [f'{part} {k}' for part in ('params', 'grads')
              for k in replicated if k in saved[0][part]
              and not torch.equal(saved[0][part][k], saved[1][part][k])]
    equal = not differ
    held = _held_to_one_process(
        {part: gather_state_dict([s[part] for s in saved])
         for part in ('params', 'grads')}, before, want, grads, device)
    line['float32'].update(held, replicated_bit_equal=equal,
                           replicated_differing=differ[:10],
                           blocks_shaped=shapes)
    line.update(split_tensors=n_split, elements_a_rank=elements,
                one_process_elements=sum(w.numel() for w in want.values()))
    checks += [
        (shapes, 'tp: a rank holds other than its blocks'),
        (equal, 'tp: the ranks hold different replicated parameters'),
        (all(r[c]['split_tensors'] == n_split
             and r[c]['parameter_elements'] == elements
             and r[c]['adam_elements'] == 2 * elements
             for r in ranks for c in ('bfloat16', 'float32')),
         'tp: parameter and Adam elements a rank ' + str(
             [(r['float32']['parameter_elements'],
               r['float32']['adam_elements']) for r in ranks])
         + f', expected {elements} and twice that'),
        (held['grad_max_err_of_largest'] <= DDP2_GRAD_TOL,
         f'tp: gradients part from one process\'s by '
         f'{held["grad_max_err_of_largest"]} of the largest'),
        (held['param_max_err_beyond_ulp']
         <= DDP2_PARAM_TOL * held['largest_update'],
         f'tp: parameters part from one process\'s by '
         f'{held["param_max_err_beyond_ulp"]} beyond their rounding, of a '
         f'largest update {held["largest_update"]}')]
    _check(line, checks)
    return {k: sum(r['bfloat16']['launches'][k] for r in ranks)
            for k in TRAIN_COUNTS}


def phase_ddp_generate(card, mel_dir, common):
    """``cli.generate --mesh-data 2`` (two processes on cuda:0 over gloo,
    B 4 a rank) on the generate phase's split, without the vocoder,
    against its ``--mesh-data 1`` run: the same files, each mel within
    DDP_GEN_TOL of its largest value. Returns the launches of both ranks."""
    import shutil
    import numpy as np

    out = os.path.join(WORK, 'gen_mel_dp')
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = _rank_lines(_finish(_start_ranks('ddp_generate', {
        'argv': ['-o', out, '--mesh-data', '2', *common]}),
        'ddp_generate: ranks'))
    seconds = time.perf_counter() - t0
    names = {b: sorted(os.listdir(os.path.join(mel_dir, b)))
             for b in sorted(os.listdir(mel_dir))}
    got_names = {b: sorted(os.listdir(os.path.join(out, b)))
                 for b in sorted(os.listdir(out))}
    worst = 0.0
    if names == got_names:
        for b, files in names.items():
            for f in files:
                want, got = (np.load(os.path.join(d, b, f))
                             for d in (mel_dir, out))
                require(got.shape == want.shape, f'ddp_generate: {b}/{f} '
                                                 f'{got.shape} {want.shape}')
                worst = max(worst, float(np.abs(got - want).max())
                            / float(np.abs(want).max()))
    counts = {k: sum(r['launches'][k] for r in ranks)
              for k in ranks[0]['launches']}
    three = in_f32({k: 3 * v for k, v in EXPECTED_COUNTS.items()})
    _check({'phase': 'ddp_generate', 'card': card, 'ranks': ranks,
            'seconds': seconds, 'files_per_batch': {
                b: len(f) for b, f in got_names.items()},
            'mel_max_err_of_largest': worst, 'tol': DDP_GEN_TOL}, [
        (names == got_names, f'ddp_generate: files {got_names} against '
                             f'{names}'),
        (worst <= DDP_GEN_TOL, f'ddp_generate: mels part by {worst} of '
                               'their largest'),
        (all(r['launches'] == three for r in ranks),
         f'ddp_generate: launches a rank {[r["launches"] for r in ranks]}')])
    return counts


# ---- evaluate ---------------------------------------------------------------

EVAL_ITEMS = 8           # the test split of the evaluate phase
EVAL_CPU_ROWS = 1        # its shortest utterance, evaluated again on the CPU
EVAL_MCD_RTOL = 1e-2     # MCD of the GPU's waveform against the CPU's
EVAL_F0_FRAMES = 2       # GPE, VDE, FFE: within this many frames' share


def _eval_line(line):
    """(metrics, seconds) of one per-utterance line of cli.evaluate."""
    values = {k: float(v) for k, v in re.findall(r'(\w+)=([-\d.e+naif]+)',
                                                  line)}
    seconds = {k[:-2]: values.pop(k) for k in list(values)
               if k.endswith('_s')}
    return values, seconds


def _f0_frames(wav, fs):
    """The YIN F0 track evaluate_pair's 'yin' backend takes of ``wav``."""
    import numpy as np
    from gradtts_tpu_torch.eval import yin_f0
    return yin_f0(np.asarray(wav, np.float64), fs, 70.0, 400.0,
                  frame_length=512, hop=256)


def _aligned_frames(pred, ref, fs):
    """The length of evaluate_pair's DTW path of ``pred`` against ``ref``
    (its 'yin' mcep tracks): the frames GPE, VDE and FFE average over."""
    import numpy as np
    from gradtts_tpu_torch.eval import mcep_from_waveform, warping_indices
    tracks = [mcep_from_waveform(np.asarray(w, np.float64), fs, 512, 256,
                                 34, 0.45) for w in (pred, ref)]
    return len(warping_indices(*tracks)[0])


def phase_evaluate(device, card, ckpt, vocoder_ckpt):
    """python -m gradtts_tpu_torch.cli.evaluate, in this process, on the
    seeded full-width ljspeech checkpoint and the seeded V1 vocoder over an
    EVAL_ITEMS-utterance test split (ljspeech texts, 22.05 kHz wavs of
    1.5-10 s) at 50 Euler steps with --out-dir: every metric finite, the
    MEAN: line the file's mean; the EVAL_CPU_ROWS shortest utterance(s)
    again on the CPU with the noise the CLI drew: the mel within SLICE_TOL
    of its largest value, the vocoder on one mel within SLICE_TOL of the
    waveform's largest value, MCD within EVAL_MCD_RTOL, GPE, VDE and FFE
    within EVAL_F0_FRAMES frames' share, the voicing decisions that
    differ counted. The waveforms' own difference is reported, not held:
    the random-weight mels reach several hundred, and the vocoder carries
    the mel's difference (the f32 GroupNorm statistics over a budget that
    is mostly padding) into the waveform. Also the seconds of synthesis,
    vocoder and host DSP per utterance and in all, and audio-s evaluated
    a second. Returns (launches, the split's filelist, the output
    directory)."""
    import numpy as np
    import torch
    from gradtts_tpu_torch.cli.evaluate import (evaluate_utterance,
                                                utterance_budget)
    from gradtts_tpu_torch.cli.inference import load_vocoder
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.data.dataset import dataset_from_config, load_wav
    from scipy.io import wavfile

    filelist = write_corpus(os.path.join(WORK, 'eval_corpus'), EVAL_ITEMS,
                            texts=_ljspeech_test_texts(EVAL_ITEMS))
    out = os.path.join(WORK, 'eval_out')
    sets = [f'data.test_filelist_path={filelist}']
    reset_counts()
    stdout, cli_s = _cli_main('gradtts_tpu_torch.cli.evaluate', [
        '--checkpoint', ckpt, '--vocoder', vocoder_ckpt, '--n-utterances',
        str(EVAL_ITEMS), '--out-dir', out, '--set', *sets])
    counts = read_counts()
    with open(os.path.join(out, 'metrics.json'), encoding='utf-8') as f:
        saved = json.load(f)
    mean_line = [ln for ln in stdout.splitlines() if ln.startswith('MEAN: ')]
    rows = [_eval_line(ln) for ln in stdout.splitlines()
            if re.match(r'\[\d+/\d+\] ', ln)]
    finite = all(math.isfinite(v) for r in saved['per_utt']
                 for v in r.values())

    # the shortest utterances again on the CPU, with the CLI's noise
    cfg = get_config('ljspeech', **dict(s.split('=') for s in sets))
    dataset = dataset_from_config(cfg, 'test')
    generator = torch.Generator(device=device).manual_seed(0)
    items, audio_s = [], 0.0
    for i in range(EVAL_ITEMS):
        item = dataset[i]
        budget = utterance_budget(item['y'].shape[0], cfg.data.y_buckets)
        noise = torch.randn((1, budget, cfg.data.n_feats),
                            generator=generator, device=device).cpu()
        items.append((budget, i, item, noise))
        audio_s += _wave_seconds(os.path.join(out, f'eval_{i}.wav'))
    model = _seeded_model(cfg, ckpt, torch.device('cpu'))
    vocoder = load_vocoder(vocoder_ckpt, None, torch.device('cpu'))
    # the CLI's mels and waveforms are not kept: rerun them on the card
    gpu_model = _seeded_model(cfg, ckpt, device)
    gpu_voc = load_vocoder(vocoder_ckpt, None, device)
    compared = []
    for budget, i, item, noise in sorted(items, key=lambda t: t[:2])[
            :EVAL_CPU_ROWS]:
        ref, fs = load_wav(dataset.filepaths_and_text[i][0])
        t0 = time.perf_counter()
        cpu = evaluate_utterance(model, vocoder, item, ref, fs, noise)
        cpu_s = time.perf_counter() - t0
        gpu = evaluate_utterance(gpu_model, gpu_voc, item, ref, fs,
                                 noise.to(device))
        _, cli_wav = wavfile.read(os.path.join(out, f'eval_{i}.wav'))
        cli_lsb = int(np.abs(cli_wav.astype(np.int32) - (
            gpu.waveform * 32767).astype(np.int16)).max()) \
            if cli_wav.shape == gpu.waveform.shape else -1
        mel_scale = float(cpu.mel.abs().max())
        mel_err = float((gpu.mel.cpu() - cpu.mel).abs().max()) \
            if gpu.mel.shape == cpu.mel.shape else math.inf
        wav_scale = float(np.abs(cpu.waveform).max())
        wav_err = float(np.abs(gpu.waveform - cpu.waveform).max()) \
            if gpu.waveform.shape == cpu.waveform.shape else math.inf
        # the vocoders on one mel (the CPU's), and the CPU's vocoder on
        # each device's mel: its own GPU-vs-CPU part, and the part that
        # the mel's difference carries through it
        with torch.no_grad():
            voc_gpu = gpu_voc(cpu.mel[None].to(device))[0].clamp(
                -1, 1).cpu().numpy()
            voc_from_gpu_mel = vocoder(gpu.mel[None].cpu())[0].clamp(
                -1, 1).numpy()
        voc_err = float(np.abs(voc_gpu - cpu.waveform).max())
        carried = float(np.abs(voc_from_gpu_mel - cpu.waveform).max()) \
            if voc_from_gpu_mel.shape == cpu.waveform.shape else math.inf
        flips = int(np.sum((_f0_frames(gpu.waveform, fs) > 0)
                           != (_f0_frames(cpu.waveform, fs) > 0))) \
            if gpu.waveform.shape == cpu.waveform.shape else -1
        frames = max(_aligned_frames(w, ref, fs)
                     for w in (gpu.waveform, cpu.waveform))
        compared.append({
            'utterance': i, 'budget': budget,
            'frames': int(cpu.mel.shape[0]),
            'cli_metrics_equal_rerun': saved['per_utt'][i] == gpu.metrics,
            'cli_wav_max_lsb_from_rerun': cli_lsb,
            'mel_max_abs_err': mel_err, 'mel_max_abs': mel_scale,
            'wave_max_abs_err': wav_err, 'wave_max_abs': wav_scale,
            'vocoder_same_mel_max_abs_err': voc_err,
            'wave_err_carried_from_mel_on_cpu': carried,
            'gpu_metrics': gpu.metrics, 'cpu_metrics': cpu.metrics,
            'aligned_frames': frames, 'f0_tol': EVAL_F0_FRAMES / frames,
            'voicing_flips': flips, 'cpu_s': cpu_s})
    sec = {k: [r[1][k] for r in rows] for k in ('synthesis', 'vocoder',
                                                'dsp')}
    line = {'phase': 'evaluate', 'card': card, 'preset': 'ljspeech',
            'utterances': EVAL_ITEMS, 'steps': 50, 'dtype': 'float32',
            'dsp_backend': 'yin (pyworld absent)', 'mean': saved['mean'],
            'per_utterance_s': sec,
            'total_s': {k: sum(v) for k, v in sec.items()},
            'cli_s': cli_s, 'audio_s': audio_s,
            'audio_s_evaluated_per_s': audio_s / cli_s,
            'compared': compared, 'launches': counts}
    steps = 50 * EVAL_ITEMS
    checks = [
        (finite and len(saved['per_utt']) == EVAL_ITEMS,
         'evaluate: metrics.json has a non-finite metric or a missing row'),
        (len(mean_line) == 1 and json.loads(mean_line[0][len('MEAN: '):])
         == saved['mean'], 'evaluate: the MEAN: line is not the file\'s'),
        (len(rows) == EVAL_ITEMS and all(
            {k: round(v, 4) for k, v in saved['per_utt'][i].items()}
            == {k: round(v, 4) for k, v in r[0].items()}
            for i, r in enumerate(rows)), 'evaluate: printed metrics are '
                                          'not metrics.json\'s'),
        (counts == in_f32({k: steps * v // STEPS
                           for k, v in EXPECTED_COUNTS.items()}),
         f'evaluate: launches {counts}')]
    for c in compared:
        u = c['utterance']
        gm, cm = c['gpu_metrics'], c['cpu_metrics']
        checks += [
            (c['mel_max_abs_err'] <= SLICE_TOL * c['mel_max_abs'],
             f'evaluate {u}: mel GPU vs CPU {c["mel_max_abs_err"]}'),
            (c['vocoder_same_mel_max_abs_err']
             <= SLICE_TOL * c['wave_max_abs'],
             f'evaluate {u}: the vocoder GPU vs CPU on one mel '
             f'{c["vocoder_same_mel_max_abs_err"]}'),
            (abs(gm['mcd'] - cm['mcd']) <= EVAL_MCD_RTOL * abs(cm['mcd']),
             f'evaluate {u}: MCD {gm["mcd"]} vs {cm["mcd"]}'),
            (all(abs(gm[k] - cm[k]) <= c['f0_tol'] + 1e-12
                 for k in ('gpe', 'vde', 'ffe')),
             f'evaluate {u}: F0 metrics {gm} vs {cm}')]
    _check(line, checks)
    return counts, filelist, out


def _ljspeech_test_texts(n):
    with open(os.path.join(REPO, 'resources', 'filelists', 'ljspeech',
                           'test.txt'), encoding='utf-8') as f:
        return [ln.rstrip('\n').split('|')[1] for _, ln in zip(range(n), f)]


def _wave_seconds(path):
    import wave
    with wave.open(path, 'rb') as w:
        return w.getnframes() / w.getframerate()


def phase_evaluate_mcd(filelist, eval_out):
    """python -m gradtts_tpu_torch.cli.evaluate_mcd as a subprocess (its
    --nj 2 workers fork, away from this process's CUDA context) on the
    evaluate phase's wavs against the split's wavs: utt2mcd has a finite
    row an utterance. The tool pairs a generated wav with the reference
    whose name its path contains, so both are linked under names that
    no directory of a checkout holds."""
    import shutil
    from gradtts_tpu_torch.config import get_config
    from gradtts_tpu_torch.data.dataset import dataset_from_config
    cfg = get_config('ljspeech', **{'data.test_filelist_path': filelist})
    dataset = dataset_from_config(cfg, 'test')
    gen, gt = (os.path.join(WORK, d) for d in ('mcd_gen', 'mcd_gt'))
    for d in (gen, gt):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    for i in range(EVAL_ITEMS):
        ref = os.path.abspath(dataset.filepaths_and_text[i][0])
        name = f'ljeval_utt{i:02d}'
        os.symlink(ref, os.path.join(gt, f'{name}.wav'))
        os.symlink(os.path.join(eval_out, f'eval_{i}.wav'),
                   os.path.join(gen, f'{name}_gen.wav'))
    out = os.path.join(WORK, 'mcd_out')
    proc, secs = _run_cli('gradtts_tpu_torch.cli.evaluate_mcd', [
        gen, gt, '--outdir', out, '--nj', '2'])
    with open(os.path.join(out, 'utt2mcd'), encoding='utf-8') as f:
        rows = [ln.split() for ln in f if ln.strip()]
    values = [float(v) for _, v in rows]
    _check({'phase': 'evaluate_mcd', 'rows': len(rows), 'mcd': values,
            'average_line': proc.stdout.strip().splitlines()[-1],
            'seconds': secs},
           [(len(rows) == EVAL_ITEMS, f'evaluate_mcd: {len(rows)} rows'),
            (all(math.isfinite(v) for v in values),
             f'evaluate_mcd: {values}')])


# ---- trained-weights quality gate ---------------------------------------------
# The corpus of tests/test_e2e_quality_gate.py: each token id is a fixed
# two-partial sine chunk of 8 mel frames at hop 64, so an utterance is
# deterministic audio whose mel comes from the real mel front end. The
# vocoder is a tiny random-init HiFi-GAN, one fixed map for both models.
GATE_SR, GATE_HOP, GATE_NFFT, GATE_NMELS = 22050, 64, 256, 32
GATE_DUR, GATE_TX, GATE_BT, GATE_VOCAB = 8, 8, 8, 12
GATE_STEPS, GATE_LR = 800, 1e-3
GATE_HP = dict(n_vocab=GATE_VOCAB, n_enc_channels=32, filter_channels=64,
               filter_channels_dp=16, n_heads=2, n_enc_layers=2,
               n_feats=GATE_NMELS, dec_dim=16)
# the corpus of tests/test_dpm_sampler.py:85-154: each token a fixed random
# mel frame held 4 frames
DPM_HP = dict(GATE_HP, n_vocab=20, n_enc_layers=1, n_feats=16)
DPM_STEPS, DPM_BUDGET = 1500, 48


def gate_corpus():
    """(tokens [8, 8], audio [8, 4096] f32, log-mel [8, 64, 32]) of the
    sine-chunk corpus (seed 11)."""
    import numpy as np
    from gradtts_tpu_torch.data.mel import mel_spectrogram_np

    def token_audio(tok):
        f = 140.0 * 2.0 ** (tok / 8.0)
        t = np.arange(GATE_DUR * GATE_HOP) / GATE_SR
        return (0.5 * np.sin(2 * np.pi * f * t)
                + 0.25 * np.sin(4 * np.pi * f * t)).astype(np.float32)

    tokens = np.random.default_rng(11).integers(1, GATE_VOCAB,
                                                (GATE_BT, GATE_TX))
    audio = np.stack([np.concatenate([token_audio(t) for t in row])
                      for row in tokens])
    mel = mel_spectrogram_np(audio, n_fft=GATE_NFFT, num_mels=GATE_NMELS,
                             sampling_rate=GATE_SR, hop_size=GATE_HOP,
                             win_size=GATE_NFFT)
    return tokens, audio, mel


def codebook_corpus():
    """(tokens [8, 8], mels [8, 32, 16], noise [8, 48, 16]) of the DPM
    fidelity corpus (seed 7)."""
    import numpy as np
    rng = np.random.default_rng(7)
    codebook = rng.standard_normal((DPM_HP['n_vocab'], 16)).astype(
        np.float32)
    tokens = rng.integers(1, DPM_HP['n_vocab'], (8, 8))
    mels = np.repeat(codebook[tokens], 4, axis=1)
    noise = rng.standard_normal((8, DPM_BUDGET, 16)).astype(np.float32)
    return tokens, mels, noise


def gate_batch(tokens, mel, device):
    import torch
    b, t_x = tokens.shape
    return {'x': torch.as_tensor(tokens, device=device).long(),
            'x_lengths': torch.full((b,), t_x, device=device),
            'y': torch.as_tensor(mel, device=device),
            'y_lengths': torch.full((b,), mel.shape[1], device=device)}


def gate_model(hp, device, seed=0):
    """The port's GradTTS at ``hp``, initialised by torch from ``seed``."""
    import torch
    from gradtts_tpu_torch.models.tts import GradTTS
    torch.manual_seed(seed)
    return GradTTS(**hp).to(device)


def gate_train(model, batch, steps, seed=1000):
    """``steps`` of ``train.state.train_step`` at lr 1e-3 on the whole mels
    (out_size None), dropout on, the draws from a generator seeded with
    ``seed`` on the model's device. Returns (the first step's prior loss,
    the last one's, seconds)."""
    import torch
    from gradtts_tpu_torch.train.state import make_optimizer, train_step
    device = batch['x'].device
    optimizer = make_optimizer(model.parameters(), GATE_LR)
    generator = torch.Generator(device=device).manual_seed(seed)
    model.train()
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = train_step(model, optimizer, batch, None,
                             generator=generator)
        if i == 0:
            first = metrics['loss/prior']
    last = float(metrics['loss/prior'])
    seconds = time.perf_counter() - t0
    model.eval()
    return float(first), last, seconds


def gate_vocoder(device):
    """The tiny HiFi-GAN of the gate (upsampling 4 x 4 x 4 = hop 64), its
    init drawn by torch from seed 5."""
    import torch
    from gradtts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    torch.manual_seed(5)
    return Generator(HiFiGANConfig(
        resblock='1', upsample_rates=(4, 4, 4), upsample_kernel_sizes=(8, 8, 8),
        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),), num_mels=GATE_NMELS,
        sampling_rate=GATE_SR, n_fft=GATE_NFFT, hop_size=GATE_HOP,
        win_size=GATE_NFFT)).to(device).eval()


def quality_gate(device, steps=GATE_STEPS):
    """tests/test_e2e_quality_gate.py with the port: train the tiny model
    ``steps`` steps on the sine-chunk corpus, synthesize (10 Euler steps,
    the same noise) with the trained and the untrained weights, vocode
    both and the true mels, and score. Returns (numbers, checks at the
    JAX gate's margins, the trained model, the batch, the noise)."""
    import copy
    import numpy as np
    import torch
    from gradtts_tpu_torch.eval.metrics import evaluate_pair, mcd
    from gradtts_tpu_torch.eval.world import sptk_mcep
    from gradtts_tpu_torch.models.tts import synthesize

    tokens, audio, mel = gate_corpus()
    t_y = mel.shape[1]
    batch = gate_batch(tokens, mel, device)
    model = gate_model(GATE_HP, device)
    untrained = copy.deepcopy(model).eval()
    first, last, train_s = gate_train(model, batch, steps)
    floor = 0.5 * math.log(2 * math.pi)

    vocoder = gate_vocoder(device)
    noise = torch.randn((GATE_BT, t_y, GATE_NMELS),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        mel_tr, mel_un = (synthesize(m, batch['x'], batch['x_lengths'], 10,
                                     t_y, noise=noise.to(device))
                          .decoder_outputs for m in (model, untrained))
        wav_gt, wav_tr, wav_un = (vocoder(m).cpu().numpy() for m in (
            batch['y'], mel_tr, mel_un))
    mel_tr, mel_un = mel_tr.cpu().numpy(), mel_un.cpu().numpy()
    mae_tr = float(np.abs(mel_tr - mel).mean())
    mae_un = float(np.abs(mel_un - mel).mean())
    real = [evaluate_pair(wav_tr[i], audio[i], GATE_SR) for i in range(2)]
    tr = [evaluate_pair(wav_tr[i], wav_gt[i], GATE_SR) for i in range(2)]
    un = [evaluate_pair(wav_un[i], wav_gt[i], GATE_SR) for i in range(2)]

    def world_mcd(a, b):
        return mcd(*(sptk_mcep(w, GATE_SR, n_fft=GATE_NFFT,
                               n_shift=GATE_HOP, mcep_dim=24,
                               mcep_alpha=0.455, impl='numpy')
                     for w in (a, b)))

    wmcd_tr = sum(world_mcd(wav_tr[i], wav_gt[i]) for i in range(2)) / 2
    wmcd_un = sum(world_mcd(wav_un[i], wav_gt[i]) for i in range(2)) / 2
    line = {'device': str(device), 'steps': steps, 'train_s': train_s,
            'steps_per_s': steps / train_s, 'prior_first': first,
            'prior_last': last, 'prior_floor': floor,
            'mae_trained': mae_tr, 'mae_untrained': mae_un,
            'mcd_trained': sum(m['mcd'] for m in tr) / 2,
            'mcd_untrained': sum(m['mcd'] for m in un) / 2,
            'ffe_trained': sum(m['ffe'] for m in tr) / 2,
            'ffe_untrained': sum(m['ffe'] for m in un) / 2,
            'world_mcd_trained': wmcd_tr, 'world_mcd_untrained': wmcd_un,
            'against_real_audio': real}
    checks = [
        (last - floor < 0.3 * (first - floor),
         f'quality_gate: prior loss {first} -> {last} (floor {floor})'),
        (mae_tr < 0.3 * mae_un, f'quality_gate: mel MAE {mae_tr} trained, '
                                f'{mae_un} untrained'),
        (all(set(m) == {'log_f0_rmse', 'mcd', 'gpe', 'vde', 'ffe'}
             and all(math.isfinite(v) for v in m.values()) for m in real),
         f'quality_gate: metrics against real audio {real}'),
        (line['mcd_trained'] < 0.5 * line['mcd_untrained'],
         f'quality_gate: MCD {line["mcd_trained"]} trained, '
         f'{line["mcd_untrained"]} untrained'),
        (line['ffe_trained'] < line['ffe_untrained'] - 0.2,
         f'quality_gate: FFE {line["ffe_trained"]} trained, '
         f'{line["ffe_untrained"]} untrained'),
        (math.isfinite(wmcd_tr) and math.isfinite(wmcd_un)
         and wmcd_tr < 0.5 * wmcd_un,
         f'quality_gate: worldnp MCD {wmcd_tr} trained, {wmcd_un} '
         'untrained')]
    return line, checks, model, batch, noise


def sampler_errors(model, x, x_lengths, noise):
    """Mean |mel - truth| of DPM-8, DPM-10, Euler-10 and Euler-50 against a
    400-step Euler truth, on ``model`` with the same noise [B, budget, F]."""
    import torch
    from gradtts_tpu_torch.models.tts import synthesize
    noise = noise.to(x.device)

    def synth(n, sampler):
        return synthesize(model, x, x_lengths, n, noise.shape[1],
                          noise=noise, sampler=sampler).decoder_outputs

    with torch.no_grad():
        truth = synth(400, 'euler')
        return {name: float((synth(n, sampler) - truth).abs().mean())
                for name, n, sampler in (('d8', 8, 'dpm'), ('d10', 10, 'dpm'),
                                         ('e10', 10, 'euler'),
                                         ('e50', 50, 'euler'))}


def dpm_fidelity(device, steps=DPM_STEPS):
    """tests/test_dpm_sampler.py::test_dpm_fidelity_on_trained_weights with
    the port: train on the codebook corpus, then the samplers against a
    400-step Euler truth. Returns (numbers, checks at the JAX test's
    margins)."""
    import torch
    tokens, mels, noise = codebook_corpus()
    batch = gate_batch(tokens, mels, device)
    model = gate_model(DPM_HP, device)
    first, last, train_s = gate_train(model, batch, steps)
    floor = 0.5 * math.log(2 * math.pi)
    err = sampler_errors(model, batch['x'], batch['x_lengths'],
                         torch.from_numpy(noise))
    line = {'device': str(device), 'steps': steps, 'train_s': train_s,
            'prior_first': first, 'prior_last': last, **err}
    checks = [
        (last - floor < 0.3 * (first - floor),
         f'dpm_fidelity: prior loss {first} -> {last} (floor {floor})'),
        (err['d8'] < 0.8 * err['e10'], f'dpm_fidelity: {err}'),
        (err['d10'] < 0.6 * err['e10'], f'dpm_fidelity: {err}'),
        (err['e50'] < err['e10'], f'dpm_fidelity: {err}')]
    return line, checks


# launches of the gate: every train step one MAS and the U-Net forward and
# backward, then two 10-step syntheses of B 8, all in f32
GATE_COUNTS = in_f32({k: GATE_STEPS * v + 2 * EXPECTED_COUNTS[k]
                      for k, v in TRAIN_COUNTS.items()}, CONVS_GATE)


def phase_quality_gate(device, card):
    """The trained-weights gate on the card: one train step of the gate's
    model (compute_loss + backward, f32) on the GPU against the CPU at
    train_slice's limits, then ``quality_gate`` (GATE_STEPS steps at the
    JAX gate's margins, its launches counted), then DPM-8, DPM-10,
    Euler-10 and Euler-50 against a 400-step Euler truth on the trained
    weights (e50 < e10 and d10 < e10; the 0.8 and 0.6 margins belong to
    the codebook corpus of the cuda test), all under cuDNN's deterministic
    algorithms. Returns the launches."""
    import numpy as np
    import torch
    tokens, _, mel = gate_corpus()
    sd = gate_model(GATE_HP, torch.device('cpu')).state_dict()

    def make_model(dev):
        from gradtts_tpu_torch.models.tts import GradTTS
        model = GradTTS(**GATE_HP)
        model.load_state_dict(sd, strict=True)
        return model.to(dev).eval()

    rng = np.random.default_rng(13)
    batch = gate_batch(tokens, mel, torch.device('cpu'))
    entry, checks = _gpu_vs_cpu_loss(
        make_model, device, (batch['x'], batch['x_lengths'], batch['y'],
                             batch['y_lengths']), 'quality_gate step',
        convs=CONVS_GATE, out_size=None,
        t=torch.tensor(rng.uniform(0.05, 0.95, GATE_BT), dtype=torch.float32),
        z=torch.from_numpy(rng.standard_normal(mel.shape).astype(
            np.float32)))
    _check({'phase': 'quality_gate_step', **entry}, checks)

    # cuDNN's default algorithms are not bit-repeatable, and 800 steps grow
    # that into another trained model at every run, whose metrics on the
    # gate's 15 frames can cross the FFE margin: the gate trains and
    # synthesizes with the deterministic ones, bit-repeatable
    with deterministic_cudnn():
        reset_counts()
        line, checks, model, batch, noise = quality_gate(device)
        counts = read_counts()
        err = sampler_errors(model, batch['x'], batch['x_lengths'], noise)
    _check({'phase': 'quality_gate', 'card': card, **line, 'samplers': err,
            'launches': counts},
           checks + [(err['e50'] < err['e10'] and err['d10'] < err['e10'],
                      f'quality_gate: samplers {err}'),
                     (counts == GATE_COUNTS,
                      f'quality_gate: launches {counts}')])
    return counts


HAND_KERNELS = ('gn_stats_kernel', 'gn_apply_kernel', 'la_stats_kernel',
                'la_apply_kernel', 'la_bwd1_kernel', 'la_bwd2_kernel',
                'la_bwd2_dx_kernel', 'la_bwd2_dw_kernel',
                'la_jvp_stats_kernel', 'la_jvp_apply_kernel', 'mas_kernel',
                'la_bwd1_tc_kernel', 'mas_dp_kernel', 'mas_path_kernel',
                'conv3x3_kernel', 'conv3x3_small_kernel')


def _family(name):
    """Coarse family of a device kernel, by its name."""
    for fam, keys in (('hand kernels', HAND_KERNELS),
                      ('convolutions', ('xmma', 'implicit_gemm', 'conv',
                                        'cudnn', 'wgrad', 'dgrad')),
                      ('matmuls', ('gemm', 'cutlass', 'sm90_')),
                      ('elementwise', ('elementwise', 'vectorized')),
                      ('reductions', ('reduce',))):
        if any(k in name for k in keys):
            return fam
    return 'other'


def _device_share(run, call_ms, what):
    """Device time by kernel over one call of ``run`` (a synthesis, a train
    step or a likelihood score) from ``utils.profiling.trace`` (a
    torch.profiler capture, its trace file in a temporary directory),
    against its unprofiled time."""
    import tempfile
    from torch.autograd import DeviceType
    from gradtts_tpu_torch.utils.profiling import trace
    with tempfile.TemporaryDirectory(dir=WORK) as logdir:
        with trace(logdir) as prof:
            run()
    # device kernels, not the ranges of user annotations (the optimizer's
    # step shows as one) that overlap them
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]
    require(kern, f'{what}: the profiler saw no device kernel')
    ms = [e.time_range.elapsed_us() / 1e3 for e in kern]
    busy = sum(ms)
    ours = {name: sum(t for e, t in zip(kern, ms) if name in e.name)
            for name in HAND_KERNELS}
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

SOURCES = {'groupnorm_mish': 'gradtts_tpu_torch/csrc/groupnorm_mish.cu',
           'attention_stats': 'gradtts_tpu_torch/csrc/linear_attention.cu',
           'attention_apply': 'gradtts_tpu_torch/csrc/linear_attention.cu',
           'attention_bwd_sweep1':
               'gradtts_tpu_torch/csrc/linear_attention_bwd.cu',
           'attention_bwd_sweep2':
               'gradtts_tpu_torch/csrc/linear_attention_bwd.cu',
           'attention_jvp_stats':
               'gradtts_tpu_torch/csrc/linear_attention_jvp.cu',
           'attention_jvp_apply':
               'gradtts_tpu_torch/csrc/linear_attention_jvp.cu',
           'maximum_path': 'gradtts_tpu_torch/csrc/mas.cu'}
# the TPU kernels replaced (MAS: the lax.scan maximum_path, not Pallas)
REPLACES = {
    'groupnorm_mish': 'gradtts_tpu/ops/pallas/groupnorm_mish.py:48',
    'attention_stats': 'gradtts_tpu/ops/pallas/linear_attention.py:58',
    'attention_apply': 'gradtts_tpu/ops/pallas/linear_attention.py:113',
    'attention_bwd_sweep1': 'gradtts_tpu/ops/pallas/linear_attention.py:329',
    'attention_bwd_sweep2': 'gradtts_tpu/ops/pallas/linear_attention.py:381',
    'attention_jvp_stats': 'gradtts_tpu/ops/pallas/linear_attention.py:651',
    'attention_jvp_apply': 'gradtts_tpu/ops/pallas/linear_attention.py:724',
    'maximum_path': 'gradtts_tpu/ops/mas.py:88'}
PER = {'synth': 'sum over the launches of one U-Net call, B 8, Ty 768, bf16',
       'train': 'sum over the launches of one train step, B 16, 172-frame '
                'crops, bf16',
       'likelihood': 'sum over the launches of one drift evaluation (U-Net '
                     'forward and jvp), B 8, Ty 512, bf16'}


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
    os.makedirs(WORK, exist_ok=True)
    t_start = time.perf_counter()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        print('chip_smoke: FAILED: nvidia-smi gave no name and power limit',
              file=sys.stderr)
        return 1
    card = smi.stdout.strip().splitlines()[0]
    seconds = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__[len('phase_'):]] = time.perf_counter() - t0
        return out

    try:
        timed(phase_build)
        stats = timed(phase_kernels, device)
        conv_row = timed(phase_conv3x3, device)
        ckpt = timed(phase_slice, device)
        timed(phase_samplers_slice, device, ckpt)
        spk_ckpt = timed(phase_speakers_slice, device)
        vocoder_ckpt = timed(phase_vocoder_slice, device)
        timed(phase_mel_slice, device, card)
        timed(phase_vocoder_train_slice, device)
        timed(phase_cli, ckpt, spk_ckpt, vocoder_ckpt)
        counts = {}
        counts['synth'], synth_run = timed(phase_synth, device, card)
        timed(phase_profiling, synth_run, card)
        counts['dpm8'] = timed(phase_dpm8, device, card)
        counts['waveform'] = timed(phase_waveform, device, card)
        counts['multispeaker'] = timed(phase_multispeaker, device, card)
        timed(phase_train_slice, device, ckpt)
        counts['train'], train_rate = timed(phase_train, device, card)
        timed(phase_device_mel, device, card, train_rate)
        counts['vocoder_train'] = timed(phase_vocoder_train, device, card,
                                        ckpt)
        counts['train_spk'], _ = timed(phase_train_spk, device, card)
        timed(phase_likelihood_slice, device, ckpt)
        counts['likelihood'] = timed(phase_likelihood, device, card, ckpt)
        # the paths of the checkpoints, remat, previews and three CLIs,
        # each counted from 0 just before it (their launches are read
        # into launches_per_path, the kernels' times on the paths above)
        counts['remat'] = timed(phase_remat, device, card)
        counts['previews'] = timed(phase_previews, device, ckpt)
        counts['generate'], gen_mels, gen_args = timed(
            phase_generate, device, card, vocoder_ckpt)

        def beside_ddp():
            # untimed paths, light on the host, while phase ddp's
            # subprocesses run (previews' CPU synthesis is not)
            timed(phase_nbest_cli, ckpt, spk_ckpt)
            adaptive = timed(phase_adaptive, device, ckpt)
            counts['checkpoint_cli'] = timed(phase_checkpoint_slice, device,
                                             ckpt)
            counts['inference_zero'] = timed(phase_inference_zero, device,
                                             vocoder_ckpt)
            counts['playground'] = timed(phase_playground, ckpt)
            return adaptive

        # data parallelism over torch.distributed, each path counted from
        # 0 just before it (in this process, and in each rank's)
        (counts['ddp'], counts['tp'], counts['tp_likelihood'],
         counts['dp_likelihood']) = timed(phase_ddp, device, card, ckpt,
                                          beside_ddp)
        counts['ddp_generate'] = timed(phase_ddp_generate, card, gen_mels,
                                       gen_args)
        # objective evaluation and the trained-weights gate, each counted
        # from 0 just before it
        counts['evaluate'], eval_list, eval_out = timed(
            phase_evaluate, device, card, ckpt, vocoder_ckpt)
        timed(phase_evaluate_mcd, eval_list, eval_out)
        counts['quality_gate'] = timed(phase_quality_gate, device, card)
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr, flush=True)
        return 1
    kernels = []
    for name, st in stats.items():
        # K1-K3 are read on the synthesis path, K4, K5 and MAS on the
        # training path, K6 and K7 on the likelihood path that runs them
        path = next(p for p in counts if counts[p][name])
        sums = st[path]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': REPLACES[name],
            'launches': counts[path][name],
            'max_abs_err': st['max_abs_err'], 'ms': sums['ms'],
            'device_ms': sums['device_ms'], 'plain_ms': sums['plain_ms'],
            'bound_ms': max(sums['bytes_ms'], sums['ops_ms']),
            'bound_by': 'bytes' if sums['bytes_ms'] >= sums['ops_ms']
            else 'operations',
            'library_ms': None,
            **({'chain_estimate_ms': sums['chain_estimate_ms']}
               if 'chain_estimate_ms' in sums else {}),
            'launches_per_path': {p: c[name] for p, c in counts.items()},
            'per': PER[path] if name != 'maximum_path'
            else 'one call at [16, 384, 1024], f32'})
    # conv3x3 engages on the f32 paths only (bf16 keeps cuDNN's call)
    path = next(p for p in counts if counts[p]['conv3x3'])
    kernels.append({**conv_row, 'launches': counts[path]['conv3x3'],
                    'launches_per_path': {p: c['conv3x3']
                                          for p, c in counts.items()}})
    emit({'phase_seconds': seconds})
    print(f'# total {time.perf_counter() - t_start:.1f} s', flush=True)
    print(card)
    emit({'kernels': kernels})
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
