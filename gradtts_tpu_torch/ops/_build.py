"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

The library lands in ``build/gradtts_tpu_torch/`` beside the package (at
the root of a checkout) when that can be written, else, for a read-only
install, in ``$XDG_CACHE_HOME/gradtts_tpu_torch/`` (default ``~/.cache``);
either way it is named by a hash of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused. nvcc writes a temporary
file that is renamed into place, so two processes building at once never
load a half written library. Nothing is built when this module is imported:
a kernel's library is built by its first launch, or by :func:`build` for all
of them at once (one nvcc process per source, all started together).
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch
from torch._C import _functorch
from torch.autograd import forward_ad

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build',
                         'gradtts_tpu_torch')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# dtype codes of the C entry points (csrc/common.cuh: kFloat32, kBFloat16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# argtypes of every C entry point, by library
SIGNATURES = {
    'conv3x3': {
        # x, mask, w (tap-major), bias (NULL: none), y, B, F, T, C_in,
        # C_out, stream
        'gtt_conv3x3': (_P,) * 5 + (_I,) * 5 + (_P,),
    },
    'groupnorm_mish': {
        # x, part, B, N, C, chunk, tiles, groups, dtype, stream
        'gtt_gn_stats': (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        # x, mask, part, gamma, beta, out, B, N, T, C, chunk, tiles,
        # groups, eps, dtype, stream
        'gtt_gn_apply': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _F, _I, _P),
    },
    'linear_attention': {
        # x, wk, wv, m, ctx, den, B, N, C, chunk, S, dtype, stream
        'gtt_la_stats': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P),
        # x, wq, ctx2, bias, out, B, N, C, chunk, S, dtype, stream
        'gtt_la_apply': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    'linear_attention_bwd': {
        # x, dy, wq, afullt, apre, bout, da_part, dwq_part, db_part,
        # dgv_part, B, N, C, chunk, S, dtype, stream
        'gtt_la_bwd1': (_P,) * 10 + (_I,) * 6 + (_P,),
        # the same without dtype (bf16, the tensor cores' kernel)
        'gtt_la_bwd1_tc': (_P,) * 10 + (_I,) * 5 + (_P,),
        # x, dy, wk, wv, afullt, wqkv_t, m, dctx_t, dctx, dden, dx,
        # dwkv_part, B, N, C, chunk, S, dtype, stream
        'gtt_la_bwd2': (_P,) * 12 + (_I,) * 6 + (_P,),
        # x, dy, wq, wk, wv, afullt, afull, m, dctx, dden, dx, dwkv_part,
        # B, N, C, chunk, S, chunk_w, S_w, stream
        'gtt_la_bwd2_tc': (_P,) * 12 + (_I,) * 7 + (_P,),
    },
    'linear_attention_jvp': {
        # x, dx, wk, wv, dwk, dwv (NULL: no weight tangents), m, ctx, den,
        # dctx, dden, B, N, C, chunk, S, dtype, stream
        'gtt_la_jvp_stats': (_P,) * 11 + (_I,) * 6 + (_P,),
        # x, dx, wq, dwq (NULL: none), a, da, bias, dbias, y, dy, B, N, C,
        # chunk, S, dtype, stream
        'gtt_la_jvp_apply': (_P,) * 10 + (_I,) * 6 + (_P,),
    },
    'mas': {
        # value, mask, decision, path, B, Tx, Ty, stream
        'gtt_mas': (_P, _P, _P, _P, _I, _I, _I, _P),
        # value, mask, index_of, path, B, Tx, Ty, K, stream
        'gtt_mas_dp': (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
}

_loaded = {}


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ([os.path.join(home, 'bin', 'nvcc')] if home else []) + [
            shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels of gradtts_tpu_torch '
                       'are built with the CUDA toolkit (set CUDA_HOME)')


def _writable(path: str) -> bool:
    """Whether ``path`` can be created or written: its nearest existing
    ancestor takes new entries."""
    while not os.path.exists(path):
        parent = os.path.dirname(path)
        if parent == path:
            return False
        path = parent
    return os.path.isdir(path) and os.access(path, os.W_OK | os.X_OK)


def build_dir() -> str:
    """Where the libraries are built: :data:`BUILD_DIR` beside the package
    when it can be written, else the per-user cache directory (as the JAX
    package's native loader does for a read-only install)."""
    if _writable(BUILD_DIR):
        return BUILD_DIR
    cache = os.environ.get('XDG_CACHE_HOME') or os.path.join(
        os.path.expanduser('~'), '.cache')
    return os.path.join(cache, 'gradtts_tpu_torch')


def library_path(name: str) -> str:
    """Path of the library built from ``csrc/<name>.cu`` at its current
    sources and flags."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f'{name}.cu')] + sorted(
            glob.glob(os.path.join(CSRC_DIR, '*.cuh'))):
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + b'\0' + f.read())
    return os.path.join(build_dir(), f'{name}-{h.hexdigest()[:16]}.so')


def build(names=None) -> dict:
    """Builds the named libraries (default: all) that are not built yet, one
    nvcc process per source, all at once. Returns ``{name: {'seconds': s,
    'log': nvcc's output}}`` for those it built; raises if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        nvcc = _nvcc()          # raises before anything is created
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=os.path.dirname(out))
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC_DIR, f'{name}.cu')]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)
        report[name] = {'seconds': time.perf_counter() - t0, 'log': log}
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``'s library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [ctypes.c_int]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raises if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.gtt_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def needs_function(tensors) -> bool:
    """Whether a call must go through its autograd Function: a grad may be
    asked for, or an input carries a forward-mode tangent (a ``torch.func``
    transform's wrapper, or a ``forward_ad`` dual), which ``requires_grad``
    does not show. Under ``torch.inference_mode()`` neither can."""
    if torch.is_inference_mode_enabled():
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return True
    return any(_functorch.is_functorch_wrapped_tensor(t)
               or forward_ad.unpack_dual(t).tangent is not None
               for t in tensors)


def raw(t):
    """The tensor under one ``torch.func`` transform's wrapper (None stays
    None). An autograd Function's ``jvp`` rule gets its saved primals and
    tangents wrapped at the transform's level, which have no storage; the
    kernels take the values underneath. A tensor wrapped twice (a jvp under
    another transform) is refused: the rules' kernels are not
    differentiable again."""
    if t is None or not _functorch.is_functorch_wrapped_tensor(t):
        return t
    t = _functorch.get_unwrapped(t)
    if _functorch.is_functorch_wrapped_tensor(t):
        raise NotImplementedError('a kernel rule was asked for under two '
                                  'nested torch.func transforms')
    return t
