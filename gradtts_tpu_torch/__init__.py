"""gradtts_tpu_torch — the PyTorch/CUDA port of gradtts_tpu for NVIDIA Hopper.

The JAX package ``gradtts_tpu`` is the reference; this package computes the
same functions with PyTorch modules and hand-written CUDA kernels for the
H100 (``csrc/``). It imports neither JAX nor anything of ``gradtts_tpu``.

Entry points run on ``cuda`` unless the caller asks for the CPU, where each
kernel's wrapper runs its plain PyTorch version instead.
"""

__version__ = '0.1.0'

from gradtts_tpu_torch.config import GradTTSConfig, get_config, PRESETS  # noqa: F401
