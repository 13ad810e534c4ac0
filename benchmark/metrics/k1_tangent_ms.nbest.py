"""Device ms a call of the kernels launched in the program's
``gradtts.unet.k1_tangent`` spans (K1's plain forward-mode tangent)."""
from benchmark.drives.gradtts import K1_TANGENT
from benchmark.spans import per_call_ms


def read(run):
    return per_call_ms(run, K1_TANGENT)
