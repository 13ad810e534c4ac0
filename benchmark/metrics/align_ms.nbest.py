"""Device ms a call of the kernels launched in the program's
``gradtts.align`` span (the log-prior grid, MAS, the crop, mu_y)."""
from benchmark.drives.gradtts import ALIGN
from benchmark.spans import per_call_ms


def read(run):
    return per_call_ms(run, ALIGN)
