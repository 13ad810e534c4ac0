"""Device ms a step of the kernels launched in the program's
``gradtts.train.backward`` span (autograd's thread included)."""
from benchmark.drives.gradtts import BACKWARD
from benchmark.spans import per_call_ms


def read(run):
    return per_call_ms(run, BACKWARD)
