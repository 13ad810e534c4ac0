"""Device ms a step of the kernels launched in the program's
``gradtts.train.optimizer`` span (clip and Adam)."""
from benchmark.drives.gradtts import OPTIMIZER
from benchmark.spans import per_call_ms


def read(run):
    return per_call_ms(run, OPTIMIZER)
