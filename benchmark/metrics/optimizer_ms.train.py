"""Device ms a step of the kernels launched in the program's
``gradtts.train.optimizer`` span (clip and Adam)."""
from benchmark.spans import OPTIMIZER, per_call_ms


def read(run):
    return per_call_ms(run, OPTIMIZER, 'train')
