"""Device ms a call of the kernels launched in the program's
``gradtts.encoder`` span (text encoder and duration predictor)."""
from benchmark.drives.gradtts import ENCODER
from benchmark.spans import per_call_ms


def read(run):
    return per_call_ms(run, ENCODER)
