"""Device ms an evaluation of the score U-Net: the kernels launched in the
program's ``gradtts.unet`` spans over the count of those spans."""
from benchmark.drives.gradtts import UNET
from benchmark.spans import per_span_ms


def read(run):
    return per_span_ms(run, UNET)
