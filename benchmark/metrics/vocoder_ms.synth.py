"""Device ms a call of the HiFi-GAN generator's kernels, launched inside
the program's ``gradtts.vocoder`` span (``models/hifigan.py``)."""
from benchmark.drives.gradtts import VOCODER
from benchmark.spans import per_call_ms


def read(run):
    return per_call_ms(run, VOCODER)
