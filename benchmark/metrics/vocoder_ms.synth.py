"""Device ms a call of the HiFi-GAN generator's kernels, launched inside
the benchmark's ``benchmark.vocoder`` span."""
from benchmark.drives import VOCODER_SPAN
from benchmark.readers import span_ms


def read(run):
    return span_ms(run, VOCODER_SPAN)
