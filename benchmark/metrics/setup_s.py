"""Seconds from the harness's start to the measured window: imports,
weights, inputs, the program's build or load of its kernels, warm-up."""


def read(run):
    return run.setup_s
