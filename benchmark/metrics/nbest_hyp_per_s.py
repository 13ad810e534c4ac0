"""Hypotheses scored over the window's seconds."""
from benchmark.readers import rate


def read(run):
    return rate(run, 'hypotheses')
