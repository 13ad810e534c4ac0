"""Seconds of audio (each row's frames as the program returned them, times
hop / sample rate) over the window's seconds."""
from benchmark.readers import rate


def read(run):
    return rate(run, 'audio_s')
