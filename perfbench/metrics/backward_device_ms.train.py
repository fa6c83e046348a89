"""Device milliseconds per step in the port's ``train.backward`` span:
the backward pass."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "train.backward", "train.step")
