"""Device milliseconds per step in the port's ``train.forward`` span:
the PoseNet forward."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "train.forward", "train.step")
