"""Device milliseconds per step in the port's ``seg.backward`` span: the
SegNet step's backward pass."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "seg.backward", "seg.step")
