"""Device milliseconds per step in the port's ``segnet.decoder`` span: the
SegNet forward's five unpools, 12 decoder layers and the classifier."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "segnet.decoder", "seg.step")
