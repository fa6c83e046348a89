"""Device milliseconds per step in the port's ``segnet.encoder`` span: the
SegNet forward's 13 encoder layers and its five argmax pools."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "segnet.encoder", "seg.step")
