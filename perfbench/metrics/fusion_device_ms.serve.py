"""Device milliseconds per request in the port's ``posenet.fusion`` span:
the dense fusion net and the three hypothesis heads."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "posenet.fusion", "pipeline.run")
