"""Device milliseconds per request in the port's ``posenet.cnn`` span: the
trunk, PSP and the decoder with kernel 6, and the embedding at the chosen
pixels."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "posenet.cnn", "pipeline.run")
