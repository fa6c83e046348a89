"""Device milliseconds per step in the port's ``train.loss`` span:
the ADD / ADD-S loss (kernels 1 and 2 and their glue)."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "train.loss", "train.step")
