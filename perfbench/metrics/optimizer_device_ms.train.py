"""Device milliseconds per step in the port's ``train.optimizer`` span:
Adam's update of the PoseNet."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "train.optimizer", "train.step")
