"""Host milliseconds per step in the port's ``train.step`` span: the time
the host takes to issue one phase-1 step, to set beside the device's
milliseconds per step."""

from perfbench import spans


def read(run):
    return spans.host_ms_per(run, "train.step")
