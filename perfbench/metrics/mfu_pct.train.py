"""The reference's FLOPs of one sample's phase-1 forward and backward times
the samples of the window, over its seconds, as a share of the
configuration's peak."""

from perfbench.metrics_common import mfu_pct


def read(run):
    return mfu_pct(run)
