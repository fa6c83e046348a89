"""The reference's FLOPs of one pose (PoseNet forward and the refiner
iterations) times the poses of the window, over its seconds, as a share of
the configuration's peak."""

from perfbench.metrics_common import mfu_pct


def read(run):
    return mfu_pct(run)
