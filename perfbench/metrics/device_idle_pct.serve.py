"""Share of the traced segment of a serving or evaluation cell in which no
operation ran on the device: 1 - (union of the device operations'
intervals) / the segment's length."""

from perfbench.metrics_common import idle_pct


def read(run):
    return idle_pct(run)
