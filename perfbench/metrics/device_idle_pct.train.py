"""Share of the traced segment of a training cell in which no operation ran
on the device."""

from perfbench.metrics_common import idle_pct


def read(run):
    return idle_pct(run)
