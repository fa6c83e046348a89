"""The part of ``device_idle_pct.serve`` put down to host preparation: 100
x the time of the traced segment in which no device operation runs and
the host is inside a ``serve.collate`` or ``pipeline.inputs`` span, over
the segment's length (spans and device operations on the profiler's
clock)."""

from perfbench import spans


def read(run):
    return spans.idle_host_prep_pct(run)
