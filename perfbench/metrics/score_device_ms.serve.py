"""Device milliseconds of the traced segment's ``eval.pose_distances``
spans (ADD and ADD-S, kernel 5 on the symmetric rows) over its requests:
the evaluation scores each request twice, outside the pipeline."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "eval.pose_distances", "pipeline.run")
