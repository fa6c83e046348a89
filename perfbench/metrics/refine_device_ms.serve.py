"""Device milliseconds per request in the port's ``pipeline.refine`` spans,
summed over the refiner iterations (the configuration's ``refine_iters``)."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "pipeline.refine", "pipeline.run")
