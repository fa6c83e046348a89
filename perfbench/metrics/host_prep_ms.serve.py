"""Host milliseconds a request spends preparing its inputs: the port's
``serve.collate`` (numpy collation of the detections) and
``pipeline.inputs`` (the pageable host-to-device copy) spans, summed per
request, median over the traced segment's requests."""

from perfbench import spans


def read(run):
    return spans.host_prep_ms(run)
