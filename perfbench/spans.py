"""The port's spans in a traced segment, as the ``program_span`` metrics
read them.

While a ``torch.profiler`` session is active the port keeps a record of
each span (``densefusion_tpu_torch.utils.profiling.spans``): its name, the
root span of its request or step, its host interval on ``time.time_ns()``,
which is the clock the profiler stamps its events with, and its device
time where CUDA is in use. The harness profiles two segments, without and
then with the host's operations; only the first (``run.trace``) is read.
A request or step is taken whole when its root span overlaps the segment:
the segment may start at the first device operation, after the first
request's host work began. Counts are the spans' own: requests are the
``pipeline.run`` spans, steps the ``train.step`` spans. A program without
spans, or a trace that holds none, gives None.
"""

from __future__ import annotations

import statistics

from perfbench.harness import busy_s

PREP = ("serve.collate", "pipeline.inputs")


def segment(run) -> list[dict] | None:
    """The span records of the requests or steps of ``run.trace``."""
    if run.trace is None:
        return None
    try:
        from densefusion_tpu_torch.utils.profiling import spans
    except ImportError:     # a program that records no spans
        return None
    lo, hi = run.trace.start_us * 1e3, run.trace.end_us * 1e3
    records = spans()
    roots = {r["id"] for r in records if r["parent"] is None
             and r["t0_ns"] < hi and r["t1_ns"] > lo}
    return [r for r in records if r["request"] in roots] or None


def host_ms(r) -> float:
    return (r["t1_ns"] - r["t0_ns"]) / 1e6


def device_ms_per(run, name: str, per: str) -> float | None:
    """Summed device ms of the segment's ``name`` spans over its ``per``
    spans; None without device times."""
    records = segment(run)
    if records is None:
        return None
    times = [r["device_ms"] for r in records if r["name"] == name]
    n = sum(1 for r in records if r["name"] == per)
    if not times or not n or None in times:
        return None
    return sum(times) / n


def host_ms_per(run, name: str) -> float | None:
    """Mean host ms of the segment's ``name`` spans."""
    records = segment(run)
    times = [host_ms(r) for r in records or () if r["name"] == name]
    return sum(times) / len(times) if times else None


def host_prep_ms(run) -> float | None:
    """Median over the segment's requests (those holding a
    ``pipeline.run``) of the host ms in their preparation spans."""
    records = segment(run)
    if records is None:
        return None
    requests = {r["request"] for r in records if r["name"] == "pipeline.run"}
    prep = dict.fromkeys(requests, 0.0)
    for r in records:
        if r["name"] in PREP and r["request"] in prep:
            prep[r["request"]] += host_ms(r)
    return statistics.median(prep.values()) if prep else None


def uncovered(intervals, cover, start: float, end: float) -> float:
    """Length of the part of [start, end] that lies inside ``intervals``
    and outside ``cover``: the union of both less the cover's."""
    def clip(xs):
        return [(max(s, start), min(e, end)) for s, e in xs
                if e > start and s < end]

    inside, cover = clip(intervals), clip(cover)
    return (busy_s(inside + cover) - busy_s(cover)) * 1e6


def idle_host_prep_pct(run) -> float | None:
    """100 x the time of the segment in which no device operation runs
    and the host is inside a preparation span, over the segment."""
    records = segment(run)
    t = run.trace
    if records is None or not t.device:
        return None
    prep = [(r["t0_ns"] / 1e3, r["t1_ns"] / 1e3) for r in records
            if r["name"] in PREP]
    device = [(s, e) for _, s, e in t.device]
    return 100.0 * uncovered(prep, device, t.start_us, t.end_us) \
        / (t.end_us - t.start_us)
