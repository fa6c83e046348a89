"""The ``program_span`` metrics' reading code (``perfbench/spans.py``) on
the CPU: requests and steps are taken whole when their root overlaps the
traced segment on the profiler's clock, the idle time put down to host
preparation is the part of the preparation spans no device operation
covers, a program without spans gives nothing, and in a traced tiny run
the spans count the segment's work as the harness does."""

import sys
from types import SimpleNamespace

import pytest

from perfbench import harness, spans
from perfbench.harness import Bench, Trace
from perfbench.tests import tiny


def rec(id, name, t0_us, t1_us, parent=None, request=None, device_ms=None,
        units=None):
    return {"name": name, "id": id, "parent": parent,
            "request": id if request is None else request,
            "t0_ns": t0_us * 1000, "t1_ns": t1_us * 1000, "units": units,
            "error": None, "device_ms": device_ms}


def run_of(records, monkeypatch, device=(), start=100.0, end=200.0):
    import densefusion_tpu_torch.utils.profiling as profiling

    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return SimpleNamespace(trace=Trace(list(device), [], start, end, 0))


def test_a_request_is_taken_whole_when_its_root_overlaps(monkeypatch):
    records = [
        # before the segment
        rec(1, "pipeline.run", 10, 90), rec(2, "posenet.cnn", 20, 80, 1, 1),
        # starts before it (its host work precedes the first device op)
        rec(3, "pipeline.run", 95, 140, device_ms=1.0),
        rec(4, "pipeline.inputs", 95, 99, 3, 3),
        rec(5, "posenet.cnn", 99, 130, 3, 3, device_ms=2.0),
        # inside it
        rec(6, "pipeline.run", 150, 190),
        rec(7, "posenet.cnn", 160, 180, 6, 6, device_ms=4.0),
        # the next segment's
        rec(8, "pipeline.run", 250, 300), rec(9, "posenet.cnn", 260, 280,
                                              8, 8, device_ms=100.0)]
    run = run_of(records, monkeypatch)
    got = spans.segment(run)
    assert [r["id"] for r in got] == [3, 4, 5, 6, 7]
    assert spans.device_ms_per(run, "posenet.cnn", "pipeline.run") == 3.0
    assert spans.host_prep_ms(run) == pytest.approx(0.002)   # 4 µs and 0


def test_device_metrics_give_nothing_without_device_times(monkeypatch):
    run = run_of([rec(1, "train.step", 120, 180),
                  rec(2, "train.forward", 130, 150, 1, 1)], monkeypatch)
    assert spans.device_ms_per(run, "train.forward", "train.step") is None
    assert spans.host_ms_per(run, "train.step") == pytest.approx(0.06)
    assert spans.idle_host_prep_pct(run) is None   # no device operations


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "densefusion_tpu_torch.utils.profiling",
                        SimpleNamespace())
    run = SimpleNamespace(trace=Trace([], [], 0.0, 1.0, 0))
    assert spans.segment(run) is None
    assert spans.host_prep_ms(run) is None
    assert spans.device_ms_per(run, "posenet.cnn", "pipeline.run") is None
    assert spans.segment(SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("intervals,cover,want", [
    ([(0, 10)], [], 10),
    ([(0, 10)], [(2, 4), (6, 8)], 6),
    ([(0, 10), (5, 15)], [(12, 30)], 12),           # prep spans overlap
    ([(0, 10)], [(-5, 3), (3, 4), (9, 20)], 5),      # cover runs past
    ([(-20, 5), (95, 130)], [], 10),                # clipped to [0, 100]
    ([(10, 20), (30, 40)], [(15, 35)], 10),          # one cover, two spans
], ids=["bare", "holes", "merged", "edges", "clipped", "straddle"])
def test_idle_host_prep_is_what_no_device_operation_covers(intervals, cover,
                                                           want):
    assert spans.uncovered(intervals, cover, 0.0, 100.0) == \
        pytest.approx(want)


def test_idle_host_prep_pct_on_hand_made_intervals(monkeypatch):
    records = [rec(1, "serve.request", 100, 200),
               rec(2, "serve.collate", 100, 120, 1, 1),
               rec(3, "pipeline.run", 120, 200, 1, 1),
               rec(4, "pipeline.inputs", 120, 130, 3, 1)]
    device = [("Memcpy HtoD", 125, 130), ("conv", 130, 195)]
    run = run_of(records, monkeypatch, device)
    # collate 20 µs and the copy's first 5 µs are idle: 25 of 100
    assert spans.idle_host_prep_pct(run) == pytest.approx(25.0)
    assert spans.host_prep_ms(run) == pytest.approx(0.030)


@pytest.mark.parametrize("workload,root", [("ycb-serve-b64", "pipeline.run"),
                                           ("linemod-eval-k4-b32",
                                            "pipeline.run"),
                                           ("ycb-train-p1-b32",
                                            "train.step")])
def test_the_spans_count_the_segments_work(workload, root):
    from densefusion_tpu_torch.utils.profiling import clear_spans

    bench = Bench()
    w = bench.workload(workload)
    trf = tiny.traffic(w["traffic"])
    trf.update({k: 2 for k in ("traced_requests", "traced_steps")
                if k in trf})
    drv = bench.driver(trf["kind"]).Driver(tiny.config(w["config"]), trf,
                                           5_000_000_011, "cpu")
    drv.setup()
    clear_spans()
    trace = harness.profile(drv.traced, host=False)
    harness.profile(drv.traced, host=True)     # the harness's second segment
    run = SimpleNamespace(trace=trace)
    records = spans.segment(run)
    roots = [r for r in records if r["name"] == root]
    assert len(roots) == 2
    assert sum(r["units"] for r in roots) == trace.units
    per = spans.host_ms_per(run, root)
    assert per is not None and per > 0
