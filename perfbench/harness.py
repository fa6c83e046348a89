"""The benchmark's run of one cell: find its configuration, traffic, driver,
metrics and limits by name, set the program up, measure the window, trace
a short steady part of it, judge the outputs against the plain reference
and print the result line.

Everything that belongs to one configuration, traffic mix, kind of work or
metric lives in a file of its own that this module finds by name:

- ``perfbench/configs/<config>.json``: the configuration's sizes;
- ``perfbench/traffic/<traffic>.json``: the mix's parameters, whose
  ``kind`` names the driver;
- ``perfbench/drivers/<kind>.py``: how that kind of work is set up, timed
  and judged (serve, eval, train);
- ``perfbench/metrics/<metric>.py``: one reader per metric of
  ``BENCHMARK.json``, ``read(run) -> float | None``, which returns None
  where it finds nothing to read; the manifest's ``workloads`` say which
  cells report it;
- ``perfbench/limits/<workload>.json``: the limit of each number the
  cell's judgement compares.

A driver is a class ``Driver(cfg, traffic, seed, device)`` that raises on
a configuration whose precision it does not run (:func:`require_precision`)
and has ``setup()``; ``window(seconds) -> Window``; ``traced() -> units``
of work, run under the profiler; ``flops_per_unit()``, the plain
reference's FLOPs of one unit of work at the cell's shapes, or None;
``release()``, which frees the program; ``check() -> {name: number}``, the
numbers compared with the cell's limits; and ``control()``, the same with
the reference in the program's place at the control's precision.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "densefusion_tpu")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    """Import the file at ``path`` as a module of its own (metric names hold
    dots, so they are loaded by path, not by import name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    name = f"perfbench_{path.parent.name}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark's files under ``here`` (``perfbench/``) and the
    manifest beside it."""

    def __init__(self, here: Path = HERE):
        self.here = Path(here)
        self.manifest = _json(self.here.parent / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.here / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _json(self.here / "traffic" / f"{name}.json")

    def driver(self, kind: str):
        return _module(self.here / "drivers" / f"{kind}.py")

    def metric(self, name: str):
        return _module(self.here / "metrics" / f"{name}.py")

    def limits(self, workload: str) -> dict:
        path = self.here / "limits" / f"{workload}.json"
        if not path.is_file():      # a cell with no limits is not correct
            return {}
        return {k: v["limit"] for k, v in _json(path)["checks"].items()}

    def metrics_of(self, workload: str, traced: bool) -> list[dict]:
        """The manifest's metrics the cell reports: its end-to-end ones, or
        with ``traced`` its per-layer ones."""
        group = self.manifest["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]


@dataclass
class Window:
    """The measured window: its length, the units of work (poses or
    samples) whose results reached the host inside it, each counted
    request's seconds, and the requests or steps attempted and failed."""

    seconds: float
    units: int = 0
    latencies_s: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0


@dataclass
class Trace:
    """A profiled steady segment: device operations as (name, start_us,
    end_us), host operations as (name, start_us, end_us), the segment's
    span on the profiler's clock and the units of work it held."""

    device: list
    host: list
    start_us: float
    end_us: float
    units: int

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def kernels(self, pattern: str) -> list:
        import re

        rx = re.compile(pattern)
        return [d for d in self.device if rx.search(d[0])]


def busy_s(intervals) -> float:
    """Length of the union of (start_us, end_us) intervals, in seconds."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


@dataclass
class Run:
    """What the metric readers read."""

    workload: str
    config: dict
    traffic: dict
    setup_s: float
    window: Window
    trace: Trace | None = None
    flops_per_unit: float | None = None


def require_precision(cfg: dict, supported: set) -> None:
    """Raise unless the configuration's (``dtype``, ``tf32``) is one that
    the driver runs, so that no cell runs in another precision than its
    configuration states, or reads its peak against another's work."""
    got = (cfg["dtype"], cfg["tf32"])
    if got not in supported:
        raise ValueError(f"{cfg['name']}: dtype {got[0]} with tf32 "
                         f"{got[1]} is not run by this driver "
                         f"(it runs {sorted(supported)})")


def closed_loop(request, seconds: float, units: int) -> Window:
    """One caller issuing ``request(i)`` back to back for ``seconds``; each
    request is ``units`` poses, and counts when its result is on the host
    inside the window. The driver keeps every result for the judgement."""
    win = Window(seconds)
    start = time.perf_counter()
    end = start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= end:
            break
        win.attempted += 1
        try:
            request(i)
        except Exception:      # a failed request counts against the cell
            win.failed += 1
            i += 1
            continue
        t1 = time.perf_counter()
        if t1 <= end:
            win.units += units
            win.latencies_s.append(t1 - t0)
        i += 1
    return win


def profile(segment, host: bool) -> Trace:
    """Run ``segment() -> units`` under ``torch.profiler`` and keep its
    device operations, and with ``host`` its host operations too (user
    annotations left out, so the segment's own span on the device is not
    taken for work). Without ``host`` the profiler adds next to nothing to
    the host's work, so the device's busy share is the untraced one; the
    segment's length is then the host clock's, from before the first
    launch to the end of the last operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile, \
        record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CUDA] * cuda \
        + [ProfilerActivity.CPU] * (host or not cuda)
    sync()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function("bench.traced"):
            units = segment()
            sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    device, hosts, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.is_user_annotation():
            if e.name() == "bench.traced" and e.device_type() != \
                    DeviceType.CUDA:
                span = item
        elif e.device_type() == DeviceType.CUDA:
            device.append(item)
        else:
            hosts.append(item)
    if span is None:
        start = min((d[1] for d in device), default=0.0)
        span = (None, start, start + wall_us)
    return Trace(device, hosts, span[1], span[2], units)


def breakdown(trace: Trace, gaps_trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in ``trace``, and the
    longest idle gaps of ``gaps_trace`` (traced with the host) by the
    innermost host operation running at their midpoint."""
    import numpy as np

    ops: dict = {}
    for name, s, e in trace.device:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    trace = gaps_trace
    merged = []
    for s, e in sorted((s, e) for _, s, e in trace.device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [trace.start_us] + [x for m in merged for x in m] \
        + [trace.end_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:2000]
    hs = np.array([h[1] for h in trace.host] or [0.0])
    he = np.array([h[2] for h in trace.host] or [0.0])
    names = [h[0] for h in trace.host]
    idle: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        name = (names[min(inside, key=lambda i: he[i] - hs[i])]
                if inside.size else "(host code outside torch operations)")
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(ops)],
            "idle_gaps": [[k, v] for k, v in order(idle)]}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def within_limits(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is a
    finite number within it."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        good = (limit is not None and value is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(checks), out


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             traced: bool, t_start: float, device: str = "cuda",
             config: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None) -> dict:
    """One run of ``workload`` -> the result line's object. ``config``,
    ``traffic`` and ``limits`` replace the cell's own files (the tests run
    small copies on the CPU)."""
    import torch

    w = bench.workload(workload)
    cfg = config or bench.config(w["config"])
    trf = traffic or bench.traffic(w["traffic"])
    limits = limits if limits is not None else bench.limits(workload)
    drv = bench.driver(trf["kind"]).Driver(cfg, trf, seed, device)
    cuda = torch.device(device).type == "cuda"

    phases = {"before_setup": time.perf_counter() - t_start}
    drv.setup()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    window = drv.window(seconds)
    phases["window"] = time.perf_counter() - t
    t = time.perf_counter()
    trace = profile(drv.traced, host=False) if traced else None
    gaps = profile(drv.traced, host=True) if traced else None
    phases["trace"] = time.perf_counter() - t
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if cuda else 0)}
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    correct, checks = within_limits(drv.check(), limits)
    phases["check"] = time.perf_counter() - t
    correct = correct and window.failed == 0

    run = Run(workload, cfg, trf, setup_s, window, trace)
    t = time.perf_counter()
    if traced:
        run.flops_per_unit = drv.flops_per_unit()
        dev["busy_s"] = busy_s((s, e) for _, s, e in trace.device)
        dev["window_s"] = trace.window_s
    metrics = {}
    for m in bench.metrics_of(workload, traced):
        value = bench.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = breakdown(trace, gaps)
    phases["metrics"] = time.perf_counter() - t
    phases.update(getattr(drv, "setup_phases", {}))
    print("perfbench: setup %.3f s, " % setup_s + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items()), file=sys.stderr)
    result["checks"] = checks
    return result
