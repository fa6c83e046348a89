#!/usr/bin/env python3
"""What routing kernel 6 through a registered op costs on the card, against
another checkout (its parent), in turns.

    python3 examples/gpu_op_dispatch.py [out.json] --parent DIR

``DIR`` is another checkout of the repository (``git archive`` it into a
gitignored ``_work/``). Four turns, parent, this checkout, this checkout,
parent, each a process of its own started with that checkout first on the
import path (its kernels built into its own ``build/``). Each turn reads,
on the same card:

* ``serving``: the inference pipeline of ``cli/benchmark.py`` (YCB width,
  seeded weights) at B=64, K=2, float32: device time per call by CUDA
  events over back-to-back calls, and host wall time per call ended by a
  sync; three launches of kernel 6 per call;
* ``latency``: ``bench_latency`` (B=1, K=2, bf16 on the card): median and
  p90 ms of single requests, each ended by a read of its pose;
* ``bypass``: the same serving call in turns within the process (route,
  bypass, bypass, route, twice), with the decoder's kernel route and with
  the wrapper called directly in its place (a measuring harness only):
  what the route's dispatch costs a B=64 forward, free of the spread
  between processes (two processes can pick other library algorithms);
* ``route``: host microseconds per call of the kernel route
  (``conv3x3_valid_nchw(..., "kernel")``: an autograd Function in a parent
  before the op, the registered op here) against the wrapper called
  directly, on a map small enough (B=1, 8x8, 16 -> 16 channels) that the
  host, not the card, sets the pace; with and without gradients.

Prints one JSON object (the turns and, per checkout, their means) and
writes it to ``out.json`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _host_us(fn, calls: int = 2000) -> float:
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / calls


def _direct(phase_conv):
    """The kernel route's convolution with its wrapper called directly:
    the route's operands, no dispatch."""
    import torch

    def conv(xp, pk, backend="auto"):
        if backend == "library" or (backend == "auto"
                                    and xp.device.type != "cuda"):
            return phase_conv.conv3x3_valid_nchw(xp, pk, backend)
        kernel = phase_conv.KERNELS[xp.dtype]
        if kernel.layout == torch.contiguous_format:
            xp = xp.contiguous()
        return kernel(xp, pk.contiguous())

    return conv


def _bypass_turns(pipe, inputs, phase_conv) -> dict:
    """Device ms per B=64 call with the route and with the wrapper direct,
    in turns (route, bypass, bypass, route, twice)."""
    import torch

    from densefusion_tpu_torch.models import layers

    route_conv = layers.conv3x3_valid_nchw
    direct = _direct(phase_conv)
    times = {"route": [], "bypass": []}
    try:
        for name in ("route", "bypass", "bypass", "route") * 2:
            layers.conv3x3_valid_nchw = route_conv if name == "route" \
                else direct
            pipe(*inputs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                pipe(*inputs)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / 10)
    finally:
        layers.conv3x3_valid_nchw = route_conv
    return {"route_ms": sum(times["route"]) / 4,
            "bypass_ms": sum(times["bypass"]) / 4, "turns": times}


def child() -> dict:
    """One turn, in the checkout that is first on ``sys.path``."""
    import torch

    from densefusion_tpu_torch.cli import benchmark
    from densefusion_tpu_torch.device import resolve_device
    from densefusion_tpu_torch.ops import build, phase_conv

    build.build_all(("phase_conv", "phase_conv_bf16"))
    dev = resolve_device("cuda")
    pipe, inputs = benchmark._pose_pipeline(64, 2, dev, obj_zero=False)
    for _ in range(3):
        pipe(*inputs)
    torch.cuda.synchronize()
    phase_conv.phase_conv_kernel.launches = 0
    pipe(*inputs)
    launches = phase_conv.phase_conv_kernel.launches
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        pipe(*inputs)
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / 20
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        pipe(*inputs)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    walls.sort()
    bypass = _bypass_turns(pipe, inputs, phase_conv)
    del pipe, inputs
    latency = benchmark.bench_latency(repeats=100, device=dev)

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 16, 10, 10), device="cuda", generator=gen)
    pk = torch.randn((3, 3, 16, 16), device="cuda", generator=gen)
    route = {}
    with torch.no_grad():
        route["wrapper_us"] = _host_us(
            lambda: phase_conv.phase_conv_kernel(x, pk))
        route["route_us"] = _host_us(
            lambda: phase_conv.conv3x3_valid_nchw(x, pk, "kernel"))
    xg, pkg = x.clone().requires_grad_(), pk.clone().requires_grad_()
    route["route_grad_us"] = _host_us(
        lambda: phase_conv.conv3x3_valid_nchw(xg, pkg, "kernel"))
    return {"serving": {"device_ms": device_ms,
                        "wall_ms_median": walls[len(walls) // 2],
                        "frames_per_s": 64e3 / device_ms,
                        "kernel6_launches": launches},
            "bypass": bypass,
            "latency": {k: latency[k] for k in (
                "latency_ms_median", "latency_ms_p90", "dtype")},
            "route": route,
            "registered_op": hasattr(phase_conv, "phase_conv3x3"),
            "card": torch.cuda.get_device_name(0)}


def turn(tree: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--child"], cwd=tree, env=env, capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed:\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def _mean(a: dict, b: dict) -> dict:
    return {k: (_mean(v, b[k]) if isinstance(v, dict)
                else (v + b[k]) / 2 if isinstance(v, float) else v)
            for k, v in a.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child()))
        return
    if args.parent is None:
        raise SystemExit("--parent DIR is required")
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    turns = [(name, turn(trees[name]))
             for name in ("parent", "change", "change", "parent")]
    result = {"turns": turns, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()}
    for name in ("parent", "change"):
        got = [t for n, t in turns if n == name]
        result[name] = _mean(*got)
    print(json.dumps(result, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
