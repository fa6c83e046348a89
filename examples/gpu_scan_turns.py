#!/usr/bin/env python3
"""Time the distance and search kernels (kernel 1, the ADD paired distance;
kernel 2, the ADD-S min distance; kernels 3 and 4, the 1-NN search; kernel
5, the ADD-S remap) of this checkout against those of another checkout, in
turns on one card, with the train steps that launch kernels 1 and 2; probe
the min kernel's time at the refiner shape; and count the paired kernel's
lane instructions per (hypothesis, point) pair in its SASS.

    python3 examples/gpu_scan_turns.py OUT.json [--parent DIR]

``DIR`` is the ``densefusion_tpu_torch/csrc`` directory of the other
checkout (for example one unpacked with ``git archive``). Its ``nn.cu``,
``add_dist.cu`` and ``adds_remap.cu`` are built by ``ops/build.py`` (the
port's own flags) into a directory of their own and loaded with ctypes;
both sets take the same C
entry points, except that a paired entry point of a set without
``add_dist_paired_split`` (the earlier two-launch kernel) also takes a
scratch ``partial``, which the set allocates. Readings go in turns (parent,
change, change, parent; change, change without ``DIR``):

* each kernel, a CUDA-graph window of many launches, at the driven shapes:
  1-NN at Q=250,000, R=500 and batched at (8, 500,000, 500); the paired
  kernel at phase 1 (B=32, N=1000, M=500, 24 rows active), at the phase-2
  main loss (B=32, N=1000, M=2600, every row active) and at the refiner
  shape (B=32, N=1, M=2600, 24 rows active); the min kernel at phase 1
  (8 rows active), at the refiner shape (8 rows active) and there with no
  active row (its fixed cost); the remap at the scoring shape (B=64,
  Q=R=500) and at (3, 1003, 2600) with one gated row, and at the scoring
  shape with every row gated (the launch and the zero writes alone), each
  of these two also per launch of 20 captured in one graph (a single
  launch's replay has a cost of its own, several us, which bounds a short
  kernel's reading from below);
* the phase-1 (B=32, M=500) and phase-2 (B=32, M=2600, K=2) train steps,
  timed as ``chip_smoke.py`` [6] times them (host clock, 5 steps after a
  warm-up step, ended by a sync), ``ROUNDS`` rounds of turns, with the
  paired and the min kernels' wrappers pointed at each set's entry points
  in turn. They are the only kernels of these steps that the sets differ
  in.

The refiner-shape probe, for each set: ten back-to-back graph windows; five
with the 8 active rows spread over the batch (rows 0, 4, 8, ...) in place
of the first 8, which moves the live blocks to other SMs; single launches
each followed by a sync, and after 0.5 s of idle. The card's SM clock is
sampled with ``nvidia-smi`` beside it.

The SASS count (this checkout's kernel): ``cuobjdump -sass`` of the built
library; in ``paired_dist`` at the phase-1 split, of the innermost loops
(backward branches with no other inside) the one that holds the most
``MUFU.RSQ``, one per pair: its instructions over its ``MUFU.RSQ`` count. Needs one CUDA device; writes OUT.json and
prints a summary.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from densefusion_tpu_torch.ops import add_dist, build  # noqa: E402

ROUNDS = 6   # rounds of step turns per phase


class ScanSet:
    """The C entry points of one source set, called on the current stream."""

    def __init__(self, libs: dict):
        self.nn = libs["nn"].nn_launch
        self.nn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        self.nnb = libs["nn"].nn_batched_launch
        self.nnb.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        self.min = libs["add_dist"].add_dist_min_launch
        self.min.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        self.min.restype = ctypes.c_int
        self.remap = libs["adds_remap"].adds_remap_launch
        self.remap.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        self.remap.restype = ctypes.c_int
        self.chunk = None   # model points per partial sum, found at first use
        # a paired kernel that writes out in one launch has its split exposed
        self.paired_scratch = not hasattr(libs["add_dist"],
                                          "add_dist_paired_split")
        self._paired = libs["add_dist"].add_dist_paired_launch
        scratch = int(self.paired_scratch)
        self._paired.argtypes = [ctypes.c_void_p] * (6 + scratch) \
            + [ctypes.c_int] * (3 + scratch) + [ctypes.c_void_p]
        self._paired.restype = ctypes.c_int

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    def knn(self, q, r, d, i):
        if q.dim() == 2:
            err = self.nn(q.data_ptr(), r.data_ptr(), d.data_ptr(),
                          i.data_ptr(), q.shape[0], r.shape[0],
                          self._stream())
        else:
            err = self.nnb(q.data_ptr(), r.data_ptr(), d.data_ptr(),
                           i.data_ptr(), *q.shape[:2], r.shape[1],
                           self._stream())
        if err:
            raise RuntimeError(f"nn launch failed: {err}")

    def adds_remap(self, q, r, act, coords, score):
        err = self.remap(q.data_ptr(), r.data_ptr(),
                         None if act is None else act.data_ptr(),
                         coords.data_ptr(), score.data_ptr(), *q.shape[:2],
                         r.shape[1], self._stream())
        if err:
            raise RuntimeError(f"remap launch failed: {err}")

    def min_dist(self, R, t, model, target, act, out):
        b, n, m = R.shape[0], R.shape[1], model.shape[1]
        for chunk in ((self.chunk,) if self.chunk else (128, 256)):
            s = -(-m // chunk)
            partial = torch.empty((s, b, n, 13), device=R.device)
            err = self.min(R.data_ptr(), t.data_ptr(), model.data_ptr(),
                           target.data_ptr(), act.data_ptr(),
                           partial.data_ptr(), out.data_ptr(), b, n, m, s,
                           self._stream())
            if err == 0:
                self.chunk = chunk
                return
        raise RuntimeError(f"min launch failed: {err}")

    def paired_entry(self, R, t, model, target, act, out, b, n, m, stream):
        """The paired kernel's entry point as the port's wrapper calls it
        (pointers, sizes, stream); a set whose kernel needs ``partial``
        (S = ceil(M / 256) chunks) gets it allocated here."""
        if not self.paired_scratch:
            return self._paired(R, t, model, target, act, out, b, n, m,
                                stream)
        s = -(-m // 256)
        partial = torch.empty((s, b, n, 13), device="cuda")
        return self._paired(R, t, model, target, act, partial.data_ptr(),
                            out, b, n, m, s, stream)

    def paired_dist(self, R, t, model, target, act, out):
        err = self.paired_entry(R.data_ptr(), t.data_ptr(), model.data_ptr(),
                                target.data_ptr(), act.data_ptr(),
                                out.data_ptr(), R.shape[0], R.shape[1],
                                model.shape[1], self._stream())
        if err:
            raise RuntimeError(f"paired launch failed: {err}")

    def serve_kernels(self) -> None:
        """Point the port's paired- and min-kernel wrappers at this set's
        entry points."""
        add_dist.min_kernel._fn = self.min
        add_dist.min_kernel.chunk = self.chunk
        add_dist.paired_kernel._fn = self.paired_entry


def sass_per_pair(lib: Path, split: tuple[int, int]) -> dict:
    """Lane instructions per (hypothesis, point) pair of the paired kernel
    at ``split`` (threads per hypothesis, hypotheses per thread), from
    ``cuobjdump -sass`` of ``lib``: of the innermost loops (backward branches
    with no other inside), the one holding the most ``MUFU.RSQ``, one per pair, its instructions over its
    ``MUFU.RSQ`` count, with the loop's opcodes counted."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    want = "paired_distILi{}ELi{}EE".format(*split)
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name = body.split("\n", 1)[0].strip()
        if want not in name:
            continue
        ins = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        loops = []   # (first, last) address of each backward branch's range
        for addr, op in ins:
            hit = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", op)
            if hit and int(hit.group(1), 16) < addr:
                loops.append((int(hit.group(1), 16), addr))
        best = None
        for lo, hi in loops:
            if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in loops):
                continue   # not innermost
            loop = [o for a, o in ins if lo <= a <= hi]
            rsq = sum("MUFU.RSQ" in o for o in loop)
            if rsq and (best is None or rsq > best[0]):
                best = (rsq, loop)
        if best is None:
            return {"function": name, "error": "no loop with MUFU.RSQ found",
                    "instructions": len(ins)}
        rsq, loop = best
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", o).split()[0] for o in loop)
        return {"function": name, "loop_instructions": len(loop),
                "pairs_per_iteration": rsq,
                "instructions_per_pair": len(loop) / rsq,
                "opcodes": dict(ops.most_common())}
    return {"error": f"no {want} in {lib}"}


def built_set(csrc: Path | None, out: Path | None) -> ScanSet:
    """nn.cu, add_dist.cu and adds_remap.cu of ``csrc`` (the package's by
    default), built by ``ops/build.py`` into ``out`` and loaded."""
    names = ("nn", "add_dist", "adds_remap")
    build.build_all(names, csrc, out)
    return ScanSet({n: ctypes.CDLL(str(build.library_path(n, csrc, out)))
                    for n in names})


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = cs.card_line()
    sets = {"change": built_set(None, None)}
    if args.parent is not None:
        sets["parent"] = built_set(
            args.parent, Path(tempfile.mkdtemp(prefix="scan_turns_")))
    order = (["parent", "change", "change", "parent"] if "parent" in sets
             else ["change", "change"])

    rng = np.random.default_rng(cs.SEED)

    def pts(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).cuda()

    q, r = pts(cs.KNN_QUERIES, 3), pts(cs.KNN_REFS, 3)
    q4 = pts(cs.TRAIN_SYM_ROWS, cs.NUM_POINTS * cs.NUM_MESH, 3)
    r4 = pts(cs.TRAIN_SYM_ROWS, cs.NUM_MESH, 3)
    b = cs.TRAIN_BATCH
    p1 = cs.pose_problem(rng, b, cs.NUM_POINTS, cs.NUM_MESH)
    ref = cs.pose_problem(rng, b, 1, cs.REFINE_MESH)
    first8 = (torch.arange(b, device="cuda") < cs.TRAIN_SYM_ROWS).int()
    last24 = 1 - first8
    spread = (torch.arange(b, device="cuda") % 4 == 0).int()
    none = torch.zeros(b, dtype=torch.int32, device="cuda")

    def outs(x):
        return (torch.empty(x.shape[:-1], device="cuda"),
                torch.empty(x.shape[:-1], dtype=torch.int64, device="cuda"))

    d1, d4 = outs(q), outs(q4)
    o1 = torch.empty((b, cs.NUM_POINTS, 13), device="cuda")
    o2 = torch.empty((b, 1, 13), device="cuda")
    main2 = cs.pose_problem(rng, b, cs.NUM_POINTS, cs.REFINE_MESH)
    o3 = torch.empty((b, cs.NUM_POINTS, 13), device="cuda")
    all_rows = torch.ones(b, dtype=torch.int32, device="cuda")
    rq, rr = pts(cs.BATCH, cs.NUM_MESH, 3), pts(cs.BATCH, cs.NUM_MESH, 3)
    gq, gr = pts(3, 1003, 3), pts(3, cs.REFINE_MESH, 3)
    gated = torch.tensor([1, 0, 1], dtype=torch.int32, device="cuda")

    def remap_outs(x):
        return (torch.empty(x.shape, device="cuda"),
                torch.empty(x.shape[:-1], device="cuda"))

    ro, go = remap_outs(rq), remap_outs(gq)
    no_rows = torch.zeros(cs.BATCH, dtype=torch.int32, device="cuda")
    work = {
        "nn (250000, 500)": (lambda s: s.knn(q, r, *d1), 200),
        "nn_batched (8, 500000, 500)": (lambda s: s.knn(q4, r4, *d4), 20),
        "paired phase 1 (32, 1000, 500)": (
            lambda s: s.paired_dist(*p1, last24, o1), 200),
        "paired phase-2 main loss (32, 1000, 2600)": (
            lambda s: s.paired_dist(*main2, all_rows, o3), 50),
        "paired refiner (32, 1, 2600)": (
            lambda s: s.paired_dist(*ref, last24, o2), 200),
        "min phase 1 (32, 1000, 500)": (
            lambda s: s.min_dist(*p1, first8, o1), 20),
        "min refiner (32, 1, 2600)": (
            lambda s: s.min_dist(*ref, first8, o2), 200),
        "min refiner, no active row": (
            lambda s: s.min_dist(*ref, none, o2), 200),
        "remap scoring (64, 500, 500)": (
            lambda s: s.adds_remap(rq, rr, None, *ro), 200),
        "remap (3, 1003, 2600), one gated row": (
            lambda s: s.adds_remap(gq, gr, gated, *go), 200),
        # per launch in a graph of 20: without the single-launch replay's
        # own cost, which bounds a short kernel's reading from below
        "remap scoring, per launch of 20 in one graph": (
            lambda s: [s.adds_remap(rq, rr, None, *ro) for _ in range(20)],
            20, 20),
        # every row gated: the launch and the zero writes alone
        "remap scoring, every row gated": (
            lambda s: s.adds_remap(rq, rr, no_rows, *ro), 200),
        "remap scoring, every row gated, per launch of 20 in one graph": (
            lambda s: [s.adds_remap(rq, rr, no_rows, *ro) for _ in range(20)],
            20, 20),
    }
    for s in sets.values():    # warm up, and fix each set's chunk
        for fn, *_ in work.values():
            fn(s)
    torch.cuda.synchronize()

    result = {"card": card, "clock_before": sm_clock(), "turns": {}}
    for name, (fn, replays, *per) in work.items():
        launches = per[0] if per else 1   # launches per call of fn
        readings = {k: [] for k in sets}
        for k in order:
            readings[k].append(cs.graph_ms(lambda: fn(sets[k]),
                                           replays=replays) / launches)
        result["turns"][name] = readings
        print(f"{name}: " + ", ".join(
            f"{k} {np.mean(v):.5f} ms {v}" for k, v in readings.items()),
            flush=True)

    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        create_train_state, make_pose_train_step, make_refine_train_step,
    )
    state = create_train_state(PoseNet(cs.NUM_OBJ), PoseRefineNet(cs.NUM_OBJ),
                               cs.LR, cs.SEED)
    trng = np.random.default_rng(cs.SEED + 2)
    steps = {
        "phase-1 step (32, M=500)": (
            make_pose_train_step(state, use_adds=True),
            cs.train_batch(trng, cs.TRAIN_BATCH, cs.NUM_MESH)),
        "phase-2 step (32, M=2600, K=2)": (
            make_refine_train_step(state, cs.REFINE_ITERS),
            cs.train_batch(trng, cs.TRAIN_BATCH, cs.REFINE_MESH)),
    }
    result["step_turns"] = {}
    for name, (step, batch) in steps.items():
        readings = {k: [] for k in sets}
        for _ in range(ROUNDS):
            for k in order:
                sets[k].serve_kernels()
                readings[k].append(cs.step_ms(step, batch))
        result["step_turns"][name] = readings
        print(f"{name}: " + ", ".join(
            f"{k} median {np.median(v):.3f} ms {[round(x, 3) for x in v]}"
            for k, v in readings.items()), flush=True)
    sets["change"].serve_kernels()

    probe = {}
    for k, s in sets.items():
        windows = [cs.graph_ms(lambda: s.min_dist(*ref, first8, o2),
                               replays=200) for _ in range(10)]
        spread_w = [cs.graph_ms(lambda: s.min_dist(*ref, spread, o2),
                                replays=200) for _ in range(5)]
        ev = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        single, idle = [], []
        for i in range(40):
            if i % 8 == 0:
                torch.cuda.synchronize()
                time.sleep(0.5)
            ev[0].record()
            s.min_dist(*ref, first8, o2)
            ev[1].record()
            torch.cuda.synchronize()
            (idle if i % 8 == 0 else single).append(
                ev[0].elapsed_time(ev[1]))
        probe[k] = {"graph_windows_ms": windows,
                    "graph_windows_spread_rows_ms": spread_w,
                    "single_launch_ms": single,
                    "single_after_idle_ms": idle, "clock": sm_clock()}
        print(f"refiner probe {k}: windows {windows}; active rows spread "
              f"{spread_w}; single median {np.median(single):.5f} ms; "
              f"after idle {idle}; clock {probe[k]['clock']}", flush=True)
    result["refiner_probe"] = probe
    result["paired_sass"] = sass_per_pair(
        build.library_path("add_dist"),
        add_dist.paired_split(cs.TRAIN_BATCH, cs.NUM_POINTS))
    print(f"paired SASS: {json.dumps(result['paired_sass'])}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": card, "turns_ms": {
        n: {k: float(np.mean(v)) for k, v in t.items()}
        for n, t in result["turns"].items()}, "step_turns_median_ms": {
        n: {k: float(np.median(v)) for k, v in t.items()}
        for n, t in result["step_turns"].items()}}))
    return result


if __name__ == "__main__":
    main()
