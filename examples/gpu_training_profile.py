#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training steps, on one CUDA card.

    python3 examples/gpu_training_profile.py [out.json]

Builds the training state of ``chip_smoke.py`` (21 objects, N=1000 points,
192 px crops, the JAX package's initializers from the seed, full float32)
and its bench-style batches, then reports:

* segment times by CUDA events, averaged over a few steps: for phase 1
  (B=32, M=500, ADD-S on 8 rows) the PoseNet forward in train mode, the
  loss, the backward and the Adam step; for phase 2 (B=32, M=2600, K=2)
  the frozen PoseNet forward with its loss, the two refiner iterations with
  their losses, the backward and the Adam step;
* a ``torch.profiler`` window over whole steps of each phase: the device's
  busy share of the wall time, the kernels that take it, and the share of
  the distance kernels (``csrc/add_dist.cu``).

Prints one JSON object and writes it to ``out.json`` when given.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from densefusion_tpu_torch.losses import pose_loss, refiner_loss  # noqa: E402
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet  # noqa: E402
from densefusion_tpu_torch.train import (  # noqa: E402
    create_train_state, make_pose_train_step, make_refine_train_step,
)

sys.path.insert(0, str(ROOT / "examples"))
from gpu_serving_profile import _busy_ms  # noqa: E402

DIST_KERNELS = ("paired_dist", "min_partial", "finalize")


class Segments:
    """Sums CUDA-event times of named segments over repeated steps."""

    def __init__(self):
        self.ms: dict[str, float] = {}
        self._events: list = []

    def mark(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._events.append((name, ev))

    def close(self) -> None:
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(self._events, self._events[1:]):
            self.ms[name] = self.ms.get(name, 0.0) + a.elapsed_time(b)
        self._events = []


def phase1_segments(state, batch, reps: int) -> dict:
    seg = Segments()
    valid = batch.valid.float()
    for _ in range(reps):
        seg.mark("start")
        state.posenet.train()
        out = state.posenet(batch.img, batch.points, batch.choose,
                            batch.obj_idx, generator=state.generator)
        seg.mark("posenet_forward")
        lo = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"],
                       batch.target, batch.model_points, batch.points,
                       batch.sym, cs.W, sample_weight=valid,
                       pred_c_logit=out["pred_c_logit"])
        seg.mark("loss_forward")
        state.optimizer.zero_grad(set_to_none=True)
        lo.loss.backward()
        seg.mark("backward")
        state.optimizer.step()
        seg.mark("adam")
        seg.close()
    return {k: v / reps for k, v in seg.ms.items()}


def phase2_segments(state, batch, reps: int) -> dict:
    seg = Segments()
    valid = batch.valid.float()
    for _ in range(reps):
        seg.mark("start")
        state.posenet.eval()
        with torch.no_grad():
            out = state.posenet(batch.img, batch.points, batch.choose,
                                batch.obj_idx)
            lo = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"],
                           batch.target, batch.model_points, batch.points,
                           batch.sym, cs.W, use_adds=False,
                           sample_weight=valid,
                           pred_c_logit=out["pred_c_logit"])
        seg.mark("posenet_forward_and_main_loss")
        total, pts, tgt = 0.0, lo.new_points, lo.new_target
        for _ in range(cs.REFINE_ITERS):
            res = state.refiner(pts, out["emb"], batch.obj_idx)
            rl = refiner_loss(res["pred_r"], res["pred_t"], tgt,
                              batch.model_points, pts, batch.sym,
                              sample_weight=valid)
            total = total + rl.loss
            pts, tgt = rl.new_points, rl.new_target
        seg.mark("refiner_forward_and_losses")
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        seg.mark("backward")
        state.optimizer.step()
        seg.mark("adam")
        seg.close()
    return {k: v / reps for k, v in seg.ms.items()}


def profile_steps(step, batch, calls: int) -> dict:
    for _ in range(2):
        step(batch, cs.W)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step(batch, cs.W)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy = _busy_ms(prof.events())
    avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    dist_ms = sum(e.self_device_time_total for e in avgs
                  if any(k in e.key for k in DIST_KERNELS)) / 1e3 / calls
    top = sorted(avgs, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    return {
        "profiled_steps": calls, "wall_ms_per_step": wall_ms / calls,
        "device_busy_ms_per_step": busy / calls,
        "device_idle_share": 1.0 - busy / wall_ms,
        "distance_kernels_ms_per_step": dist_ms,
        "top_kernels": [
            {"name": e.key[:120], "calls_per_step": e.count / calls,
             "device_ms_per_step": e.self_device_time_total / 1e3 / calls}
            for e in top],
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    rng = np.random.default_rng(cs.SEED + 2)
    state = create_train_state(PoseNet(cs.NUM_OBJ), PoseRefineNet(cs.NUM_OBJ),
                               cs.LR, cs.SEED)
    b1 = cs.train_batch(rng, cs.TRAIN_BATCH, cs.NUM_MESH)
    b2 = cs.train_batch(rng, cs.TRAIN_BATCH, cs.REFINE_MESH)

    step1 = make_pose_train_step(state, use_adds=True)
    step1(b1, cs.W)
    p1 = phase1_segments(state, b1, reps=5)
    prof1 = profile_steps(step1, b1, calls=3)
    step2 = make_refine_train_step(state, cs.REFINE_ITERS)
    step2(b2, cs.W)
    p2 = phase2_segments(state, b2, reps=5)
    prof2 = profile_steps(step2, b2, calls=3)
    result = {
        "card": cs.card_line(), "batch": cs.TRAIN_BATCH,
        "phase1": {"mesh": cs.NUM_MESH, "segment_ms": p1,
                   "step_ms": sum(p1.values()), **prof1},
        "phase2": {"mesh": cs.REFINE_MESH, "refine_iters": cs.REFINE_ITERS,
                   "segment_ms": p2, "step_ms": sum(p2.values()), **prof2},
    }
    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(text)


if __name__ == "__main__":
    main()
