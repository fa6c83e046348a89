#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's serving path, on one CUDA card.

    python3 examples/gpu_serving_profile.py [out.json] [--bf16]

Builds the same YCB-width estimator as ``chip_smoke.py`` (21 objects,
N=1000 points, 192 px crops, K=2, seeded random weights, full float32;
``--bf16``: the same weights with bf16 compute, as ``chip_smoke.py``
[4l] serves them, kernel 6's bf16 route in the decoder) and reports, for
one B=64 batch with its inputs already on the card:

* stage times by CUDA events: trunk, PSP pyramid, up1, up2, the sparse up3
  decode + final 1x1 + log-softmax, fusion + heads, the two refine
  iterations, and ``pose_distances`` (ADD / ADD-S through the remap kernel);
* a ``torch.profiler`` window over a few pipeline + scoring calls: the
  device's busy share of the wall time and the kernels that take it.

Prints one JSON object and writes it to ``out.json`` when given.
"""

from __future__ import annotations

import argparse
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
from densefusion_tpu_torch.data import collate  # noqa: E402
from densefusion_tpu_torch.eval import pose_distances  # noqa: E402


def _busy_ms(events) -> float:
    """Length of the union of the device kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3          # profiler times are in microseconds


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (the serving weights cast where used)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    rng = np.random.default_rng(cs.SEED)
    est, states = cs.seeded_estimator(rng)
    if args.bf16:
        from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
        from densefusion_tpu_torch.serve import PoseEstimator
        bf16 = torch.bfloat16
        est = PoseEstimator(
            PoseNet(cs.NUM_OBJ, dtype=bf16), PoseRefineNet(cs.NUM_OBJ,
                                                           dtype=bf16),
            *states, num_points=cs.NUM_POINTS, crop_size=cs.CROP,
            refine_iters=cs.REFINE_ITERS, seed=cs.SEED)
    posenet = est.pipeline.posenet
    frames = [cs.make_frame(rng) for _ in range(20)]
    b = collate(cs.batch_samples(est, frames, cs.BATCH))
    img = torch.as_tensor(b.img, device="cuda")
    pts = torch.as_tensor(b.points, device="cuda")
    choose = torch.as_tensor(b.choose, device="cuda").long()
    obj = torch.as_tensor(b.obj_idx, device="cuda").long()
    model = 0.05 * torch.randn(cs.BATCH, cs.NUM_MESH, 3, device="cuda")
    target = model + 0.01 * torch.randn_like(model)
    sym = torch.arange(cs.BATCH, device="cuda") % 4 == 0

    quat = torch.zeros(cs.BATCH, 4, device="cuda")
    quat[:, 0] = 1.0
    trans = torch.zeros(cs.BATCH, 3, device="cuda")
    psp = posenet.cnn.model.module
    x = img.permute(0, 3, 1, 2)
    with torch.no_grad():
        f, _ = psp.feats(x)
        p = psp.psp(f)
        u1 = psp.up_1(p)

        def score():
            q, t, _ = est.pipeline(img, pts, choose, obj)
            return pose_distances(model, q, t, target, sym)

        stages = {
            "trunk": lambda: psp.feats(x),
            "psp_pyramid": lambda: psp.psp(f),
            "up1": lambda: psp.up_1(p),
            "up2": lambda: psp.up_2(u1),
            "cnn_sparse_total": lambda: psp(img, choose),
            "posenet_total": lambda: posenet(img, pts, choose, obj),
            "pipeline_k2_total": lambda: est.pipeline(img, pts, choose, obj),
            "pose_distances": lambda: pose_distances(model, quat, trans,
                                                     target, sym),
        }
        ms = {k: cs.cuda_ms(fn, iters=10, warmup=2)
              for k, fn in stages.items()}
        ms["up3_sparse_decode"] = ms["cnn_sparse_total"] - (
            ms["trunk"] + ms["psp_pyramid"] + ms["up1"] + ms["up2"])
        ms["fusion_heads"] = ms["posenet_total"] - ms["cnn_sparse_total"]
        ms["refine_2_iters"] = ms["pipeline_k2_total"] - ms["posenet_total"]

        for _ in range(3):
            score()
        torch.cuda.synchronize()
        calls = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                score()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)

    busy = _busy_ms(prof.events())
    top = sorted(prof.key_averages(),
                 key=lambda e: e.self_device_time_total, reverse=True)[:20]
    result = {
        "card": cs.card_line(), "batch": cs.BATCH,
        "dtype": "bfloat16" if args.bf16 else "float32",
        "refine_iters": cs.REFINE_ITERS, "stage_ms": ms,
        "profiled_calls": calls, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
        "top_kernels": [
            {"name": e.key[:120], "calls": e.count,
             "device_ms_per_batch": e.self_device_time_total / 1e3 / calls}
            for e in top if e.self_device_time_total > 0],
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
