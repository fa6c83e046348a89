"""Serving soak of the PyTorch port: whole-frame multi-object pose
estimation over a YCB-format keyframe set in ONE long-lived process.

The port's counterpart of ``examples/serve_soak.py``, with the same flags
and defaults: per-frame ``PoseEstimator.estimate_frame`` dispatches
(variable detection counts), sustained over many passes, with the
process's RSS after each pass and, on the card, the caching allocator's
``memory_allocated()`` and ``memory_reserved()`` after each pass (where a
leak on the card shows). ``--format linemod`` serves one detection per
frame over the eval lists, with masks from ``segnet_results/``
predictions (the two-stage deployment shape).

Runs on the card unless given ``--cpu``; usage, after a train run has
produced a checkpoint::

    python examples/gpu_serve_soak.py --dataset_root WORK/dataset \\
        --checkpoint WORK/trained/ycb/checkpoint_best_refine --num_obj 5

Prints one JSON object: the JAX example's keys, the card's memory per
pass, the device, the card's name and power limit and the float32 policy.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS"):
                return int(ln.split()[1]) / 1024.0
    return float("nan")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_root", required=True,
                   help="YCB-format root (synthetic generator layout), or a "
                        "Linemod_preprocessed tree with --format linemod")
    p.add_argument("--format", default="ycb", choices=["ycb", "linemod"],
                   dest="fmt",
                   help="linemod: per-frame single-detection serving over "
                        "the eval lists, masks from segnet_results/ "
                        "predictions (the two-stage deployment shape)")
    p.add_argument("--objlist", default="1,2,4,5,6,8,9,10,11,12,13,14,15",
                   help="linemod format: object ids (index order must match "
                        "the checkpoint's training objlist)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--passes", type=int, default=5,
                   help="full passes over the keyframe list")
    p.add_argument("--num_points", type=int, default=1000)
    p.add_argument("--crop_size", type=int, default=192)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--num_obj", type=int, default=21)
    p.add_argument("--out", default="", help="summary JSON path")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from densefusion_tpu_torch.device import resolve_device, run_record
    from densefusion_tpu_torch.geometry.camera import LINEMOD_CAM, YCB_CAM_1
    from densefusion_tpu_torch.serve import PoseEstimator

    dev = resolve_device("cpu" if args.cpu else None)

    if args.fmt == "linemod":
        objlist = [int(x) for x in args.objlist.split(",")]
        est = PoseEstimator.from_checkpoint(
            args.checkpoint, num_obj=len(objlist),
            num_points=args.num_points, crop_size=args.crop_size,
            refine_iters=args.iterations, device=dev)
        decoded = []  # (rgb, depth, mask, obj_idx) per eval frame
        for obj in objlist:
            base = os.path.join(args.dataset_root, "data", f"{obj:02d}")
            with open(os.path.join(base, "test.txt")) as f:
                ids = [int(ln) for ln in f if ln.strip()]
            for fid in ids:
                rgb = np.asarray(Image.open(
                    os.path.join(base, "rgb", f"{fid:04d}.png")))[..., :3]
                depth = np.asarray(Image.open(
                    os.path.join(base, "depth", f"{fid:04d}.png")))
                mask = np.asarray(Image.open(os.path.join(
                    args.dataset_root, "segnet_results", f"{obj:02d}_label",
                    f"{fid:04d}_label.png")))
                if mask.ndim == 3:
                    mask = mask[..., 0]
                decoded.append((rgb, depth, mask == 255, objlist.index(obj)))

        # one detection per frame, or None for an empty predicted mask
        def serve(item):
            rgb, depth, mask, obj_idx = item
            return int(est.estimate(rgb, depth, mask, obj_idx, LINEMOD_CAM,
                                    unit_scale=1e-3) is not None)

        head = {"format": "linemod", "eval_frames": len(decoded)}
    else:
        cfg_dir = os.path.join(args.dataset_root, "dataset_config")
        with open(os.path.join(cfg_dir, "test_data_list.txt")) as f:
            frames = [ln.strip() for ln in f if ln.strip()]
        est = PoseEstimator.from_checkpoint(
            args.checkpoint, num_obj=args.num_obj,
            num_points=args.num_points, crop_size=args.crop_size,
            refine_iters=args.iterations, device=dev)

        def load(frame):
            base = os.path.join(args.dataset_root, frame)
            rgb = np.asarray(Image.open(base + "-color.png"))[..., :3]
            depth = np.asarray(Image.open(base + "-depth.png"))
            label = np.asarray(Image.open(base + "-label.png"))
            return rgb, depth, label

        # decode once; the soak measures the serving path, not PNG decode
        decoded = [load(f) for f in frames]

        # keyframes are video < 60 (tools/eval_ycb.py:37)
        def serve(item):
            return len(est.estimate_frame(*item, YCB_CAM_1))

        head = {"keyframes": len(frames)}

    cuda = dev.type == "cuda"
    # the warm-up pass meets every detection count once
    t0 = time.perf_counter()
    n_det_warm = sum(serve(item) for item in decoded)
    warmup_s = time.perf_counter() - t0
    rss_start = _rss_mb()

    rss_per_pass, allocated, reserved = [], [], []
    t0 = time.perf_counter()
    n_frames = n_dets = 0
    for _ in range(args.passes):
        for item in decoded:
            n_dets += serve(item)
            n_frames += 1
        rss_per_pass.append(_rss_mb())
        if cuda:
            allocated.append(torch.cuda.memory_allocated(dev))
            reserved.append(torch.cuda.memory_reserved(dev))
    dt = time.perf_counter() - t0

    summary = {
        **head,
        "passes": args.passes,
        "frames": n_frames,
        "detections": n_dets,
        "warmup_s": round(warmup_s, 1),
        "warmup_detections": n_det_warm,
        "sustained_frames_per_s": round(n_frames / dt, 2),
        "sustained_detections_per_s": round(n_dets / dt, 2),
        "rss_start_mb": round(rss_start, 1),
        "rss_per_pass_mb": [round(r, 1) for r in rss_per_pass],
        "rss_peak_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1),
        "rss_growth_last3_mb": round(
            rss_per_pass[-1] - rss_per_pass[-3], 1) if len(rss_per_pass) >= 3
        else None,
        # the caching allocator after each pass, in bytes (None on the CPU)
        "card_allocated_bytes_per_pass": allocated if cuda else None,
        "card_reserved_bytes_per_pass": reserved if cuda else None,
        "card_max_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if cuda else None),
        **run_record(dev),
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
