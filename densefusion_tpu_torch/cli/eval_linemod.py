"""LineMOD evaluation CLI (counterpart of
``densefusion_tpu/cli/eval_linemod.py``): SegNet-predicted masks ('eval'
mode) or gt masks ('test'), PoseNet and the refiner, ADD (ADD-S for eggbox
and glue) success at < 0.1 x the model's diameter, per object and
overall, per-pixel beside refined.

Example::

    python -m densefusion_tpu_torch.cli.eval_linemod \\
        --dataset_root /data/Linemod_preprocessed \\
        --checkpoint trained_models/linemod/checkpoint_best_refine

Runs on the card unless given ``--device cpu``. Writes
``eval_result_logs.txt`` and ``result.json`` (the JAX CLI's keys) into
``--output_dir``.
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--iterations", type=int, default=None,
                   help="refiner composition depth at eval. Default: the "
                        "checkpoint's trained refine_iters (4 when it has "
                        "no config); a refiner composed deeper than it was "
                        "trained diverges on predicted-mask clouds")
    p.add_argument("--num_points", type=int, default=500)
    p.add_argument("--crop_size", type=int, default=192)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--mode", default="eval", choices=["eval", "test"],
                   help="'eval' uses segnet_results masks; 'test' uses gt")
    p.add_argument("--output_dir", default="experiments/eval_result/linemod")
    p.add_argument("--objlist", type=int, nargs="*", default=None,
                   help="subset of LineMOD object ids (default: all 13)")
    p.add_argument("--num_mesh", type=int, default=500)
    p.add_argument("--native_crops", choices=("auto", "on", "off"),
                   default="auto",
                   help="feed variable ladder-shape crops (the reference's "
                        "input geometry) instead of resizing to "
                        "--crop_size; 'auto' turns it on for checkpoints "
                        "of the align-corners decoder (decoder='torch')")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from densefusion_tpu_torch.data import BatchLoader, LineModDataset
    from densefusion_tpu_torch.device import resolve_device
    from densefusion_tpu_torch.eval import (
        InferencePipeline, ShapeBucketedDispatcher, pose_distances,
    )
    from densefusion_tpu_torch.train.checkpoint import (
        clamp_refine_iters, load_models, peek_config, refine_step_count,
    )
    from densefusion_tpu_torch.utils.config import RunConfig
    from densefusion_tpu_torch.utils.logging import setup_logger

    device = resolve_device(args.device)
    if not os.path.isdir(args.dataset_root):
        raise SystemExit(
            f"error: dataset root not found: {args.dataset_root!r} "
            f"(expected the layout described in docs/DATA.md)")
    if not os.path.isdir(args.checkpoint):
        raise SystemExit(
            f"error: checkpoint directory not found: {args.checkpoint!r}")
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger(
        "eval_linemod", os.path.join(args.output_dir, "eval_result_logs.txt"))

    ck_cfg = peek_config(args.checkpoint)
    if args.iterations is None:
        args.iterations = getattr(ck_cfg, "refine_iters", None) or 4
        logger.info(f"--iterations defaulting to the checkpoint's trained "
                    f"composition depth: {args.iterations}")
    native = args.native_crops == "on" or (
        args.native_crops == "auto"
        and getattr(ck_cfg, "decoder", None) == "torch")

    ds = LineModDataset(args.dataset_root, mode=args.mode,
                        num_points=args.num_points, crop_size=args.crop_size,
                        num_mesh_points=args.num_mesh, objlist=args.objlist,
                        native_crop=native)
    diameters = ds.diameters() * 0.1   # the success thresholds

    num_obj = len(ds.objlist)
    cfg = ck_cfg or RunConfig.preset("linemod")
    args.iterations = clamp_refine_iters(args.checkpoint, args.iterations,
                                         logger)
    posenet, refiner = load_models(args.checkpoint, num_obj, cfg)
    # return_unrefined=True: the argmax-confidence hypothesis before
    # refinement and the refined pose from one pass, so per-pixel and
    # refined rates cost one forward
    pipe = InferencePipeline(posenet, refiner, refine_iters=args.iterations,
                             return_unrefined=True, device=device)

    def run(batch):
        q0, t0, quat, trans, _ = pipe(batch.img, batch.points, batch.choose,
                                      batch.obj_idx)
        model, target, sym = (torch.as_tensor(np.asarray(x), device=device)
                              for x in (batch.model_points, batch.target,
                                        batch.sym))
        return (pose_distances(model, q0, t0, target, sym),
                pose_distances(model, quat, trans, target, sym))

    # rows[i] = (dis0, dis) for sample i, or None for a lost detection
    rows: list = [None] * len(ds)
    if native:
        # variable ladder shapes: full batches per crop shape; the protocol's
        # statistics do not depend on the dispatch order
        disp = ShapeBucketedDispatcher(run, batch_size=args.batch_size)
        for i in range(len(ds)):
            s = ds[i]
            if not s.valid:
                continue
            for key, (d0, d) in disp.add(i, s):
                rows[key] = (float(d0), float(d))
        for key, (d0, d) in disp.flush_all():
            rows[key] = (float(d0), float(d))
        logger.info(f"native-crop dispatch: "
                    f"{len(disp.shapes_dispatched)} crop shapes")
    else:
        loader = BatchLoader(ds, args.batch_size, shuffle=False,
                             drop_last=False, num_workers=4)
        i = 0
        for batch in loader.epoch(0):
            dis0, dis = (d.cpu().numpy() for d in run(batch))
            for b in range(len(dis)):
                if batch.valid[b]:
                    rows[i] = (float(dis0[b]), float(dis[b]))
                i += 1

    success0 = np.zeros(num_obj)   # per-pixel (no refinement)
    success = np.zeros(num_obj)    # iterative (refined)
    counts = np.zeros(num_obj)
    dist_sum0 = np.zeros(num_obj)
    dist_sum = np.zeros(num_obj)
    lost = 0
    for frame, row in enumerate(rows):
        if row is None:
            logger.info(f"No.{frame} NOT Pass! Lost detection!")
            lost += 1
            continue
        o = ds.objlist.index(ds.items[frame][0])
        dis0, dis = row
        ok = dis < diameters[o]
        success0[o] += dis0 < diameters[o]
        success[o] += ok
        dist_sum0[o] += dis0
        dist_sum[o] += dis
        counts[o] += 1
        logger.info(f"No.{frame} {'Pass!' if ok else 'NOT Pass!'} "
                    f"Distance: {dis:.6f}")

    per_object = []
    for i, obj in enumerate(ds.objlist):
        n = counts[i]
        rate0 = success0[i] / n if n else float("nan")
        rate = success[i] / n if n else float("nan")
        logger.info(f"Object {obj} success rate: {rate} "
                    f"(per-pixel: {rate0})")
        per_object.append({
            "obj": int(obj),
            "count": int(n),
            "threshold_m": float(diameters[i]),
            "rate_per_pixel": float(rate0) if n else None,
            "rate_refined": float(rate) if n else None,
            "mean_dist_per_pixel": float(dist_sum0[i] / n) if n else None,
            "mean_dist_refined": float(dist_sum[i] / n) if n else None,
        })
    n_all = max(counts.sum(), 1)
    total0 = success0.sum() / n_all
    total = success.sum() / n_all
    logger.info(f"ALL success rate: {total} (per-pixel: {total0}, "
                f"lost detections: {lost})")
    if args.iterations and total < total0:
        steps = refine_step_count(args.checkpoint)
        logger.warning(
            f"REFINEMENT DEGRADED ACCURACY: refined {total:.4f} < per-pixel "
            f"{total0:.4f} at --iterations {args.iterations}. The "
            f"checkpoint's refiner has "
            f"{steps if steps is not None else 'an unknown number of'} "
            "training steps — an immature refiner composed over iterations "
            "amplifies its own error. Report the per-pixel number or train "
            "the refine phase longer.")
    result = {
        "rate_per_pixel": float(total0),
        "rate_refined": float(total),
        "lost_detections": int(lost),
        "iterations": int(args.iterations),
        "native_crops": bool(native),
        "per_object": per_object,
    }
    with open(os.path.join(args.output_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    return total


if __name__ == "__main__":
    main()
