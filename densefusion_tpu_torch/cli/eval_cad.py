"""customCAD evaluation CLI (counterpart of
``densefusion_tpu/cli/eval_cad.py``): PoseNet and 4 refinement iterations
on the CAD test split, the ADD success rate at ``--success_threshold_m``,
and predicted / target point clouds of the first frames as PLY files for
visual inspection.

Example::

    python -m densefusion_tpu_torch.cli.eval_cad --dataset_root datasets/cad \\
        --checkpoint trained_models/cad/checkpoint_best_pose

Runs on the card unless given ``--device cpu``. Logs every frame's distance
into ``--output_dir``/eval_log.txt and returns the success rate.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--num_points", type=int, default=500)
    p.add_argument("--crop_size", type=int, default=192)
    p.add_argument("--success_threshold_m", type=float, default=0.01)
    p.add_argument("--dump_ply_frames", type=int, default=3,
                   help="dump pred/target clouds for the first N frames")
    p.add_argument("--output_dir", default="experiments/eval_result/cad")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from densefusion_tpu_torch.data import BatchLoader, CADDataset, write_ply
    from densefusion_tpu_torch.device import resolve_device
    from densefusion_tpu_torch.eval import InferencePipeline, pose_distances
    from densefusion_tpu_torch.geometry import quat_to_matrix
    from densefusion_tpu_torch.train.checkpoint import (
        clamp_refine_iters, load_models, peek_config,
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
    logger = setup_logger("eval_cad",
                          os.path.join(args.output_dir, "eval_log.txt"))

    ds = CADDataset(args.dataset_root, mode="test",
                    num_points=args.num_points, crop_size=args.crop_size)
    loader = BatchLoader(ds, 1, shuffle=False, drop_last=False, num_workers=1)
    num_obj = len(ds.objlist)
    cfg = peek_config(args.checkpoint) or RunConfig.preset(
        "cad", num_points=args.num_points, crop_size=args.crop_size)
    args.iterations = clamp_refine_iters(args.checkpoint, args.iterations,
                                         logger)
    posenet, refiner = load_models(args.checkpoint, num_obj, cfg)
    pipe = InferencePipeline(posenet, refiner, refine_iters=args.iterations,
                             device=device)

    successes, total = 0, 0
    for i, batch in enumerate(loader.epoch(0)):
        if not batch.valid[0]:
            logger.info(f"No.{i} Lost detection")
            continue
        quat, trans, _ = pipe(batch.img, batch.points, batch.choose,
                              batch.obj_idx)
        model, target, sym = (torch.as_tensor(x, device=device)
                              for x in (batch.model_points, batch.target,
                                        batch.sym))
        dis = float(pose_distances(model, quat, trans, target, sym)[0])
        ok = dis < args.success_threshold_m
        successes += ok
        total += 1
        logger.info(f"No.{i} {'Pass' if ok else 'FAIL'} dis {dis:.6f}")

        if i < args.dump_ply_frames:   # visual QA (tools/eval_cad.py:130-139)
            R = quat_to_matrix(quat)[0].cpu().numpy()
            pred = batch.model_points[0] @ R.T + trans[0].cpu().numpy()
            write_ply(os.path.join(args.output_dir, f"pred_pcld_{i}.ply"),
                      pred)
            write_ply(os.path.join(args.output_dir, f"target_pcld_{i}.ply"),
                      batch.target[0])

    rate = successes / max(total, 1)
    logger.info(f"success rate @ {args.success_threshold_m} m: {rate}")
    return rate


if __name__ == "__main__":
    main()
