"""Pose-overlay renderer (counterpart of ``densefusion_tpu/cli/visualize.py``):
model points under the predicted pose projected into the frame beside the
ground truth, the truth in blue and the prediction in green (aligned poses
render teal).

All selected frames are estimated in one batched pipeline call.

Example::

    python -m densefusion_tpu_torch.cli.visualize --dataset linemod \\
        --dataset_root /data/Linemod_preprocessed \\
        --checkpoint trained_models/linemod/checkpoint_best_refine \\
        --frames 8 --output_dir vis/

Runs on the card unless given ``--device cpu``. Writes
``vis_<index>.png`` per frame into ``--output_dir``.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="linemod", choices=["ycb", "linemod"])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--mode", default="test", choices=["test", "eval"],
                   help="'eval' uses predicted masks where the dataset "
                        "supports them (linemod segnet_results)")
    p.add_argument("--frames", type=int, default=8,
                   help="number of frames (evenly spaced over the split)")
    p.add_argument("--iterations", type=int, default=2,
                   help="refinement iterations (0 = per-pixel result only)")
    p.add_argument("--crop_size", type=int, default=192)
    p.add_argument("--num_points", type=int, default=None)
    p.add_argument("--objlist", type=int, nargs="*", default=None,
                   help="linemod object-id subset (must match the checkpoint)")
    p.add_argument("--point_stride", type=int, default=3,
                   help="draw every k-th model point")
    p.add_argument("--output_dir", default="vis")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def _project(cloud, cam, shape):
    """(M, 3) meters -> integer (rows, cols) inside ``shape``, z > 0 only."""
    import numpy as np
    z = cloud[:, 2]
    ok = z > 1e-6
    u = cloud[:, 0] * cam.fx / np.where(ok, z, 1.0) + cam.cx
    v = cloud[:, 1] * cam.fy / np.where(ok, z, 1.0) + cam.cy
    rows = np.round(v).astype(np.int64)
    cols = np.round(u).astype(np.int64)
    keep = ok & (rows >= 0) & (rows < shape[0]) \
        & (cols >= 0) & (cols < shape[1])
    return rows[keep], cols[keep]


def _paint(img, rows, cols, color):
    """2x2 dots (img is HxWx3 uint8, mutated)."""
    import numpy as np
    for dr in (0, 1):
        for dc in (0, 1):
            r = np.clip(rows + dr, 0, img.shape[0] - 1)
            c = np.clip(cols + dc, 0, img.shape[1] - 1)
            img[r, c] = color


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    from PIL import Image

    from densefusion_tpu_torch.data import LineModDataset, YCBDataset, collate
    from densefusion_tpu_torch.device import resolve_device
    from densefusion_tpu_torch.eval import InferencePipeline
    from densefusion_tpu_torch.geometry import quat_to_matrix
    from densefusion_tpu_torch.train.checkpoint import (
        clamp_refine_iters, load_models, peek_config,
    )
    from densefusion_tpu_torch.utils.config import RunConfig

    device = resolve_device(args.device)
    if not os.path.isdir(args.dataset_root):
        raise SystemExit(f"error: dataset root not found: "
                         f"{args.dataset_root!r}")
    if not os.path.isdir(args.checkpoint):
        raise SystemExit(f"error: checkpoint directory not found: "
                         f"{args.checkpoint!r}")
    os.makedirs(args.output_dir, exist_ok=True)

    num_points = args.num_points or (1000 if args.dataset == "ycb" else 500)
    if args.dataset == "linemod":
        ds = LineModDataset(args.dataset_root, mode=args.mode,
                            num_points=num_points, add_noise=False,
                            crop_size=args.crop_size, objlist=args.objlist)
        num_obj = len(ds.objlist)
    else:
        ds = YCBDataset(args.dataset_root, mode="test",
                        num_points=num_points, add_noise=False,
                        crop_size=args.crop_size)
        num_obj = len(ds.classes)

    picks = np.unique(np.linspace(0, len(ds) - 1,
                                  min(args.frames, len(ds))).astype(int))
    samples, kept = [], []
    for idx in picks:
        s = ds[int(idx)]
        if s.valid:
            samples.append(s)
            kept.append(int(idx))
    if not samples:
        raise SystemExit("error: no valid samples in the selected frames")

    cfg = peek_config(args.checkpoint) or RunConfig.preset(
        args.dataset, num_points=num_points, crop_size=args.crop_size,
        num_objects=num_obj)
    args.iterations = clamp_refine_iters(args.checkpoint, args.iterations)
    posenet, refiner = load_models(args.checkpoint, num_obj, cfg)
    pipe = InferencePipeline(posenet, refiner, refine_iters=args.iterations,
                             device=device)
    batch = collate(samples)
    quat, trans, conf = pipe(batch.img, batch.points, batch.choose,
                             batch.obj_idx)
    R = quat_to_matrix(quat).cpu().numpy()
    trans, conf = trans.cpu().numpy(), conf.cpu().numpy()

    stride = max(1, args.point_stride)
    written = []
    for k, idx in enumerate(kept):
        rgb_path, cam = ds.frame_info(idx)
        with Image.open(rgb_path) as im:
            img = np.array(im.convert("RGB"))
        model = np.asarray(samples[k].model_points)[::stride]
        target = np.asarray(samples[k].target)[::stride]
        pred = model @ R[k].T + trans[k]
        _paint(img, *_project(target, cam, img.shape), (60, 90, 255))   # gt
        _paint(img, *_project(pred, cam, img.shape), (0, 220, 60))    # pred
        err = float(np.linalg.norm(pred - target, axis=-1).mean())
        out = os.path.join(args.output_dir, f"vis_{idx:05d}.png")
        Image.fromarray(img).save(out)
        written.append(out)
        print(f"{out}  obj={int(samples[k].obj_idx)} "
              f"conf={float(conf[k]):.3f} mean_add={err * 100:.2f}cm")
    return written


if __name__ == "__main__":
    main()
