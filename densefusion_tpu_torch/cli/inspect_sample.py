"""Dataset sample visual-QA CLI (counterpart of
``densefusion_tpu/cli/inspect_sample.py``; host-side, no device): dump a
sample's back-projected cloud, gt target, and model points as PLY files for
eyeballing alignment.

Capability parity with the reference's dataset sanity checks
(``datasets/customCAD/test.py:11-29`` writing ``depth_projected.ply`` /
``target.ply`` / ``model.ply``). Works for any of the dataset readers.

Example::

    python -m densefusion_tpu_torch.cli.inspect_sample --dataset linemod \
        --dataset_root /data/Linemod_preprocessed --index 0 --out_dir /tmp/qa
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="linemod",
                   choices=["ycb", "linemod", "cad"])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--mode", default="train")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--num_points", type=int, default=500)
    p.add_argument("--out_dir", default=".")
    args = p.parse_args(argv)

    import numpy as np
    from densefusion_tpu_torch.data import (
        LineModDataset, YCBDataset, CADDataset, write_ply,
    )

    cls = {"ycb": YCBDataset, "linemod": LineModDataset,
           "cad": CADDataset}[args.dataset]
    ds = cls(args.dataset_root, mode=args.mode, num_points=args.num_points,
             add_noise=False)
    s = ds[args.index]
    if not s.valid:
        raise SystemExit(f"sample {args.index}: lost detection (empty mask)")

    os.makedirs(args.out_dir, exist_ok=True)
    write_ply(os.path.join(args.out_dir, "depth_projected.ply"), s.points)
    write_ply(os.path.join(args.out_dir, "target.ply"), s.target)
    write_ply(os.path.join(args.out_dir, "model.ply"), s.model_points)
    d = np.linalg.norm(s.points[:, None] - s.target[None], axis=-1).min(1)
    print(f"sample {args.index}: obj {int(s.obj_idx)} sym {bool(s.sym)}")
    print(f"cloud->target mean NN distance: {d.mean() * 1000:.2f} mm "
          f"(should be small if gt/intrinsics are consistent)")
    print(f"wrote depth_projected.ply / target.ply / model.ply to "
          f"{args.out_dir}")
    return float(d.mean())


if __name__ == "__main__":
    main()
