"""FallingThings scene verification CLI (counterpart of
``densefusion_tpu/cli/verify_fat.py``, host only; capability parity with
``datasets/FallingThings/verify_fat.py`` / ``testfat_rescale.py``): checks
that ``model_points · fixed_model_transform · pose`` matches the depth-
back-projected segmentation cloud for every frame/object of a FAT scene.

Example::

    python -m densefusion_tpu_torch.cli.verify_fat \
        --scene datasets/FallingThings/power_drill_with_model \
        --model models/power_drill.ply --max_frames 5
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", required=True, help="FAT scene directory")
    p.add_argument("--model", required=True,
                   help="object model: .ply (ascii) or .xyz point list")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--threshold_m", type=float, default=0.01,
                   help="mean NN distance above this fails the frame")
    p.add_argument("--pose_source", choices=["permuted", "plain"],
                   default="permuted",
                   help="'plain' = pose_transform + location, the randomized"
                        "-scene convention (test_randomize.py)")
    p.add_argument("--depth_unit", choices=["tenth_mm", "normalized_10m"],
                   default="tenth_mm",
                   help="'normalized_10m' = 16-bit over a 10 m range "
                        "(RoomDemo scenes, 3d_reconstruct_combo.py)")
    p.add_argument("--check_quaternion", action="store_true",
                   help="also verify quaternion_xyzw reproduces the "
                        "permuted pose matrix (test_randomize.py QA)")
    args = p.parse_args(argv)

    import numpy as np
    from densefusion_tpu_torch.data.fat import verify_scene
    from densefusion_tpu_torch.data.ply import read_ply_vertices

    if args.model.endswith(".xyz"):
        model = np.loadtxt(args.model, dtype=np.float32)[:, :3]
    else:
        model = read_ply_vertices(args.model)

    results = verify_scene(args.scene, model, max_frames=args.max_frames,
                           pose_source=args.pose_source,
                           depth_unit=args.depth_unit,
                           check_quaternion=args.check_quaternion)
    n_fail = 0
    for r in results:
        status = r["status"]
        if status == "ok":
            ok = r["mean_nn_dist_m"] < args.threshold_m
            quat = r.get("quaternion")
            if quat is not None:
                ok = ok and quat["consistent"]
            n_fail += not ok
            extra = ""
            if quat is not None:
                extra = (f" quat {'OK' if quat['consistent'] else 'BAD'}"
                         f" ({quat['max_abs_err']:.2e})")
            print(f"{r['frame']} {r['class']}: mean NN "
                  f"{r['mean_nn_dist_m'] * 1000:.2f} mm "
                  f"{'PASS' if ok else 'FAIL'}{extra}")
        else:
            print(f"{r['frame']} {r['class']}: {status}")
    print(json.dumps({"frames": len(results), "failures": n_fail}))
    return n_fail


if __name__ == "__main__":
    raise SystemExit(main())
