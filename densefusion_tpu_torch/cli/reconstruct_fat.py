"""FAT whole-scene 3D reconstruction dump (counterpart of
``densefusion_tpu/cli/reconstruct_fat.py``, host only).

Capability parity with ``datasets/FallingThings/3d_reconstruct_combo.py``:
back-projects the FULL depth image of a frame to a scene cloud and dumps
``projected.ply`` (scene), ``target.ply`` (fixed+posed model) and
``identity.ply`` (canonical model) for visual alignment checking — the
fork's offline QA mechanism, without the open3d GUI dependency.

Example::

    python -m densefusion_tpu_torch.cli.reconstruct_fat --scene RoomDemo_static \
        --model models/1.ply --frame 000000.left --depth_unit normalized_10m \
        --out_dir /tmp/recon
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", required=True, help="FAT scene directory")
    p.add_argument("--model", default=None,
                   help="object model: .ply (ascii) or .xyz point list")
    p.add_argument("--frame", default=None,
                   help="frame key like 000000.left (default: first)")
    p.add_argument("--pose_source", choices=["permuted", "plain"],
                   default="permuted",
                   help="'plain' uses pose_transform + location "
                        "(the randomized-scene convention)")
    p.add_argument("--depth_unit", choices=["tenth_mm", "normalized_10m"],
                   default="tenth_mm")
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)

    import numpy as np
    from densefusion_tpu_torch.data.fat import FATScene, reconstruct_frame
    from densefusion_tpu_torch.data.ply import read_ply_vertices

    model = None
    if args.model:
        if args.model.endswith(".xyz"):
            model = np.loadtxt(args.model, dtype=np.float32)[:, :3]
        else:
            model = read_ply_vertices(args.model)

    scene = FATScene(args.scene)
    key = args.frame or scene.frames[0]
    out = reconstruct_frame(scene, key, model, pose_source=args.pose_source,
                            depth_unit=args.depth_unit, out_dir=args.out_dir)
    print(f"{key}: scene cloud {len(out['scene_cloud'])} pts, "
          f"{len(out['objects'])} objects -> {args.out_dir}")
    return out


if __name__ == "__main__":
    main()
