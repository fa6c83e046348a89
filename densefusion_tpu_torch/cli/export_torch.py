"""Export a checkpoint to reference torch ``.pth`` state_dicts (counterpart
of ``densefusion_tpu/cli/export_torch.py``: the same options, defaults and
messages).

The inverse of ``cli.import_torch``: converts a checkpoint directory of
either package into files the reference's ``PoseNet`` / ``PoseRefineNet``
load with ``load_state_dict(torch.load(...), strict=False)``
(``tools/train.py:83-97``; ``strict=False`` only because the reference
carries a dead aux classifier that is not written, ``lib/pspnet.py:
58-62``). Model shapes come from the checkpoint's own ``config.json``.
``--segnet_ckpt`` converts a ``segnet_best.msgpack``. Runs on the CPU (it
computes nothing).

Example::

    python -m densefusion_tpu_torch.cli.export_torch \\
        --checkpoint trained_models/ycb/checkpoint_best_refine \\
        --pose_out pose_model.pth --refine_out pose_refine_model.pth
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="framework checkpoint directory")
    p.add_argument("--pose_out", default=None, help="output PoseNet .pth")
    p.add_argument("--refine_out", default=None,
                   help="output PoseRefineNet .pth (optional)")
    p.add_argument("--segnet_ckpt", default=None,
                   help="segnet_best.msgpack from cli.train_seg")
    p.add_argument("--segnet_out", default=None, help="output SegNet .pth")
    p.add_argument("--num_classes", type=int, default=22,
                   help="SegNet class count (for --segnet_ckpt)")
    p.add_argument("--variant", default="resnet18")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.segnet_ckpt is not None:
        from densefusion_tpu_torch.compat import export_segnet_checkpoint

        if args.segnet_out is None:
            raise SystemExit("error: --segnet_ckpt requires --segnet_out")
        export_segnet_checkpoint(args.segnet_ckpt, args.segnet_out,
                                 num_classes=args.num_classes)
        print(f"exported -> {args.segnet_out} "
              f"(segnet, num_classes={args.num_classes})")
        return
    if args.checkpoint is None or args.pose_out is None:
        raise SystemExit("error: --checkpoint and --pose_out are required "
                         "(or use --segnet_ckpt/--segnet_out)")
    from densefusion_tpu_torch.compat import export_torch_checkpoint

    if not os.path.isdir(args.checkpoint):
        raise SystemExit(
            f"error: checkpoint directory not found: {args.checkpoint!r}")
    cfg = export_torch_checkpoint(args.checkpoint, args.pose_out,
                                  refine_out=args.refine_out,
                                  variant=args.variant)
    print(f"exported -> {args.pose_out}"
          + (f" + {args.refine_out}" if args.refine_out else "")
          + f" (dataset={cfg['dataset']}, num_obj={cfg['num_objects']})")


if __name__ == "__main__":
    main()
