"""Import reference torch ``.pth`` checkpoints into a checkpoint of the
port (counterpart of ``densefusion_tpu/cli/import_torch.py``: the same
options, defaults and messages).

Converts the reference's ``torch.save(state_dict())`` files
(``trained_models/{ycb,linemod}/pose_model*.pth`` /
``pose_refine_model*.pth``) into a checkpoint directory in the JAX
package's format, which ``cli.train --resume``, every evaluation CLI,
``PoseEstimator.from_checkpoint`` and ``cli.export_program`` of either
package read; ``--segnet_model`` writes the ``.msgpack`` ``cli.segment``
reads. The conversion runs on the CPU (it computes nothing).

Example::

    python -m densefusion_tpu_torch.cli.import_torch \\
        --pose_model trained_models/ycb/pose_model_26_0.012863246640872631.pth \\
        --refine_model trained_models/ycb/pose_refine_model_69_0.009449292959118935.pth \\
        --dataset ycb --out trained_models/ycb/imported
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pose_model", default=None, help=".pth PoseNet weights")
    p.add_argument("--refine_model", default=None,
                   help=".pth PoseRefineNet weights (optional)")
    p.add_argument("--segnet_model", default=None,
                   help=".pth SegNet weights (vanilla_segmentation "
                        "checkpoints); --out becomes the .msgpack path "
                        "cli.segment consumes")
    p.add_argument("--num_classes", type=int, default=22,
                   help="SegNet class count (vanilla_segmentation default 22)")
    p.add_argument("--dataset", default="ycb",
                   choices=["ycb", "linemod", "cad"])
    p.add_argument("--num_obj", type=int, default=None,
                   help="override the dataset preset's object count")
    p.add_argument("--variant", default="resnet18")
    p.add_argument("--out", required=True,
                   help="output checkpoint directory (or .msgpack path for "
                        "--segnet_model)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (args.pose_model is None) == (args.segnet_model is None):
        raise SystemExit(
            "error: exactly one of --pose_model / --segnet_model is required")
    if args.segnet_model is not None:
        from densefusion_tpu_torch.compat import import_segnet_checkpoint

        import_segnet_checkpoint(args.segnet_model, args.out,
                                 num_classes=args.num_classes)
        print(f"imported -> {args.out} (segnet, "
              f"num_classes={args.num_classes})")
        return
    from densefusion_tpu_torch.compat import import_torch_checkpoint
    from densefusion_tpu_torch.utils.config import DATASET_PRESETS

    num_obj = args.num_obj or DATASET_PRESETS[args.dataset]["num_objects"]
    import_torch_checkpoint(
        args.pose_model, args.out, num_obj=num_obj,
        refine_pth=args.refine_model, variant=args.variant,
        dataset=args.dataset,
        num_points=DATASET_PRESETS[args.dataset]["num_points"])
    print(f"imported -> {args.out} (num_obj={num_obj}, "
          f"refiner={'yes' if args.refine_model else 'no'})")


if __name__ == "__main__":
    main()
