"""The whole YCB protocol of the PyTorch port on synthetic data, as one run.

The port's counterpart of ``examples/ycb_e2e_synthetic.py``, with the same
flags, defaults and ``--smoke`` sizes. It chains the stages a user runs on
YCB-Video:

1. generate a multi-object YCB-Video-format root (``-color/-depth/-label``
   PNGs, ``-meta.mat``, ``models/*/points.xyz``) with fake-PoseCNN
   ``labels`` / ``rois`` ``.mat`` detections on the held-out keyframes;
2. train PoseNet (and, when the curriculum's gate fires, the refiner)
   through ``densefusion_tpu_torch.cli.train``;
3. score the best checkpoint with ``densefusion_tpu_torch.cli.eval_ycb``:
   per-keyframe ``.mat`` poses, the toolbox's ADD-S / ADD AUC and <2 cm,
   and the per-class accuracy plots.

Runs on the card unless given ``--cpu`` (which passes ``--device cpu`` to
every CLI); without a card and without ``--cpu`` it raises before it
generates anything::

    python examples/gpu_ycb_e2e_synthetic.py --train_frames 240 --nepoch 30
    python examples/gpu_ycb_e2e_synthetic.py --cpu --smoke

Prints one JSON object: the JAX example's keys, plus the device, the
card's name and power limit, the float32 policy and the compute type.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CHECKPOINT_TAGS = ("checkpoint_best_refine", "checkpoint_best_pose",
                   "checkpoint_current")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--classes", type=int, default=5)
    p.add_argument("--train_frames", type=int, default=240,
                   help="real-style training frames")
    p.add_argument("--syn_frames", type=int, default=60,
                   help="data_syn frames (background-composited branch)")
    p.add_argument("--objs_per_frame", type=int, default=2,
                   help="gt objects per generated frame (real YCB keyframes "
                        "carry ~3-6)")
    p.add_argument("--test_frames", type=int, default=24,
                   help="held-out keyframes scored by the toolbox protocol")
    p.add_argument("--nepoch", type=int, default=30)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--points", type=int, default=1000)
    p.add_argument("--crop", type=int, default=192)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--root", default="",
                   help="dataset/work directory (default: fresh tempdir)")
    p.add_argument("--out", default="", help="write the summary JSON here")
    p.add_argument("--bf16", action="store_true",
                   help="train with bf16 compute (f32 master params)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes/budget wiring check")
    args = p.parse_args(argv)

    if args.smoke:
        args.classes, args.train_frames, args.syn_frames = 2, 3, 1
        args.test_frames, args.nepoch, args.batch = 2, 1, 2
        args.points, args.crop, args.workers = 64, 64, 1

    from densefusion_tpu_torch.cli import eval_ycb as eval_ycb_cli
    from densefusion_tpu_torch.cli import train as train_cli
    from densefusion_tpu_torch.data.synthetic import (
        generate_ycb_style_dataset,
    )
    from densefusion_tpu_torch.device import resolve_device, run_record

    # raises without a card unless --cpu, before anything is generated
    dev = resolve_device("cpu" if args.cpu else None)
    device_args = ["--device", "cpu"] if args.cpu else []

    work = args.root or tempfile.mkdtemp(prefix="ycb_e2e_")
    root = os.path.join(work, "dataset")
    posecnn = os.path.join(work, "posecnn")
    out_dir = os.path.join(work, "eval_out")

    t0 = time.time()
    if not os.path.isdir(os.path.join(root, "dataset_config")):
        print(f"generating {args.train_frames}+{args.syn_frames} train / "
              f"{args.test_frames} keyframes, {args.classes} classes "
              f"-> {root}", flush=True)
        generate_ycb_style_dataset(
            root, n_classes=args.classes, n_real=args.train_frames,
            n_syn=args.syn_frames, n_test=args.test_frames,
            seed=args.seed, posecnn_dir=posecnn,
            objs_per_frame=args.objs_per_frame)
    t_gen = time.time() - t0

    train_cli.main((["--bf16"] if args.bf16 else []) + [
        "--dataset", "ycb", "--dataset_root", root,
        "--batch_size", str(args.batch), "--workers", str(args.workers),
        "--nepoch", str(args.nepoch), "--repeat_epoch", str(args.repeat),
        "--crop_size", str(args.crop), "--seed", str(args.seed),
        "--num_objects", str(args.classes),
        "--num_points", str(args.points),
        "--out_dir", os.path.join(work, "trained"),
        "--log_dir", os.path.join(work, "logs"),
    ] + device_args)
    t_train = time.time() - t0 - t_gen

    # best refined model if the curriculum reached phase 2, else best pose
    ckpt_dir = os.path.join(work, "trained", "ycb")
    ckpt = next((os.path.join(ckpt_dir, tag) for tag in CHECKPOINT_TAGS
                 if os.path.isdir(os.path.join(ckpt_dir, tag))), None)
    if ckpt is None:
        raise SystemExit(f"no checkpoint produced under {ckpt_dir}")

    # the per-class figures need matplotlib, which not every host has
    plots = importlib.util.find_spec("matplotlib") is not None
    summary = eval_ycb_cli.main([
        "--dataset_root", root, "--posecnn_results", posecnn,
        "--checkpoint", ckpt, "--iterations", str(args.iterations),
        "--num_points", str(args.points), "--crop_size", str(args.crop),
        "--num_keyframes", str(args.test_frames),
        "--output_dir", out_dir,
    ] + (["--plots"] if plots else []) + device_args)

    result = {
        "work_dir": work,
        "checkpoint": os.path.basename(ckpt),
        "adds_auc": summary["adds_auc"],
        "add_auc": summary["add_auc"],
        "adds_under_2cm": summary["adds_under_2cm"],
        "methods": summary["methods"],
        "gen_seconds": t_gen,
        "train_seconds": t_train,
        "total_seconds": time.time() - t0,
        "plots": plots,
        **run_record(dev, "bfloat16" if args.bf16 else "float32"),
    }
    print(json.dumps({k: v for k, v in result.items() if k != "methods"},
                     indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
