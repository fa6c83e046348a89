"""The whole LineMOD deployment pipeline of the PyTorch port on synthetic
data: SegNet -> masks -> PoseNet -> refinement, with NO ground truth
consumed at eval time.

The port's counterpart of ``examples/linemod_two_stage.py``, with the same
flags, defaults and ``--smoke`` sizes:

1. generate a domain-randomized LineMOD-format root,
2. train one multi-object SegNet (``cli.train_seg --format linemod``),
3. write its predicted masks for the eval frames into ``segnet_results/``
   (``cli.segment --binary_class`` per object); the generator's
   ground-truth copies are deleted first, so eval reads only predictions,
4. train PoseNet (+ the refiner through the curriculum) with
   ``cli.train``,
5. run ``cli.eval_linemod --mode eval``: boxes and clouds from the
   PREDICTED masks, ADD(-S) < 0.1 diameter success per object.

Runs on the card unless given ``--cpu`` (which passes ``--device cpu`` to
every CLI); without a card and without ``--cpu`` it raises before it
generates anything::

    python examples/gpu_linemod_two_stage.py --train_frames 200 --nepoch 40
    python examples/gpu_linemod_two_stage.py --cpu --smoke

Prints one JSON object: the JAX example's keys, plus the device, the
card's name and power limit, the float32 policy and the compute type.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CHECKPOINT_TAGS = ("checkpoint_best_refine", "checkpoint_best_pose",
                   "checkpoint_current")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--objlist", default="1,2,8,10",
                   help="comma-separated LineMOD object ids (10=eggbox "
                        "trains the symmetric ADD-S path)")
    p.add_argument("--train_frames", type=int, default=200,
                   help="training frames per object")
    p.add_argument("--test_frames", type=int, default=20,
                   help="eval frames per object (full test list; eval mode "
                        "does not subsample)")
    p.add_argument("--seg_epochs", type=int, default=8)
    p.add_argument("--seg_batch", type=int, default=8)
    p.add_argument("--seg_lr", type=float, default=5e-4,
                   help="segmenter Adam lr (the reference's 1e-4 assumes a "
                        "600-epoch budget, vanilla_segmentation/train.py:28, "
                        "and stays all-background at short budgets; 5e-4 is "
                        "also the cli.train_seg default for this format)")
    p.add_argument("--seg_fg_weight", type=float, default=30.0,
                   help="foreground CE weight for the segmenter (LineMOD "
                        "objects cover a few %% of the frame; unweighted CE "
                        "learns foreground too slowly at this budget)")
    p.add_argument("--nepoch", type=int, default=40)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--points", type=int, default=500)
    p.add_argument("--crop", type=int, default=192)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--argmax_masks", action="store_true",
                   help="derive masks from the plain argmax instead of the "
                        "default class-vs-background query (the LineMOD "
                        "eval protocol knows each test sequence's object, "
                        "tools/eval_linemod.py:64)")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--root", default="",
                   help="dataset/work directory (default: fresh tempdir)")
    p.add_argument("--out", default="", help="write the summary JSON here")
    p.add_argument("--bf16", action="store_true",
                   help="train the pose stage in bf16 compute (f32 master "
                        "params)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes/budget wiring check")
    args = p.parse_args(argv)

    objlist = tuple(int(x) for x in args.objlist.split(","))
    if args.smoke:
        objlist = (1, 10)
        args.train_frames, args.test_frames = 3, 2
        args.seg_epochs, args.seg_batch = 1, 2
        args.nepoch, args.batch = 1, 2
        args.points, args.crop, args.workers = 64, 64, 1

    from densefusion_tpu_torch.cli import eval_linemod as eval_linemod_cli
    from densefusion_tpu_torch.cli import segment as segment_cli
    from densefusion_tpu_torch.cli import train as train_cli
    from densefusion_tpu_torch.cli import train_seg as train_seg_cli
    from densefusion_tpu_torch.data import generate_linemod_style_dataset
    from densefusion_tpu_torch.device import resolve_device, run_record

    # fail fast: without a card and without --cpu this raises here, before
    # the dataset is generated, and never carries on on the CPU
    dev = resolve_device("cpu" if args.cpu else None)
    print(f"device: {dev}", flush=True)
    device_args = ["--device", "cpu"] if args.cpu else []

    work = args.root or tempfile.mkdtemp(prefix="lm_two_stage_")
    root = os.path.join(work, "dataset")
    obj_args = [str(o) for o in objlist]

    t0 = time.time()
    if not os.path.isdir(os.path.join(root, "models")):
        print(f"generating {args.train_frames}+{args.test_frames} frames x "
              f"{len(objlist)} objects -> {root}", flush=True)
        generate_linemod_style_dataset(
            root, objlist=objlist, n_train=args.train_frames,
            n_test=args.test_frames, seed=args.seed, realism=True)
    t_gen = time.time() - t0

    # -- stage 1: segmentation ---------------------------------------------
    seg_dir = os.path.join(work, "segnet")
    train_seg_cli.main([
        "--dataset_root", root, "--format", "linemod",
        "--objlist", *obj_args,
        "--batch_size", str(args.seg_batch),
        "--n_epochs", str(args.seg_epochs),
        "--lr", str(args.seg_lr),
        "--fg_weight", str(args.seg_fg_weight),
        "--workers", str(args.workers), "--seed", str(args.seed),
        "--out_dir", seg_dir, "--log_dir", os.path.join(work, "logs", "seg"),
    ] + device_args)
    t_seg = time.time() - t0 - t_gen

    # replace the generator's gt segnet_results with SegNet predictions for
    # the eval frames: from here on, eval consumes ONLY predicted masks
    sr = os.path.join(root, "segnet_results")
    shutil.rmtree(sr, ignore_errors=True)
    num_classes = max(objlist) + 1
    for obj in objlist:
        segment_cli.main([
            "--checkpoint", os.path.join(seg_dir, "segnet_best.msgpack"),
            "--images", os.path.join(root, "data", f"{obj:02d}", "rgb",
                                     "*.png"),
            "--list", os.path.join(root, "data", f"{obj:02d}", "test.txt"),
            "--out_dir", os.path.join(sr, f"{obj:02d}_label"),
            "--num_classes", str(num_classes),
            "--binary_class", str(obj),
        ] + ([] if args.argmax_masks else ["--class_vs_bg"]) + device_args)
    t_masks = time.time() - t0 - t_gen - t_seg

    # -- stage 2: pose ------------------------------------------------------
    train_cli.main((["--bf16"] if args.bf16 else []) + [
        "--dataset", "linemod", "--dataset_root", root,
        "--objlist", *obj_args,
        "--batch_size", str(args.batch), "--workers", str(args.workers),
        "--nepoch", str(args.nepoch), "--repeat_epoch", str(args.repeat),
        "--crop_size", str(args.crop), "--num_points", str(args.points),
        "--seed", str(args.seed),
        "--out_dir", os.path.join(work, "trained"),
        "--log_dir", os.path.join(work, "logs"),
    ] + device_args)
    t_pose = time.time() - t0 - t_gen - t_seg - t_masks

    ckpt_dir = os.path.join(work, "trained", "linemod")
    ckpt = next((os.path.join(ckpt_dir, tag) for tag in CHECKPOINT_TAGS
                 if os.path.isdir(os.path.join(ckpt_dir, tag))), None)
    if ckpt is None:
        raise SystemExit(f"no checkpoint produced under {ckpt_dir}")

    success = eval_linemod_cli.main([
        "--dataset_root", root, "--checkpoint", ckpt,
        "--mode", "eval", "--objlist", *obj_args,
        "--iterations", str(args.iterations),
        "--num_points", str(args.points), "--crop_size", str(args.crop),
        "--output_dir", os.path.join(work, "eval_out"),
    ] + device_args)
    with open(os.path.join(work, "eval_out", "result.json")) as f:
        eval_detail = json.load(f)

    n_masks = sum(
        len(glob.glob(os.path.join(sr, f"{o:02d}_label", "*.png")))
        for o in objlist)
    # seg-stage metrics for the summary: the best (lowest test loss) epoch's
    # pixel accuracy + foreground IoU from the train_seg metrics stream
    seg_best = None
    seg_metrics_path = os.path.join(work, "logs", "seg", "metrics.jsonl")
    if os.path.exists(seg_metrics_path):
        with open(seg_metrics_path) as f:
            epochs = [json.loads(ln) for ln in f if ln.strip()]
        epochs = [e for e in epochs if e.get("kind") == "seg_epoch"]
        if epochs:
            seg_best = min(epochs, key=lambda e: e["test_loss"])
    result = {
        "work_dir": work,
        "objlist": list(objlist),
        "checkpoint": os.path.basename(ckpt),
        "predicted_masks": n_masks,
        "seg_best_epoch": seg_best,
        "success_rate_0.1d": float(success),
        "eval": eval_detail,
        "gen_seconds": t_gen,
        "seg_seconds": t_seg,
        "mask_seconds": t_masks,
        "pose_seconds": t_pose,
        "total_seconds": time.time() - t0,
        **run_record(dev, "bfloat16" if args.bf16 else "float32"),
    }
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
