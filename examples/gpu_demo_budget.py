"""The deployment demos of the PyTorch port at their real budgets on the
card, one after another, each in a process of its own as a user runs them,
and what their logs say about learning.

Stages (``--stages``, in this order):

* ``ycb``: ``examples/gpu_ycb_e2e_synthetic.py`` at the real-budget flags
  (21 classes, 2400 + 480 frames, 120 keyframes, 40 epochs, B=8, N=1000,
  192 px, K=2, 4 workers, ``--seed``, 1 by default); then ``ycb_soak``:
  ``examples/gpu_serve_soak.py``, 5 passes on its root and checkpoint;
* ``linemod``: ``examples/gpu_linemod_two_stage.py`` at its defaults
  (objects 1, 2, 8, 10; 200 + 20 frames; SegNet 8 epochs at 480x640; pose
  40 epochs at B=8); then ``linemod_soak``: 5 passes on its predicted
  masks and checkpoint;
* ``ab``: ``examples/gpu_ab_bf16_convergence.sh`` at its defaults (25
  epochs each).

For each training run: the per-epoch test ``avg_dis`` with its phase, the
epoch at which the lr / w decay gate fired (the first test ``avg_dis``
below ``--decay_margin``, 0.03) and the refine gate (below 0.02); for the
two-stage run also the per-object IoU of the predicted masks against the
generator's ground truth. Writes ``<out>/budget.json`` (each stage's JSON,
exit code and seconds, with the card's name and power limit) and each
stage's output to ``<out>/<stage>.log``; the roots, checkpoints and
evaluation files go to ``--work`` (a fresh temporary directory by
default), and each pipeline's are deleted after its soak::

    python examples/gpu_demo_budget.py OUT
    python examples/gpu_demo_budget.py OUT --stages linemod linemod_soak
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STAGES = ("ycb", "ycb_soak", "linemod", "linemod_soak", "ab")
YCB_FLAGS = ["--classes", "21", "--train_frames", "2400", "--syn_frames",
             "480", "--test_frames", "120", "--nepoch", "40", "--batch", "8",
             "--points", "1000", "--crop", "192", "--iterations", "2",
             "--workers", "4"]
LM_OBJECTS = (1, 2, 8, 10)
DECAY_MARGIN, REFINE_MARGIN = 0.03, 0.02


def curve(metrics_path: str) -> dict:
    """Per-epoch test ``avg_dis`` and phase, and the curriculum's gate
    epochs, from a ``cli.train`` ``metrics.jsonl``: the decay gate fires
    after the first epoch whose test ``avg_dis`` is below the decay margin,
    the refine gate after the last epoch of the pose phase (the first below
    the refine margin)."""
    with open(metrics_path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    test = [r for r in rows if r["kind"] == "test_epoch"]
    train = {r["epoch"]: r for r in rows if r["kind"] == "train_epoch"}
    pose = [r for r in test if r["phase"] == "pose"]
    decay = next((r["epoch"] for r in pose if r["avg_dis"] < DECAY_MARGIN),
                 None)
    refine = next((r["epoch"] for r in pose if r["avg_dis"] < REFINE_MARGIN),
                  None)
    return {
        "test_avg_dis": [[r["epoch"], r["phase"], r["avg_dis"]]
                         for r in test],
        "decay_epoch": decay, "refine_epoch": refine,
        "best_pose": min((r["avg_dis"] for r in pose), default=None),
        "best_refine": min((r["avg_dis"] for r in test
                            if r["phase"] == "refine"), default=None),
        "train_seconds_per_epoch": [train[e]["seconds"] for e in
                                    sorted(train)],
        "input_wait_s_per_epoch": [train[e]["input_wait_s"] for e in
                                   sorted(train)],
    }


def mask_iou(root: str, objs) -> dict:
    """Per object: test frames, non-empty predicted masks, and the IoU of
    the predicted masks (``segnet_results/``) against the ground truth
    (``data/<obj>/mask``) over all test frames."""
    import numpy as np
    from PIL import Image

    out = {}
    for obj in objs:
        base = os.path.join(root, "data", f"{obj:02d}")
        with open(os.path.join(base, "test.txt")) as f:
            frames = [int(ln) for ln in f if ln.strip()]
        inter = union = nonempty = 0
        for fr in frames:
            pred = np.array(Image.open(os.path.join(
                root, "segnet_results", f"{obj:02d}_label",
                f"{fr:04d}_label.png"))) == 255
            gt = np.array(Image.open(os.path.join(
                base, "mask", f"{fr:04d}.png"))) == 255
            if gt.ndim == 3:
                gt = gt[..., 0]
            nonempty += bool(pred.any())
            inter += int((pred & gt).sum())
            union += int((pred | gt).sum())
        out[obj] = {"frames": len(frames), "nonempty": nonempty,
                    "iou": inter / max(union, 1)}
    return out


def run_stage(name: str, cmd: list, out: str, results: dict) -> int:
    """Run one stage's command with its output in ``<out>/<name>.log``,
    its exit code and seconds into ``results[name]``; returns the code."""
    t0 = time.time()
    log = os.path.join(out, f"{name}.log")
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=REPO, stdout=f, stderr=subprocess.STDOUT
                            ).returncode
    results[name] = {"rc": rc, "seconds": time.time() - t0,
                     "command": " ".join(cmd)}
    print(f"{name}: rc {rc}, {time.time() - t0:.1f} s", flush=True)
    return rc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out")
    p.add_argument("--stages", nargs="*", default=list(STAGES),
                   choices=STAGES)
    p.add_argument("--work", default="",
                   help="roots and checkpoints (default: fresh tempdir)")
    p.add_argument("--seed", type=int, default=1,
                   help="the ycb stage's seed (the JAX record's: 1)")
    args = p.parse_args(argv)

    from densefusion_tpu_torch.device import card_line

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    work = os.path.abspath(args.work or tempfile.mkdtemp(prefix="budget_"))
    results = {"card": card_line(), "work": work}
    py = sys.executable
    ycb, lm = os.path.join(work, "ycb"), os.path.join(work, "linemod")

    def read(path):
        with open(path) as f:
            return json.load(f)

    def checkpoint(summary_path, sub):
        work = read(summary_path)["work_dir"]
        return os.path.join(work, "trained", sub,
                            read(summary_path)["checkpoint"])

    def run_one(stage):
        if stage == "ycb":
            if not run_stage(stage, [py, "examples/gpu_ycb_e2e_synthetic.py",
                                     *YCB_FLAGS, "--seed", str(args.seed),
                                     "--root", ycb, "--out",
                                     ycb + ".json"], out, results):
                results[stage]["result"] = read(ycb + ".json")
                results[stage]["curve"] = curve(os.path.join(
                    ycb, "logs", "ycb", "metrics.jsonl"))
        elif stage == "ycb_soak":
            if not run_stage(stage, [
                    py, "examples/gpu_serve_soak.py", "--dataset_root",
                    os.path.join(ycb, "dataset"), "--checkpoint",
                    checkpoint(ycb + ".json", "ycb"), "--num_obj", "21",
                    "--passes", "5", "--out", ycb + "_soak.json"],
                    out, results):
                results[stage]["result"] = read(ycb + "_soak.json")
            shutil.rmtree(ycb, ignore_errors=True)
        elif stage == "linemod":
            if not run_stage(stage, [py, "examples/gpu_linemod_two_stage.py",
                                     "--root", lm, "--out", lm + ".json"],
                             out, results):
                results[stage]["result"] = read(lm + ".json")
                results[stage]["curve"] = curve(os.path.join(
                    lm, "logs", "linemod", "metrics.jsonl"))
                results[stage]["masks"] = mask_iou(
                    os.path.join(lm, "dataset"), LM_OBJECTS)
        elif stage == "linemod_soak":
            if not run_stage(stage, [
                    py, "examples/gpu_serve_soak.py", "--format", "linemod",
                    "--objlist", ",".join(map(str, LM_OBJECTS)),
                    "--dataset_root", os.path.join(lm, "dataset"),
                    "--checkpoint", checkpoint(lm + ".json", "linemod"),
                    "--num_points", "500", "--passes", "5", "--out",
                    lm + "_soak.json"], out, results):
                results[stage]["result"] = read(lm + "_soak.json")
            shutil.rmtree(lm, ignore_errors=True)
        elif stage == "ab":
            ab = os.path.join(work, "ab")
            if not run_stage(stage, ["sh", "examples/gpu_ab_bf16_convergence"
                                     ".sh", ab, "25"], out, results):
                with open(os.path.join(out, "ab.log")) as f:
                    last = [ln for ln in f if ln.startswith("{")][-1]
                results[stage]["result"] = json.loads(last)
                results[stage]["curves"] = {
                    mode: curve(os.path.join(ab, f"logs_{mode}", "ycb",
                                             "metrics.jsonl"))
                    for mode in ("f32", "bf16")}
            shutil.rmtree(ab, ignore_errors=True)

    for stage in args.stages:
        try:
            run_one(stage)
        except Exception as e:   # a stage's failure leaves the others to run
            results.setdefault(stage, {})["error"] = repr(e)
            print(f"{stage}: {e!r}", flush=True)
        with open(os.path.join(out, "budget.json"), "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "result"}
                      if isinstance(v, dict) else v
                      for k, v in results.items()}, indent=1))
    return results


if __name__ == "__main__":
    main()
