"""Standalone YCB keyframe scorer + plots (counterpart of
``densefusion_tpu/cli/score_ycb.py``; host-side numpy, no device).

The in-repo replacement for the MATLAB post-processing stage
(``replace_ycb_toolbox/evaluate_poses_keyframe.m`` →
``results_keyframe.mat`` → ``plot_accuracy_keyframe.m``): scores existing
per-frame ``.mat`` pose-result directories against the dataset ground truth
with the exact toolbox protocol (gt-object iteration, ``inf`` for missed
detections, full model clouds, ``adi`` ADD-S direction, rotation/translation
errors) and renders per-class accuracy-threshold figures.

Example::

    python -m densefusion_tpu_torch.cli.score_ycb \
        --dataset_root /data/YCB_Video_Dataset \
        --posecnn_results YCB_Video_toolbox/results_PoseCNN_RSS2018 \
        --results iterative=eval_out/Densefusion_iterative_result \
        --results per-pixel=eval_out/Densefusion_wo_refine_result \
        --output_dir eval_out --plots
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--posecnn_results", required=True)
    p.add_argument("--results", action="append", required=True,
                   metavar="NAME=DIR",
                   help="method name = directory of %%04d.mat pose results "
                        "(repeatable)")
    p.add_argument("--num_keyframes", type=int, default=None)
    p.add_argument("--output_dir", default="experiments/eval_result/ycb")
    p.add_argument("--plots", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from densefusion_tpu_torch.eval.ycb_toolbox import (
        load_models, score_keyframes, summarize, plot_accuracy,
    )

    result_dirs = {}
    for spec in args.results:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--results expects NAME=DIR, got {spec!r}")
        result_dirs[name] = path

    os.makedirs(args.output_dir, exist_ok=True)
    classes, _ = load_models(args.dataset_root)
    results = score_keyframes(args.dataset_root, args.posecnn_results,
                              result_dirs, num_keyframes=args.num_keyframes)
    results.save_mat(os.path.join(args.output_dir, "results_keyframe.mat"))
    table = summarize(results, classes)
    with open(os.path.join(args.output_dir, "scores.json"), "w") as f:
        json.dump(table, f, indent=2)
    if args.plots:
        plot_accuracy(results, classes, os.path.join(args.output_dir, "plots"))
    for method in results.methods:
        row = table[method]["all"]
        print(f"{method}: ADD-S AUC {row['adds_auc']:.2f}  "
              f"ADD AUC {row['add_auc']:.2f}  "
              f"<2cm {row['adds_under_2cm']:.2f}  "
              f"detected {row['detected']}/{row['total']}")
    # immature-refiner tripwire: when the canonical refined/unrefined pair
    # is scored together (eval_ycb writes both), a refined AUC below the
    # per-pixel one means the refiner is hurting
    refined = [m for m in results.methods if "iter" in m.lower()]
    unrefined = [m for m in results.methods
                 if any(k in m.lower() for k in ("wo", "pixel", "norefine"))]
    if refined and unrefined:
        r, u = table[refined[0]]["all"], table[unrefined[0]]["all"]
        if r["adds_auc"] < u["adds_auc"]:
            print(f"WARNING: REFINEMENT DEGRADED ACCURACY — "
                  f"{refined[0]} ADD-S AUC {r['adds_auc']:.2f} < "
                  f"{unrefined[0]} {u['adds_auc']:.2f}. An immature refiner "
                  "amplifies its own error over iterations; report the "
                  "unrefined number or train the refine phase longer.")
    return table


if __name__ == "__main__":
    main()
