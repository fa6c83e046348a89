"""YCB-Video keyframe evaluation CLI (counterpart of
``densefusion_tpu/cli/eval_ycb.py``), in two stages:

1. **Inference**: PoseNet and the refiner on every PoseCNN detection of the
   keyframes, writing the per-frame ``.mat`` pose results
   (``Densefusion_wo_refine_result`` / ``Densefusion_iterative_result``,
   ``poses`` (n_rois, 7): wxyz quaternion, translation, in roi order).
2. **Scoring**: the toolbox protocol of
   :mod:`densefusion_tpu_torch.eval.ycb_toolbox` (gt-object iteration,
   misses ``inf``, full model clouds, ``adi`` ADD-S, VOCap AUC and <2cm)
   into ``results_keyframe.mat`` and ``metrics.json``. Stage 2 alone is
   ``cli.score_ycb``.

Example::

    python -m densefusion_tpu_torch.cli.eval_ycb \\
        --dataset_root /data/YCB_Video_Dataset \\
        --posecnn_results YCB_Video_toolbox/results_PoseCNN_RSS2018 \\
        --checkpoint trained_models/ycb/checkpoint_best_refine

Runs on the card unless given ``--device cpu``. Where it differs from the
JAX CLI, by design: every ``.mat`` is written atomically (a temporary file
renamed over the result), ``--skip_done`` logs a warning on the routes that
ignore it (native crops, ``--dispatch detection``), and the output
directory carries ``run_stamp.json`` (checkpoint, iterations, points, crop
size, native crops): ``--skip_done`` refuses a directory whose stamp
differs, or one with results and no stamp, and every run that recomputes
all keyframes first deletes the ``.mat`` results it finds there, so a
directory never holds the results of two runs. ``main(timings=)`` fills a
dict with the stages' seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import time

STAMP = "run_stamp.json"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--posecnn_results", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--iterations", type=int, default=None,
                   help="refiner composition depth at eval. Default: the "
                        "checkpoint's trained refine_iters (2 when it has "
                        "no config); a refiner composed deeper at eval than "
                        "trained diverges")
    p.add_argument("--num_points", type=int, default=1000)
    p.add_argument("--crop_size", type=int, default=192)
    p.add_argument("--num_keyframes", type=int, default=2949)
    p.add_argument("--skip_done", action="store_true",
                   help="frame dispatch: skip keyframes whose per-frame "
                        "result .mat files already exist in the output "
                        "dirs (resume a long eval in a fresh process); "
                        "refused when the directory's run stamp differs")
    p.add_argument("--output_dir", default="experiments/eval_result/ycb")
    p.add_argument("--plots", action="store_true",
                   help="write per-class accuracy-threshold figures")
    p.add_argument("--dispatch", choices=("frame", "detection"),
                   default="frame",
                   help="'frame' (default): one pipeline call per keyframe, "
                        "its detections padded to a small static bucket, "
                        "unrefined and refined poses from one pass. "
                        "'detection': the reference-shaped batch-1-per-roi "
                        "loop.")
    p.add_argument("--native_crops", choices=("auto", "on", "off"),
                   default="auto",
                   help="feed variable ladder-shape crops (the reference's "
                        "input geometry) instead of resizing to "
                        "--crop_size; 'auto' turns it on for checkpoints of "
                        "the align-corners decoder (decoder='torch'). "
                        "Overrides --dispatch with shape-bucketed batching.")
    p.add_argument("--batch_size", type=int, default=8,
                   help="shape-bucket batch size for --native_crops")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


# static batch buckets: PoseCNN emits <= ~10 detections per frame (21
# classes); padding to the next bucket keeps the batch shapes few
_BUCKETS = (1, 2, 4, 8, 16, 32)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 31) // 32) * 32


def _check_stamp(output_dir: str, stamp: dict, result_dirs) -> None:
    """``--skip_done`` resumes only a directory written by the same run:
    refuse one whose stamp differs, or one that holds results and no
    stamp."""
    path = os.path.join(output_dir, STAMP)
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old != stamp:
            raise SystemExit(
                f"error: --skip_done: {output_dir!r} holds results of "
                f"another run ({old}, this run {stamp}); use a fresh "
                "--output_dir or drop --skip_done")
    elif any(name.endswith(".mat") for d in result_dirs
             for name in os.listdir(d)):
        raise SystemExit(
            f"error: --skip_done: {output_dir!r} holds results without a "
            f"{STAMP}; their run cannot be checked")


def _clear_results(output_dir: str, result_dirs) -> None:
    """Drop the stamp, then every ``.mat`` result: a run that recomputes all
    keyframes leaves none of an earlier run's behind for a resume to
    take."""
    path = os.path.join(output_dir, STAMP)
    if os.path.exists(path):
        os.remove(path)
    for d in result_dirs:
        for name in os.listdir(d):
            if name.endswith(".mat"):
                os.remove(os.path.join(d, name))


def main(argv=None, timings: dict | None = None):
    """Run both stages -> ``metrics.json``'s summary. ``timings``, when
    given, receives the seconds of the set-up (checkpoint, models,
    dataset), of stage 1 (``infer_s``; ``first_keyframe_s`` on the frame and
    detection routes), of loading the model clouds for scoring
    (``models_s``) and of stage 2 (``score_s``), and ``keyframes``."""
    t_start = time.perf_counter()
    args = build_parser().parse_args(argv)
    import numpy as np

    from densefusion_tpu_torch.data import collate
    from densefusion_tpu_torch.data.schema import PoseSample
    from densefusion_tpu_torch.data.ycb import YCBPoseCNNEvalDataset
    from densefusion_tpu_torch.device import resolve_device
    from densefusion_tpu_torch.eval import (
        InferencePipeline, ShapeBucketedDispatcher,
    )
    from densefusion_tpu_torch.eval.ycb_toolbox import (
        load_models as load_model_clouds, plot_accuracy, save_mat_atomic,
        score_keyframes, summarize, write_atomic,
    )
    from densefusion_tpu_torch.train.checkpoint import (
        clamp_refine_iters, load_models, peek_config, refiner_is_trained,
    )
    from densefusion_tpu_torch.utils.config import RunConfig
    from densefusion_tpu_torch.utils.logging import setup_logger

    device = resolve_device(args.device)
    wo_dir = os.path.join(args.output_dir, "Densefusion_wo_refine_result")
    it_dir = os.path.join(args.output_dir, "Densefusion_iterative_result")
    os.makedirs(wo_dir, exist_ok=True)
    os.makedirs(it_dir, exist_ok=True)
    logger = setup_logger("eval_ycb",
                          os.path.join(args.output_dir, "eval_log.txt"))

    # the checkpoint's own architecture flags (e.g. decoder="torch")
    ck_cfg = peek_config(args.checkpoint)
    if args.iterations is None:
        args.iterations = getattr(ck_cfg, "refine_iters", None) or 2
        logger.info(f"--iterations defaulting to the checkpoint's trained "
                    f"composition depth: {args.iterations}")
    native = args.native_crops == "on" or (
        args.native_crops == "auto"
        and getattr(ck_cfg, "decoder", None) == "torch")

    ds = YCBPoseCNNEvalDataset(args.dataset_root, args.posecnn_results,
                               num_points=args.num_points,
                               crop_size=args.crop_size,
                               num_keyframes=args.num_keyframes,
                               native_crop=native)
    num_obj = len(ds.classes)
    cfg = ck_cfg or RunConfig.preset("ycb", num_points=args.num_points,
                                     crop_size=args.crop_size)
    refiner_trained = refiner_is_trained(args.checkpoint)
    args.iterations = clamp_refine_iters(args.checkpoint, args.iterations,
                                         logger)
    posenet, refiner = load_models(args.checkpoint, num_obj, cfg)

    stamp = {"checkpoint": os.path.abspath(args.checkpoint),
             "iterations": args.iterations, "num_points": args.num_points,
             "crop_size": args.crop_size, "native_crops": native}
    frame_route = not native and args.dispatch == "frame"
    if args.skip_done and frame_route:
        _check_stamp(args.output_dir, stamp, (wo_dir, it_dir))
    else:
        if args.skip_done:
            logger.warning(
                "--skip_done is ignored by the "
                f"{'native-crop' if native else 'detection'} route: every "
                "keyframe is recomputed")
        _clear_results(args.output_dir, (wo_dir, it_dir))
    write_atomic(os.path.join(args.output_dir, STAMP),
                 lambda f: f.write(json.dumps(stamp, indent=2).encode()))
    times = {"keyframes": len(ds)}
    t_infer = time.perf_counter()
    times["setup_s"] = t_infer - t_start

    def save(frame_idx, wo_poses, it_poses):
        save_mat_atomic(os.path.join(wo_dir, f"{frame_idx:04d}.mat"),
                        {"poses": wo_poses})
        save_mat_atomic(os.path.join(it_dir, f"{frame_idx:04d}.mat"),
                        {"poses": it_poses})

    def pose_rows(q, t):
        return np.concatenate([q.cpu().numpy(), t.cpu().numpy()], axis=1)

    # -- stage 1: pose inference over PoseCNN detections -------------------
    if native:
        # variable ladder shapes: shape-bucketed batches across keyframes;
        # the poses stay in memory and the .mat files are written in frame
        # order at the end
        pipe = InferencePipeline(posenet, refiner,
                                 refine_iters=args.iterations,
                                 return_unrefined=True, device=device)

        def run(batch):
            q0, t0, q, t, _ = pipe(batch.img, batch.points, batch.choose,
                                   batch.obj_idx)
            return q0, t0, q, t

        disp = ShapeBucketedDispatcher(run, batch_size=args.batch_size)
        wo_all: dict[int, list] = {}
        it_all: dict[int, list] = {}

        def store(key, res):
            f, k = key
            q0, t0, q, t = res
            wo_all[f][k] = np.concatenate([q0, t0]).tolist()
            it_all[f][k] = np.concatenate([q, t]).tolist()

        for frame_idx in range(len(ds)):
            dets = ds.detections(frame_idx)
            wo_all[frame_idx] = [[0.0] * 7 for _ in dets]
            it_all[frame_idx] = [[0.0] * 7 for _ in dets]
            for k, (s, _, _) in enumerate(dets):
                if not s.valid:
                    continue
                for key, res in disp.add((frame_idx, k), s):
                    store(key, res)
            if frame_idx % 100 == 0:
                logger.info(f"Read No.{frame_idx} keyframe")
        for key, res in disp.flush_all():
            store(key, res)
        logger.info(f"native-crop dispatch: "
                    f"{len(disp.shapes_dispatched)} crop shapes")
        for frame_idx in range(len(ds)):
            save(frame_idx, wo_all[frame_idx], it_all[frame_idx])
    elif frame_route:
        # one pipeline call per keyframe gives the unrefined (wo_refine) and
        # the refined (iterative) poses of all its detections
        pipe = InferencePipeline(posenet, refiner,
                                 refine_iters=args.iterations,
                                 return_unrefined=True, device=device)
        mesh_m = 500  # detections carry 500-point model clouds (ycb.py)
        for frame_idx in range(len(ds)):
            if args.skip_done and all(
                    os.path.exists(os.path.join(d, f"{frame_idx:04d}.mat"))
                    for d in (wo_dir, it_dir)):
                continue
            dets = ds.detections(frame_idx)
            # lost detections -> zero pose, as the reference falls back;
            # the scorer treats a zero pose as a failure
            wo_poses = [[0.0] * 7 for _ in dets]
            it_poses = [[0.0] * 7 for _ in dets]
            live = [(k, s) for k, (s, _, _) in enumerate(dets) if s.valid]
            if live:
                # padded rows run through the network; only the live rows'
                # outputs are kept
                pad = _bucket(len(live)) - len(live)
                samples = [s for _, s in live] + [
                    PoseSample.invalid(args.num_points, mesh_m,
                                       args.crop_size)] * pad
                batch = collate(samples)
                q0, t0, q, t, _ = pipe(batch.img, batch.points,
                                       batch.choose, batch.obj_idx)
                wo, it = pose_rows(q0, t0), pose_rows(q, t)
                for j, (k, _) in enumerate(live):
                    wo_poses[k] = wo[j].tolist()
                    it_poses[k] = it[j].tolist()
            save(frame_idx, wo_poses, it_poses)
            if frame_idx == 0:
                times["first_keyframe_s"] = time.perf_counter() - t_infer
            if frame_idx % 100 == 0:
                logger.info(f"Finish No.{frame_idx} keyframe")
    else:
        pipe0 = InferencePipeline(posenet, refiner, refine_iters=0,
                                  device=device)
        # with 0 iterations the two pipelines are the same: run it once and
        # publish the same poses under both methods
        pipe = pipe0 if args.iterations == 0 else InferencePipeline(
            posenet, refiner, refine_iters=args.iterations, device=device)
        for frame_idx in range(len(ds)):
            wo_poses, it_poses = [], []
            for sample, _, _ in ds.detections(frame_idx):
                if not sample.valid:
                    wo_poses.append([0.0] * 7)
                    it_poses.append([0.0] * 7)
                    continue
                batch = collate([sample])
                inputs = (batch.img, batch.points, batch.choose,
                          batch.obj_idx)
                q0, t0, _ = pipe0(*inputs)
                wo_poses.append(pose_rows(q0, t0)[0].tolist())
                if pipe is pipe0:
                    it_poses.append(wo_poses[-1])
                else:
                    q, t, _ = pipe(*inputs)
                    it_poses.append(pose_rows(q, t)[0].tolist())
            save(frame_idx, wo_poses, it_poses)
            if frame_idx == 0:
                times["first_keyframe_s"] = time.perf_counter() - t_infer
            if frame_idx % 100 == 0:
                logger.info(f"Finish No.{frame_idx} keyframe")

    t_models = time.perf_counter()
    times["infer_s"] = t_models - t_infer

    # -- stage 2: toolbox-exact scoring ------------------------------------
    models = load_model_clouds(args.dataset_root)
    t_score = time.perf_counter()
    times["models_s"] = t_score - t_models
    results = score_keyframes(
        args.dataset_root, args.posecnn_results,
        {"per-pixel": wo_dir, "iterative": it_dir},
        num_keyframes=args.num_keyframes, models=models)
    results.save_mat(os.path.join(args.output_dir, "results_keyframe.mat"))
    table = summarize(results, ds.classes)
    times["score_s"] = time.perf_counter() - t_score
    if args.plots:
        plot_accuracy(results, ds.classes,
                      os.path.join(args.output_dir, "plots"))

    # top-level keys: the refined method over all gt objects
    summary = {**{k: table["iterative"]["all"][k] for k in
                  ("adds_auc", "add_auc", "adds_under_2cm")},
               "refine_iterations": args.iterations,
               "refiner_trained": refiner_trained,
               "native_crops": native,
               "methods": table}
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    for method in results.methods:
        row = table[method]["all"]
        logger.info(
            f"{method}: ADD-S AUC {row['adds_auc']:.2f}  "
            f"ADD AUC {row['add_auc']:.2f}  <2cm {row['adds_under_2cm']:.2f}  "
            f"detected {row['detected']}/{row['total']}")
    logger.info(f"stage seconds: set-up {times['setup_s']:.3f}, inference "
                f"{times['infer_s']:.3f} over {times['keyframes']} "
                f"keyframes, model clouds {times['models_s']:.3f}, scoring "
                f"{times['score_s']:.3f}")
    if timings is not None:
        timings.update(times)
    return summary


if __name__ == "__main__":
    main()
