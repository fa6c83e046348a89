"""End-to-end learning check of the PyTorch port on the card: train the
PoseNet (and then the refiner) on a synthetic LineMOD-format scene set and
report the held-out ADD distance and success rate.

The port's counterpart of ``examples/overfit_synthetic.py``, with the same
flags and defaults: generator -> ``LineModDataset`` -> ``BatchLoader`` ->
phase-1 steps (-> phase-2 steps) -> eval steps. Runs on the card unless
given ``--cpu``::

    python examples/gpu_overfit_synthetic.py --steps 300
    python examples/gpu_overfit_synthetic.py --realism --frames 2500 \\
        --steps 28000 --refine_steps 8000 --batch 8 --test_frames 40

Prints one JSON object (the JAX example's keys, plus the device, the
card's name and power limit, the float32 policy and the compute type).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--test_frames", type=int, default=2,
                   help="held-out eval frames (x10 rendered; reader "
                        "subsamples 1/10)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--crop", type=int, default=96)
    p.add_argument("--points", type=int, default=256)
    p.add_argument("--mesh", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--refine_steps", type=int, default=0,
                   help="after pose training, train the refiner this many "
                        "steps and evaluate with 2 refinement iterations")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--objlist", default="1",
                   help="comma-separated LineMOD object ids; include 10 or "
                        "11 (eggbox/glue) to train the symmetric ADD-S "
                        "path")
    p.add_argument("--realism", action="store_true",
                   help="domain-randomized scenes (backgrounds, lighting, "
                        "distractors) for generalization instead of overfit")
    p.add_argument("--out", default="")
    args = p.parse_args()

    import numpy as np

    from densefusion_tpu_torch.data import (
        BatchLoader, LineModDataset, generate_linemod_style_dataset,
        to_device,
    )
    from densefusion_tpu_torch.device import resolve_device, run_record
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        create_train_state, make_eval_step, make_pose_train_step,
        make_refine_train_step,
    )
    from densefusion_tpu_torch.utils import RunConfig, check_ported

    dev = resolve_device("cpu" if args.cpu else None)
    objlist = tuple(int(x) for x in args.objlist.split(","))
    cfg = RunConfig(num_objects=len(objlist), num_points=args.points,
                    crop_size=args.crop, lr=args.lr)
    check_ported(cfg)
    with tempfile.TemporaryDirectory(prefix="lm_overfit_") as root:
        t_gen = time.time()
        generate_linemod_style_dataset(root, objlist=objlist,
                                       n_train=args.frames,
                                       n_test=args.test_frames * 10, seed=1,
                                       realism=args.realism)
        t_gen = time.time() - t_gen
        ds = LineModDataset(root, mode="train", num_points=args.points,
                            crop_size=args.crop, num_mesh_points=args.mesh,
                            objlist=list(objlist), add_noise=True,
                            noise_trans=0.005)
        test_ds = LineModDataset(root, mode="test", num_points=args.points,
                                 crop_size=args.crop,
                                 num_mesh_points=args.mesh,
                                 objlist=list(objlist), add_noise=False)
        # fork workers: a sample depends only on (seed, epoch, index), so
        # the batches are the JAX example's thread loader's
        loader = BatchLoader(ds, args.batch, shuffle=True, num_workers=4,
                             worker_mode="process")
        test_loader = BatchLoader(test_ds, 2, shuffle=False,
                                  drop_last=False, num_workers=1)
        # 0.1-diameter success threshold; meant for one object (the first
        # object's diameter sets the success rate)
        diam_threshold = ds.diameters()[0] * 0.1

        state = create_train_state(PoseNet(len(objlist)),
                                   PoseRefineNet(len(objlist)), cfg.lr,
                                   cfg.seed, dev)
        # symmetric objects in the objlist (eggbox/glue) switch ADD-S on
        use_adds = bool(ds.sym_list)
        step_fn = make_pose_train_step(state, use_adds=use_adds)
        w = cfg.w

        t0 = time.time()
        steps_done = 0
        epoch = 0
        history = []
        while steps_done < args.steps:
            for batch in loader.epoch(epoch):
                m = step_fn(to_device(batch, dev), w)
                steps_done += 1
                if steps_done % 25 == 0:
                    dis = float(m["dis"])
                    history.append(dis)
                    print(f"step {steps_done} train_dis {dis:.4f} "
                          f"({time.time() - t0:.0f}s)", flush=True)
                if steps_done >= args.steps:
                    break
            epoch += 1

        def run_eval(refine_iters):
            fn = make_eval_step(state, refine_iters, use_adds=use_adds)
            out = []
            for batch in test_loader.epoch(0):
                d, valid = fn(to_device(batch, dev), w)
                out += [float(x) for x, v in zip(d.cpu().numpy(),
                                                 valid.cpu().numpy()) if v]
            return out

        dists = run_eval(0)

        refine_result = None
        if args.refine_steps:
            # a fresh Adam over the refiner (the phase switch)
            refine_step = make_refine_train_step(state, refine_iters=2)
            done = 0
            while done < args.refine_steps:
                for batch in loader.epoch(1_000_000 + epoch):
                    m = refine_step(to_device(batch, dev), w)
                    done += 1
                    if done % 100 == 0:
                        print(f"refine step {done} dis {float(m['dis']):.4f}"
                              f" ({time.time() - t0:.0f}s)", flush=True)
                    if done >= args.refine_steps:
                        break
                epoch += 1
            rd = run_eval(2)
            refine_result = {
                "test_dis": rd,
                "test_mean_dis": float(np.mean(rd)),
                "success_rate_0.1d": float(np.mean(
                    [d < diam_threshold for d in rd])),
            }
        loader.close()

    result = {
        "n_test": len(dists),
        "final_train_dis": history[-1] if history else None,
        "test_dis": dists,
        "test_mean_dis": float(np.mean(dists)),
        "success_rate_0.1d": float(np.mean(
            [d < diam_threshold for d in dists])),
        "diam_threshold": float(diam_threshold),
        "refined": refine_result,
        "seconds": time.time() - t0,
        "generate_seconds": t_gen,
        **run_record(dev),
    }
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
