"""Does the synthetic root's coloring set how far the bf16 A/B's float32
run learns? A probe of the PyTorch port on the card.

The JAX package's A/B and YCB records were taken on a generator that
colored every object by the same position ramp, ``40 + 200 * ramp``; the
generator now gives each object its own colorway (``object_colorway``,
lower gains on some channels). This script writes the A/B's root (5
classes, 320 + 64 / 32 frames, seed 3) with the generator's
``object_colorway`` replaced by that ramp, trains the A/B's float32 run on
it (``cli.train``, 25 epochs, B=8, 192 px, seed 3) and prints the
per-epoch test ``avg_dis``; ``examples/gpu_ab_bf16_convergence.sh`` gives
the same run on today's coloring. Runs on the card unless given ``--cpu``
(with ``--epochs`` and ``--points`` to shrink it)::

    python examples/gpu_ramp_coloring_probe.py ramp.json
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


def ramp_coloring(model_mm, obj_seed):
    """Every object's color by the position ramp alone, as the generator
    colored YCB objects before its per-object colorways."""
    import numpy as np

    pmin, pmax = model_mm.min(0), model_mm.max(0)
    return (40 + 200 * (model_mm - pmin) / (pmax - pmin)).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out", help="write the result JSON here")
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--points", type=int, default=1000)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from densefusion_tpu_torch.cli import train as train_cli
    from densefusion_tpu_torch.data import synthetic
    from densefusion_tpu_torch.device import resolve_device, run_record

    dev = resolve_device("cpu" if args.cpu else None)
    work = tempfile.mkdtemp(prefix="ramp_probe_")
    root = os.path.join(work, "dataset")
    t0 = time.time()
    colorway = synthetic.object_colorway
    synthetic.object_colorway = ramp_coloring
    try:
        synthetic.generate_ycb_style_dataset(
            root, n_classes=5, n_real=320, n_syn=64, n_test=32, seed=3,
            posecnn_dir=os.path.join(work, "posecnn"))
    finally:
        synthetic.object_colorway = colorway
    gen_s = time.time() - t0
    train_cli.main([
        "--dataset", "ycb", "--dataset_root", root, "--batch_size", "8",
        "--workers", "4", "--nepoch", str(args.epochs), "--crop_size", "192",
        "--seed", "3", "--num_objects", "5", "--num_points", str(args.points),
        "--out_dir", os.path.join(work, "out"),
        "--log_dir", os.path.join(work, "logs"),
    ] + (["--device", "cpu"] if args.cpu else []))
    with open(os.path.join(work, "logs", "ycb", "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    test = [r["avg_dis"] for r in rows if r["kind"] == "test_epoch"]
    best = min(range(len(test)), key=test.__getitem__)
    result = {"coloring": "40 + 200 * position ramp, every object",
              "test_avg_dis": test, "best_epoch": best + 1,
              "best_avg_dis": test[best], "generate_s": gen_s,
              "seconds": time.time() - t0, **run_record(dev)}
    print(json.dumps(result))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
