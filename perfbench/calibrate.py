"""Readings that a cell's limits are set from, in one process on the card:
the program over many seeds (each a set-up, a short window at the cell's
own load and the judgement), the control (the reference in the program's
place with TF32 on) and, for a training cell, the planted half-batch fault.

    python3 perfbench/calibrate.py --workload ycb-serve-b64 \
        --program 101 102 103 --control 201 202 203 --seconds 3

Each reading is one JSON line on standard output, and all of them are
appended to ``--out``. The benchmark's runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault-half", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import Bench

    bench = Bench()
    w = bench.workload(args.workload)
    cfg, trf = bench.config(w["config"]), bench.traffic(w["traffic"])
    driver = bench.driver(trf["kind"]).Driver
    jobs = ([("program", s) for s in args.program]
            + [("control", s) for s in args.control]
            + [("fault_half", s) for s in args.fault_half])
    for what, seed in jobs:
        t0 = time.perf_counter()
        drv = driver(cfg, trf, seed, args.device)
        if what == "program":
            drv.setup()
            win = drv.window(args.seconds)
            drv.release()
            gaps = drv.check()
            extra = {"attempted": win.attempted, "failed": win.failed}
        else:
            gaps = drv.control(half_batch=True) if what == "fault_half" \
                else drv.control()
            extra = {}
        if hasattr(drv, "detail"):
            extra["detail"] = drv.detail()
        line = json.dumps({"workload": args.workload, "what": what,
                           "seed": seed, "gaps": gaps, **extra,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del drv
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
