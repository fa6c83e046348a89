"""Run one cell of the port's benchmark on the card this process sees.

    python3 perfbench/run.py --workload ycb-serve-b64 --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, then ``checks``: each compared
number beside its limit); the last lines of standard error give the same
numbers and limits. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones. Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits with 2; if JAX or the
JAX package was loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout (the
    # port's own kernels build into densefusion_tpu_torch/build/)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import Bench, forbidden_modules, run_cell

    bench = Bench()
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
