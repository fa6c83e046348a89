#!/usr/bin/env python3
"""The least time an NVIDIA H100 SXM could take for the work of each TPU
kernel of the JAX package, at a stated shape of the port's paths.

    python3 examples/kernel_bounds.py

Pure arithmetic, no card needed. A bound is the larger of the operations
over the card's peak rate for their type and the bytes (each input read
once, each output written once) over its memory rate; the rates are the
data-sheet peaks ``chip_smoke.py`` uses (67 TFLOP/s fp32 outside the tensor
cores, 3.35 TB/s). The ported kernels' bounds come from ``chip_smoke.py``'s
own functions, which it also reports beside their measured times.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / cs.PEAK_FP32_FLOPS, nbytes / cs.PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def conv3x3_bound_ms(bsz: int, h: int, w: int, cin: int,
                     cout: int) -> tuple[float, str]:
    """3x3 VALID conv of a (B, h+2, w+2, Cin) padded map in float32 (the
    port's precision policy): 2 operations per multiply-add; the padded
    input, the weights and the (B, h, w, Cout) output moved once."""
    return _bound(2 * bsz * h * w * 9 * cin * cout,
                  4 * (bsz * (h + 2) * (w + 2) * cin + 9 * cin * cout
                       + bsz * h * w * cout))


def main() -> None:
    b, n, m = cs.TRAIN_BATCH, cs.NUM_POINTS, cs.NUM_MESH
    rows = [
        ("1 _paired_kernel", "phase 1 (32, N=1000, M=500), 24 rows active",
         cs.add_dist_bound_ms(b, n, m, b - cs.TRAIN_SYM_ROWS, False)),
        ("2 _min_kernel", "phase 1 (32, N=1000, M=500), 8 rows active",
         cs.add_dist_bound_ms(b, n, m, cs.TRAIN_SYM_ROWS, True)),
        ("3 _nn_kernel", f"bench_knn, Q={cs.KNN_QUERIES}, R={cs.KNN_REFS}",
         cs.nn_bound_ms(1, cs.KNN_QUERIES, cs.KNN_REFS)),
        ("4 _nn_kernel_bt", f"phase-1 ADD-S rows, B={cs.TRAIN_SYM_ROWS}, "
         f"Q={n * m}, R={m}", cs.nn_bound_ms(cs.TRAIN_SYM_ROWS, n * m, m)),
        ("5 _remap_kernel_bt", "B=64, Q=R=500 (the scoring shape)",
         cs.remap_bound_ms(cs.BATCH, cs.NUM_MESH, cs.NUM_MESH, cs.BATCH)),
        ("6 _conv_kernel", "up1's phase conv, B=64, 24x24, 1024 -> 4*256, "
         "float32", conv3x3_bound_ms(cs.BATCH, 24, 24, 1024, 1024)),
    ]
    for kernel, shape, (ms, by) in rows:
        print(json.dumps({"kernel": kernel, "shape": shape, "bound_ms": ms,
                          "bound_by": by}))


if __name__ == "__main__":
    main()
