#!/usr/bin/env python3
"""The least time an NVIDIA H100 SXM could take for the work of each TPU
kernel of the JAX package, at a stated shape of the port's paths.

    python3 examples/kernel_bounds.py

Pure arithmetic, no card needed. A bound is the larger of the operations
over the card's peak rate for their type and the bytes (each input read
once, each output written once) over its memory rate; the rates are the
data-sheet peaks ``chip_smoke.py`` uses (67 TFLOP/s fp32 outside the tensor
cores, 494.7 TFLOP/s dense TF32 and 989 TFLOP/s dense bf16 on them, 3.35
TB/s). Kernel 6's float32 route gets two: its own arithmetic's (three TF32
products per product, 3xTF32) and the FFMA bound of a float32 kernel on
the CUDA cores; its bf16 route one product per product on bf16 operands,
at the serving (B=64) and training (B=32) batches. The bounds come from
``chip_smoke.py``'s own functions, which it also reports beside their
measured times.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    b, n, m = cs.TRAIN_BATCH, cs.NUM_POINTS, cs.NUM_MESH
    rows = [
        ("1 _paired_kernel", "phase 1 (32, N=1000, M=500), 24 rows active",
         cs.add_dist_bound_ms(b, n, m, b - cs.TRAIN_SYM_ROWS, False)),
        ("2 _min_kernel", "phase 1 (32, N=1000, M=500), 8 rows active",
         cs.add_dist_bound_ms(b, n, m, cs.TRAIN_SYM_ROWS, True)),
        ("2 _min_kernel", f"refiner (32, N=1, M={cs.REFINE_MESH}), 8 rows "
         "active", cs.add_dist_bound_ms(b, 1, cs.REFINE_MESH,
                                        cs.TRAIN_SYM_ROWS, True)),
        ("3 _nn_kernel", f"bench_knn, Q={cs.KNN_QUERIES}, R={cs.KNN_REFS}",
         cs.nn_bound_ms(1, cs.KNN_QUERIES, cs.KNN_REFS)),
        ("4 _nn_kernel_bt", f"phase-1 ADD-S rows, B={cs.TRAIN_SYM_ROWS}, "
         f"Q={n * m}, R={m}", cs.nn_bound_ms(cs.TRAIN_SYM_ROWS, n * m, m)),
        ("5 _remap_kernel_bt", "B=64, Q=R=500 (the scoring shape)",
         cs.remap_bound_ms(cs.BATCH, cs.NUM_MESH, cs.NUM_MESH, cs.BATCH)),
    ] + [(f"6 _conv_kernel ({arith})", f"{name}'s phase conv, "
          f"B={cs.BATCH}, {hw}x{hw}, {cin} -> {cout}, float32",
          cs.conv_bound_ms(cs.BATCH, hw, hw, cin, cout, arith))
         for name, hw, cin, cout in cs.DECODER_CONVS
         for arith in ("3xtf32", "ffma")] + [
        ("6 _conv_kernel (bf16)", f"{name}'s phase conv, B={bsz}, "
         f"{hw}x{hw}, {cin} -> {cout}, bfloat16",
         cs.conv_bound_ms(bsz, hw, hw, cin, cout, "bf16"))
        for bsz in cs.BF16_CONV_BATCHES
        for name, hw, cin, cout in cs.DECODER_CONVS]
    for kernel, shape, (ms, by) in rows:
        print(json.dumps({"kernel": kernel, "shape": shape, "bound_ms": ms,
                          "bound_by": by}))


if __name__ == "__main__":
    main()
