#!/usr/bin/env python3
"""Why the search kernels round their scores step by step and use no FMA.

    python3 examples/fma_parity.py [--queries 20000] [--seed 0]

At the ADD-S geometry of training (500 targets in a 5 cm cloud at z = 0.8
m, queries 2 cm off), every query's nearest target is found three ways:

- pinned: ``||r||^2 - 2 q.r`` with each product and sum rounded to float32
  in the plain version's order (``densefusion_tpu_torch.ops.knn._scores``,
  which the kernels match bit for bit);
- FMA: ``fma(-2qz, rz, fma(-2qy, ry, fma(-2qx, rx, ||r||^2)))``, a float32
  fused multiply-add chain, emulated exactly in float64 (the product of two
  float32 values is exact in float64; the sum is split by TwoSum and a
  result that lands on a float32 midpoint is nudged toward the lost part,
  so it rounds once, as the hardware does);
- exact: the squared distance in float64.

It prints, as one JSON object, how many queries the FMA score sends to
another target than the pinned one, how often each disagrees with the
exact nearest, and the CPU time per 10M pairs of the pinned score (PyTorch,
as the plain version computes it) and of the exact FMA emulation (numpy):
what keeping the plain version bit-identical to an FMA kernel would cost on
the CPU. Runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from densefusion_tpu_torch.ops.knn import _scores  # noqa: E402

F32_EPS_BITS = 29   # float64 keeps 29 more fraction bits than float32


def _to_f32_once(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """float32 rounding of the exact value s + e (|e| below half an ulp of
    the float64 s), rounded once: where s lies exactly on a float32 midpoint
    and e is not 0, s moves one float64 ulp toward e first."""
    bits = s.view(np.int64)
    low = bits & ((1 << F32_EPS_BITS) - 1)
    midpoint = (low == 1 << (F32_EPS_BITS - 1)) & (e != 0)
    nudged = np.where(midpoint, np.nextafter(s, np.where(e > 0, np.inf,
                                                         -np.inf)), s)
    return nudged.astype(np.float32)


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 fma(a, b, c) = round32(a * b + c), exactly, for float32
    inputs (broadcast)."""
    p = a.astype(np.float64) * b.astype(np.float64)    # exact
    c64 = c.astype(np.float64)
    s = p + c64
    bp = s - c64                                       # TwoSum error term
    e = (p - bp) + (c64 - (s - bp))
    return _to_f32_once(s, e)


def fma_scores(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """(Q, R) FMA-chained scores of float32 queries (Q, 3), refs (R, 3)."""
    rsq = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
    m2q = (np.float32(-2.0) * q).astype(np.float32)    # exact
    acc = np.broadcast_to(rsq[None, :], (len(q), len(r)))
    for c in range(3):
        acc = fma32(m2q[:, c:c + 1], r[None, :, c], acc)
    return acc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    r = (0.05 * rng.standard_normal((500, 3)) + [0.0, 0.0, 0.8]) \
        .astype(np.float32)
    q = (r[rng.integers(0, len(r), args.queries)]
         + 0.02 * rng.standard_normal((args.queries, 3))).astype(np.float32)

    _scores(torch.from_numpy(q[:100])[None], torch.from_numpy(r)[None])
    flips = pinned_wrong = fma_wrong = 0
    t_pinned = t_fma = 0.0
    for s in range(0, len(q), 2000):
        qc = q[s:s + 2000]
        t0 = time.perf_counter()
        pinned = _scores(torch.from_numpy(qc)[None],
                         torch.from_numpy(r)[None])[0].argmin(-1).numpy()
        t1 = time.perf_counter()
        fused = fma_scores(qc, r).argmin(-1)
        t2 = time.perf_counter()
        exact = ((qc[:, None].astype(np.float64) - r[None]) ** 2) \
            .sum(-1).argmin(-1)
        t_pinned += t1 - t0
        t_fma += t2 - t1
        flips += int((pinned != fused).sum())
        pinned_wrong += int((pinned != exact).sum())
        fma_wrong += int((fused != exact).sum())
    pairs = len(q) * len(r)
    out = {"queries": len(q), "targets": len(r),
           "fma_picks_other_target": flips,
           "pinned_differs_from_exact": pinned_wrong,
           "fma_differs_from_exact": fma_wrong,
           "cpu_s_per_10M_pairs": {"pinned_torch": t_pinned * 1e7 / pairs,
                                   "fma_exact_emulation": t_fma * 1e7 / pairs},
           "torch": torch.__version__}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
