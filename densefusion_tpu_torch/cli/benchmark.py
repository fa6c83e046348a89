"""Benchmark CLI: the 1-NN search at the training ADD-S query count.

Counterpart of ``densefusion_tpu/cli/benchmark.py`` (``bench_knn``, same
shape, same seed, same keys). Runs on the card unless given
``--device cpu``::

    python -m densefusion_tpu_torch.cli.benchmark --what knn

Prints one JSON object: ``knn_backend`` (``cuda``: the kernel of
``csrc/nn.cu``; ``plain``: its plain PyTorch version on the CPU),
``knn_us`` per search (host clock, each search ended by a sync),
``knn_pairs_per_s`` and the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.ops.knn import nearest_neighbor

# the training ADD-S shape: B*N*M queries vs M refs (8 x 500 hyp x 500 mesh)
NUM_QUERY, NUM_REF = 250_000, 500


def bench_knn(repeats: int = 50, device: str | torch.device | None = None,
              num_query: int = NUM_QUERY) -> dict:
    """Mean time of ``nearest_neighbor`` on Q=``num_query`` queries against
    R=500 refs from ``default_rng(0)``, after one warm-up search."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((num_query, 3))
                         .astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.standard_normal((NUM_REF, 3))
                         .astype(np.float32)).to(dev)
    nearest_neighbor(q, r)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        nearest_neighbor(q, r)
        sync()
    dt = (time.perf_counter() - t0) / repeats
    return {"knn_backend": "cuda" if dev.type == "cuda" else "plain",
            "knn_us": dt * 1e6, "knn_pairs_per_s": num_query * NUM_REF / dt,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--what", default="knn", choices=["knn"])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--queries", type=int, default=NUM_QUERY,
                   help="query count (a smaller one for a CPU run)")
    args = p.parse_args(argv)
    results = bench_knn(device=args.device, num_query=args.queries)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
