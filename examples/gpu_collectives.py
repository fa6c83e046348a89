#!/usr/bin/env python3
"""The port's mesh-sharded searches and hypothesis-sharded distance on
several cards, one NCCL rank per card, against one card.

    python3 examples/gpu_collectives.py [out.json]

Needs at least two CUDA cards; spawns one process per card, joined over
``tcp://localhost`` on a free port. Every rank makes the same inputs from
the seed: the ``bench_knn`` shape (Q=250,000 queries, R=500 refs), a ragged
one (Q=250,001, R=2,601, not dividing the rank count) and the phase-1
hypothesis distance (B=32, N=1000, M=500, 8 rows symmetric) with a
gradient. On a ``(data,)`` mesh of every rank, ``sharded_nearest_neighbor``
and ``ring_nearest_neighbor`` must give the one-card search's indices and
distances exactly (the same kernel scores every pair with the same
rounding; ties go to the smallest global index); ``sharded_hypothesis_
mean_dist`` must give its ``dis`` and, on every rank alone, its gradient
within 1e-6 of the largest element, on the ``(data,)`` mesh and on a
``(data, point)`` mesh of shape (2, S/2). Then each search's time: host
clock, a barrier and a sync around each call, median of 20, beside the
one-card search on rank 0. Rank 0 prints one JSON object (and writes it to
``out.json`` if given).
"""

from __future__ import annotations

import json
import socket
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

JOIN_S = 600


def _median_ms(fn, dist, reps: int = 20) -> float:
    times = []
    for _ in range(reps + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times[1:]))


def _rank(rank: int, world: int, port: int) -> dict | None:
    import torch.distributed as dist

    import chip_smoke as cs
    from densefusion_tpu_torch import parallel
    from densefusion_tpu_torch.ops import add_dist, knn

    parallel.initialize_distributed(f"localhost:{port}", world, rank)
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        rng = np.random.default_rng(cs.SEED)
        mesh = parallel.make_mesh(world)
        out = {"world": world, "searches": {}}
        for nq, nr in ((cs.KNN_QUERIES, cs.KNN_REFS), (250_001, 2_601)):
            q = torch.from_numpy(rng.standard_normal((nq, 3))
                                 .astype(np.float32)).to(dev)
            r = torch.from_numpy(rng.standard_normal((nr, 3))
                                 .astype(np.float32)).to(dev)
            want_d, want_i = knn.nearest_neighbor(q, r)
            got = {"sharded": parallel.sharded_nearest_neighbor(q, r, mesh),
                   "ring": parallel.ring_nearest_neighbor(q, r, mesh)}
            res = {}
            for name, (d, i) in got.items():
                wd = want_d.clamp_min(0.0) if name == "sharded" else want_d
                if not (torch.equal(i, want_i) and torch.equal(d, wd)):
                    raise AssertionError(f"{name} search on {world} ranks "
                                         f"differs from one card at Q={nq}, "
                                         f"R={nr}")
                fn = getattr(parallel, f"{name}_nearest_neighbor")
                res[f"{name}_ms"] = _median_ms(lambda: fn(q, r, mesh), dist)
            res["one_card_ms"] = _median_ms(
                lambda: knn.nearest_neighbor(q, r), dist)
            out["searches"][f"Q={nq},R={nr}"] = res

        R, t, model, target = cs.pose_problem(rng, cs.TRAIN_BATCH,
                                              cs.NUM_POINTS, cs.NUM_MESH)
        sym = torch.arange(cs.TRAIN_BATCH, device=dev) < cs.TRAIN_SYM_ROWS
        wgt = torch.from_numpy(rng.uniform(0.2, 1.0, (cs.TRAIN_BATCH,
                                                      cs.NUM_POINTS))
                               .astype(np.float32)).to(dev)

        def with_grad(fn):
            Rg = R.clone().requires_grad_(True)
            tg = t.clone().requires_grad_(True)
            dis = fn(Rg, tg)
            (dis * wgt).sum().backward()
            return dis.detach(), Rg.grad, tg.grad

        want = with_grad(lambda R_, t_: add_dist.hypothesis_mean_dist(
            R_, t_, model, target, sym))
        meshes = {"(data,)": (mesh, {})}
        if world % 2 == 0:
            meshes["(data, point)"] = (
                parallel.make_mesh(world, axis_names=("data", "point"),
                                   shape=(2, world // 2)),
                {"axis": "point", "batch_axis": "data"})
        out["hypothesis_rel_err"] = {}
        for name, (m, kw) in meshes.items():
            got = with_grad(
                lambda R_, t_: parallel.sharded_hypothesis_mean_dist(
                    R_, t_, model, target, sym, m, **kw))
            for part, g, w in zip(("dis", "grad R", "grad t"), got, want):
                err = float((g - w).abs().max()) / float(w.abs().max())
                out["hypothesis_rel_err"][f"{name} {part}"] = err
                if err > 1e-6:
                    raise AssertionError(f"hypothesis distance on {name} "
                                         f"{part} differs: {err}")
        torch.cuda.synchronize()
        out["launches_rank"] = {"nn": knn.nn_kernel.launches,
                                "add_dist_paired":
                                    add_dist.paired_kernel.launches,
                                "add_dist_min": add_dist.min_kernel.launches}
        if min(out["launches_rank"].values()) == 0:
            raise AssertionError(f"rank {rank}: a kernel never launched: "
                                 f"{out['launches_rank']}")
        return out if rank == 0 else None
    finally:
        dist.destroy_process_group()


def _worker(rank: int, world: int, port: int, queue) -> None:
    try:
        queue.put((rank, _rank(rank, world, port), None))
    except Exception:   # reported to the parent, which exits non-zero
        queue.put((rank, None, traceback.format_exc()))


def main() -> None:
    import multiprocessing as mp

    import chip_smoke as cs

    world = torch.cuda.device_count()
    if world < 2:
        raise SystemExit(f"needs at least 2 CUDA cards, found {world}")
    from densefusion_tpu_torch.ops import build
    build.build_all()   # once, before the ranks load it
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, world, port, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):   # drain before joining
            rank, res, err = queue.get(timeout=JOIN_S)
            results[rank] = res
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    if errors or 0 not in results:
        raise SystemExit("\n".join(errors) or "rank 0 sent no result")
    out = {**results[0], "card": cs.card_line(),
           "cards": [torch.cuda.get_device_name(i) for i in range(world)]}
    print(json.dumps(out))
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
