"""Benchmark CLI: the 1-NN search at the training ADD-S query count,
batched and single-frame pose inference, the train steps of both phases,
data-parallel scaling, the host data plane, loader-fed training, and
SegNet.

Counterpart of ``densefusion_tpu/cli/benchmark.py`` (``bench_knn``,
``bench_inference``, ``bench_latency``, ``bench_train_step``,
``bench_refine_step``, ``bench_scaling``, ``bench_loader``,
``bench_train_e2e`` and ``bench_seg``: same shapes and keys). Runs on the
card unless given ``--device cpu``::

    python -m densefusion_tpu_torch.cli.benchmark            # --what all
    python -m densefusion_tpu_torch.cli.benchmark --what knn
    python -m densefusion_tpu_torch.cli.benchmark --what inference
    python -m densefusion_tpu_torch.cli.benchmark --what latency
    python -m densefusion_tpu_torch.cli.benchmark --what train
    python -m densefusion_tpu_torch.cli.benchmark --what refine
    python -m densefusion_tpu_torch.cli.benchmark --what scaling
    python -m densefusion_tpu_torch.cli.benchmark --what loader
    python -m densefusion_tpu_torch.cli.benchmark --what train_e2e
    python -m densefusion_tpu_torch.cli.benchmark --what seg

Each prints one JSON object with the device it ran on; ``all`` (the
default, as in the JAX CLI) runs ``knn``, ``inference`` and ``train`` and
prints their keys together.

* ``knn``: ``knn_backend`` (``cuda``: the kernel of ``csrc/nn.cu``;
  ``plain``: its plain PyTorch version on the CPU), ``knn_us`` per search
  (host clock, each search ended by a sync), ``knn_pairs_per_s``.
* ``inference``: PoseNet and K=2 refiner iterations at B=16 (``--batch``),
  N=1000, 192 px, 21 objects, on inputs and weights drawn from seeded
  generators: ms per batch (host clock, each batch ended by a read of its
  poses), frames/s; float32.
* ``latency``: the same at B=1, each request timed alone and ended by a
  read of its pose: median and p90 ms, and ``latency_vs_paper_frame`` =
  0.06 s (the paper's per-frame time, on its GPU) over the median; bfloat16
  compute on the card and float32 on the CPU, as the JAX benchmark runs
  bfloat16 on an accelerator only (``"dtype"`` says which).
* ``train``: the phase-1 step (forward, ADD-S loss, backward, Adam) at
  B=8, N=1000, M=500, 192 px, 21 objects, a quarter of the rows symmetric,
  on one seeded batch: ms per step (host clock, each step ended by a
  sync), frames/s; float32.
* ``refine``: the phase-2 step (frozen PoseNet, K=2 refiner iterations
  against M=2600 model points) at the same batch: ms per step, frames/s.
* ``scaling``: weak scaling of the data-parallel phase-1 step at 8 rows
  per card (N=500, M=500, 192 px, 21 objects, all rows valid, none
  symmetric, the JAX benchmark's batch) on 1, 2, 4, ... cards up to the
  machine's: ``scaling_{n}dev_fps`` (rank 0's host clock, each step ended
  by a sync) and ``scaling_{n}dev_efficiency`` = fps(n) / (n fps(1)). Each
  n is a group of n spawned processes, one per card, over NCCL.
* ``loader``: samples/s of the YCB training reader through ``BatchLoader``
  on a synthetic root (5 classes, 32 real + 32 synthetic 480x640 frames,
  N=1000, 192 px crops): cold (PNG decode), warm (decoded-frame cache,
  thread workers) and ring (fork workers and the shared-memory ring).
* ``train_e2e``: phase-1 steps/s with the process loader feeding the step
  through ``PrefetchIterator``, the device-only rate on one batch, and the
  input-bound fraction ``1 - e2e / device``; bfloat16 compute (float32
  parameters and Adam state), as the JAX benchmark's.
* ``seg``: SegNet at the reference's full frame (B=4, 480x640, 22
  classes, seeded inputs and weights): the cross-entropy train step (ms
  per step, frames/s) and the argmax inference pass that writes
  ``segnet_results`` masks (ms per batch, frames/s); each step or batch
  ended by a sync; float32, TF32 off.

``--trace_dir DIR`` wraps the benchmarked region in a ``torch.profiler``
trace (``utils/profiling.py`` ``trace_context``) written into DIR, as the
JAX CLI's ``--trace_dir`` wraps it in ``jax.profiler``'s. The port's spans
of the region (serving, pipeline, model and train-step boundaries) show
in it as ranges and are kept in memory (``utils/profiling.py`` ``spans``)
while it runs.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import traceback

import numpy as np
import torch

from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.ops.knn import nearest_neighbor

# the training ADD-S shape: B*N*M queries vs M refs (8 x 500 hyp x 500 mesh)
NUM_QUERY, NUM_REF = 250_000, 500
# the train-step benchmarks: YCB's object count and confidence weight
NUM_OBJ, W = 21, 0.015
# bench_scaling: seconds a group of ranks has to give its result
SCALING_TIMEOUT_S = 600.0


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


def _pose_pipeline(batch: int, refine_iters: int, dev, obj_zero: bool,
                   dtype: torch.dtype | None = None):
    """(pipeline, inputs) of the inference benchmarks: the YCB width, fresh
    weights with the JAX package's initializers, inputs on the device; all
    drawn from seeded generators on the CPU, so every device gets the same
    values. ``obj_zero`` gives every row object 0 (the latency request);
    ``dtype`` is the networks' compute type (None: float32)."""
    from densefusion_tpu_torch.eval import InferencePipeline
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.models.init import (
        init_posenet_, init_refiner_,
    )

    n, crop = 1000, 192
    gen = torch.Generator().manual_seed(0)
    img = torch.randn((batch, crop, crop, 3), generator=gen)
    pts = torch.randn((batch, n, 3), generator=gen) * 0.05
    choose = torch.randint(0, crop * crop, (batch, n), generator=gen)
    obj = (torch.zeros((batch,), dtype=torch.int64) if obj_zero
           else torch.randint(0, NUM_OBJ, (batch,), generator=gen))
    posenet = PoseNet(NUM_OBJ, dtype=dtype)
    refiner = PoseRefineNet(NUM_OBJ, dtype=dtype)
    init_posenet_(posenet, gen)
    init_refiner_(refiner, gen)
    pipe = InferencePipeline(posenet, refiner, refine_iters=refine_iters,
                             device=dev)
    return pipe, tuple(x.to(dev) for x in (img, pts, choose, obj))


def bench_inference(batch: int = 16, repeats: int = 20,
                    device: str | torch.device | None = None) -> dict:
    """Batched pose inference (PoseNet and 2 refiner iterations) at the YCB
    width: ms per batch after one warm-up batch, each batch ended by a read
    of its poses (the JAX benchmark's ``_sync``)."""
    dev = resolve_device(device)
    pipe, inputs = _pose_pipeline(batch, 2, dev, obj_zero=False)
    pipe(*inputs)[0].cpu()
    t0 = time.perf_counter()
    for _ in range(repeats):
        pipe(*inputs)[0].cpu()
    dt = (time.perf_counter() - t0) / repeats
    return {"inference_batch": batch, "inference_ms_per_batch": dt * 1e3,
            "inference_fps": batch / dt, "dtype": "float32",
            "device": _device_name(dev)}


def bench_latency(repeats: int = 50, refine_iters: int = 2,
                  device: str | torch.device | None = None) -> dict:
    """Single-frame (B=1) pose and refinement latency, each request timed
    alone and ended by a read of its pose (no pipelining). bfloat16 compute
    on the card, float32 on the CPU (the JAX benchmark's choice: bfloat16
    on an accelerator). ``latency_vs_paper_frame`` divides the paper's
    0.06 s per frame (its GPU, arXiv:1901.04780) by the median: a
    yardstick, not a target measured on this card."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else None
    pipe, inputs = _pose_pipeline(1, refine_iters, dev, obj_zero=True,
                                  dtype=dtype)
    pipe(*inputs)[0].cpu()
    lats = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        pipe(*inputs)[0].cpu()
        lats.append(time.perf_counter() - t0)
    lats.sort()
    mid = lats[len(lats) // 2]
    return {"latency_refine_iters": refine_iters,
            "latency_ms_median": mid * 1e3,
            "latency_ms_p90": lats[int(len(lats) * 0.9)] * 1e3,
            "latency_vs_paper_frame": 0.06 / mid,
            "dtype": str(dtype or torch.float32).removeprefix("torch."),
            "device": _device_name(dev)}


def _step_batch(b: int, m: int, sym_fraction: float, dev):
    """The JAX benchmark's seeded batch: N=1000 points, 192 px crops, 21
    objects, the first ``round(sym_fraction * b)`` rows symmetric."""
    from densefusion_tpu_torch.data import PoseSample, to_device

    n, crop = 1000, 192
    rng = np.random.default_rng(0)
    batch = PoseSample(
        points=rng.standard_normal((b, n, 3)).astype(np.float32) * 0.05,
        choose=rng.integers(0, crop * crop, (b, n)).astype(np.int32),
        img=rng.standard_normal((b, crop, crop, 3)).astype(np.float32),
        target=rng.standard_normal((b, m, 3)).astype(np.float32) * 0.05,
        model_points=rng.standard_normal((b, m, 3)).astype(np.float32) * 0.05,
        obj_idx=rng.integers(0, NUM_OBJ, (b,)).astype(np.int32),
        sym=np.arange(b) < round(sym_fraction * b),
        valid=np.ones((b,), bool))
    return to_device(batch, dev)


def _time_steps(step, batch, repeats: int) -> float:
    """Seconds per step after one warm-up step, each step ended by a sync
    on its loss (the JAX benchmark's ``_sync``)."""
    float(step(batch, W)["loss"])
    t0 = time.perf_counter()
    for _ in range(repeats):
        float(step(batch, W)["loss"])
    return (time.perf_counter() - t0) / repeats


def bench_train_step(batch: int = 8, repeats: int = 10,
                     sym_fraction: float = 0.25,
                     device: str | torch.device | None = None) -> dict:
    """The phase-1 step (forward, ADD-S loss, backward, Adam) at the YCB
    width; ``sym_fraction`` of the rows run the ADD-S branch (the YCB class
    list makes ~24% of samples symmetric)."""
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        create_train_state, make_pose_train_step,
    )

    dev = resolve_device(device)
    data = _step_batch(batch, 500, sym_fraction, dev)
    state = create_train_state(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ),
                               1e-4, 0, dev)
    dt = _time_steps(make_pose_train_step(state, use_adds=True), data,
                     repeats)
    return {"train_batch": batch, "train_ms_per_step": dt * 1e3,
            "train_frames_per_s": batch / dt, "dtype": "float32",
            "device": _device_name(dev)}


def bench_refine_step(batch: int = 8, repeats: int = 10,
                      sym_fraction: float = 0.25, mesh_points: int = 2600,
                      refine_iters: int = 2,
                      device: str | torch.device | None = None) -> dict:
    """The phase-2 step at the YCB refine shape: frozen PoseNet forward,
    then ``refine_iters`` refiner iterations, each with the N=1 ADD-S loss
    against ``mesh_points`` model points."""
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        create_train_state, make_refine_train_step,
    )

    dev = resolve_device(device)
    data = _step_batch(batch, mesh_points, sym_fraction, dev)
    state = create_train_state(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ),
                               1e-4, 0, dev)
    dt = _time_steps(make_refine_train_step(state, refine_iters), data,
                     repeats)
    return {"refine_batch": batch, "refine_mesh_points": mesh_points,
            "refine_ms_per_step": dt * 1e3, "refine_frames_per_s": batch / dt,
            "dtype": "float32", "device": _device_name(dev)}


def _scaling_rank(rank: int, n_dev: int, init: str, device: str,
                  shape: dict, repeats: int, queue) -> None:
    """One rank of :func:`bench_scaling`: joins the group of ``n_dev``
    ranks at ``init``, steps the data-parallel phase-1 step on its rows of
    the seeded global batch, and puts its seconds per step (each step
    ended by a sync on the summed loss) on ``queue``; a failure puts its
    traceback."""
    import torch.distributed as dist

    from densefusion_tpu_torch.data import PoseSample, to_device
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.parallel import (
        initialize_distributed, make_mesh, make_shard_batch_fn,
    )
    from densefusion_tpu_torch.train import (
        create_train_state, make_pose_train_step,
    )
    from densefusion_tpu_torch.utils.config import RunConfig

    try:
        initialize_distributed(init, n_dev, rank, device=device)
        dev = resolve_device(device)
        shard = make_shard_batch_fn(make_mesh(device=device))
        b = shape["per_device_batch"] * n_dev
        n, m, crop = shape["num_points"], shape["mesh_points"], shape["crop"]
        num_obj = shape["num_obj"]
        rng = np.random.default_rng(0)
        batch = PoseSample(
            points=rng.standard_normal((b, n, 3)).astype(np.float32) * 0.05,
            choose=rng.integers(0, crop * crop, (b, n)).astype(np.int32),
            img=rng.standard_normal((b, crop, crop, 3)).astype(np.float32),
            target=rng.standard_normal((b, m, 3)).astype(np.float32) * 0.05,
            model_points=rng.standard_normal((b, m, 3)).astype(np.float32)
            * 0.05,
            obj_idx=rng.integers(0, num_obj, (b,)).astype(np.int32),
            sym=np.zeros((b,), bool), valid=np.ones((b,), bool))
        state = create_train_state(PoseNet(num_obj), PoseRefineNet(num_obj),
                                   RunConfig.preset("ycb").lr, 0, dev)
        step = make_pose_train_step(state, use_adds=True,
                                    sharding=shard.sharding)
        queue.put((rank, _time_steps(step, to_device(shard(batch), dev),
                                     repeats), None))
    except Exception:   # reported to bench_scaling, which raises
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def bench_scaling(per_device_batch: int = 8, repeats: int = 5,
                  n_devices: int | None = None,
                  device: str | torch.device | None = None,
                  num_points: int = 500, mesh_points: int = 500,
                  crop_size: int = 192, num_obj: int = NUM_OBJ) -> dict:
    """Data-parallel scaling: frames/s of the phase-1 train step on 1, 2,
    4, ... up to ``n_devices`` ranks (default: every card; 1 on the CPU) at
    a fixed per-rank batch. Efficiency(n) = fps(n) / (n fps(1)), the >=80%
    multi-device target of the JAX benchmark; fps(n) is rank 0's. Each n
    runs in n spawned processes over a ``FileStore``: NCCL on the cards,
    gloo with ``device="cpu"``. A rank that fails, or a group that gives
    no result within ``SCALING_TIMEOUT_S``, raises."""
    from densefusion_tpu_torch.parallel import spawn_ranks

    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    shape = {"per_device_batch": per_device_batch, "num_points": num_points,
             "mesh_points": mesh_points, "crop": crop_size,
             "num_obj": num_obj}
    out = {}
    base_fps = None
    for n_dev in (n for n in (1, 2, 4, 8, 16, 32) if n <= n_devices):
        with tempfile.TemporaryDirectory(prefix="bench_scaling_") as tmp:
            dt = spawn_ranks(_scaling_rank, n_dev, (
                f"file://{os.path.join(tmp, 'store')}", dev.type, shape,
                repeats), SCALING_TIMEOUT_S)[0]
        fps = per_device_batch * n_dev / dt
        base_fps = base_fps or fps
        out[f"scaling_{n_dev}dev_fps"] = fps
        out[f"scaling_{n_dev}dev_efficiency"] = fps / (n_dev * base_fps)
    out.update({"dtype": "float32", "device": _device_name(dev)})
    return out


def bench_seg(batch: int = 4, repeats: int = 10, num_classes: int = 22,
              height: int = 480, width: int = 640,
              device: str | torch.device | None = None) -> dict:
    """SegNet throughput at the reference's full-frame shape: the CE train
    step (``vanilla_segmentation/train.py:62-78``) and the argmax-mask
    inference pass (``vanilla_segmentation/segnet.py:6-121`` at 480x640),
    after one warm-up each."""
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import (
        create_seg_train_state, make_seg_train_step,
    )

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.standard_normal(
        (batch, 3, height, width)).astype(np.float32)).to(dev)
    label = torch.from_numpy(rng.integers(
        0, num_classes, (batch, height, width))).to(dev)
    state = create_seg_train_state(SegNet(num_classes), seed=0, device=dev)
    step = make_seg_train_step(state)
    float(step(rgb, label))
    t0 = time.perf_counter()
    for _ in range(repeats):
        float(step(rgb, label))
    dt = (time.perf_counter() - t0) / repeats
    out = {"seg_batch": batch, "seg_train_ms_per_step": dt * 1e3,
           "seg_train_frames_per_s": batch / dt}

    segnet = state.segnet.eval()

    @torch.no_grad()
    def infer():
        # logits -> argmax labels, reduced to a scalar for an honest sync
        return int(segnet(rgb).argmax(1).sum())

    infer()
    t0 = time.perf_counter()
    for _ in range(repeats):
        infer()
    dt = (time.perf_counter() - t0) / repeats
    out.update({"seg_infer_ms_per_batch": dt * 1e3,
                "seg_infer_frames_per_s": batch / dt,
                "dtype": "float32", "device": _device_name(dev)})
    return out


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _ycb_root(dataset_root: str | None, prefix: str) -> str:
    """``dataset_root``, or a synthetic YCB root generated into a fresh
    temporary directory (5 classes, 32 real + 32 synthetic frames)."""
    if dataset_root is not None:
        return dataset_root
    from densefusion_tpu_torch.data import generate_ycb_style_dataset

    root = tempfile.mkdtemp(prefix=prefix)
    generate_ycb_style_dataset(root, n_classes=5, n_real=32, n_syn=32,
                               n_test=2, seed=0)
    return root


def bench_loader(workers: int = 4, batch: int = 16,
                 dataset_root: str | None = None, epochs: int = 3,
                 num_points: int = 1000, crop_size: int = 192,
                 device: str | torch.device | None = None) -> dict:
    """Host data-plane throughput of the YCB training reader: cold (PNG
    decode) and warm (decoded-frame cache) samples/s with a thread loader,
    then with fork workers and the shared-memory ring; the check of whether
    the loader keeps up with the train step."""
    from densefusion_tpu_torch.data import BatchLoader, YCBDataset

    dev = resolve_device(device)
    ds = YCBDataset(_ycb_root(dataset_root, "ycb_loaderbench_"), mode="train",
                    num_points=num_points, crop_size=crop_size,
                    cache_frames=8192)
    loader = BatchLoader(ds, batch, shuffle=True, num_workers=workers,
                         drop_last=False)

    t0 = time.perf_counter()
    n_cold = sum(b.valid.size for b in loader.epoch(0))
    cold = n_cold / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    n_warm = 0
    for ep in range(1, 1 + epochs):
        n_warm += sum(b.valid.size for b in loader.epoch(ep))
    warm = n_warm / (time.perf_counter() - t0)
    out = {"loader_workers": workers,
           "loader_cold_samples_per_s": cold,
           "loader_warm_samples_per_s": warm,
           "loader_cache_hit_rate": ds.cache.hits /
           max(ds.cache.hits + ds.cache.misses, 1)}

    # fork workers + shared-memory ring; the parent's cache is warm at the
    # fork, so the workers inherit the decoded frames
    ring = BatchLoader(ds, batch, shuffle=True, num_workers=workers,
                       drop_last=False, worker_mode="process")
    if ring.worker_mode == "process":   # linux only
        try:
            sum(1 for _ in ring.epoch(0))   # start and settle the pool
            t0 = time.perf_counter()
            n_ring = 0
            for ep in range(1, 1 + epochs):
                n_ring += sum(b.valid.size for b in ring.epoch(ep))
            out["loader_ring_samples_per_s"] = \
                n_ring / (time.perf_counter() - t0)
        finally:
            ring.close()
    out["device"] = _device_name(dev)
    return out


def bench_train_e2e(batch: int = 16, steps: int = 60, workers: int = 4,
                    dataset_root: str | None = None, num_points: int = 1000,
                    crop_size: int = 192, device_steps: int = 10,
                    device: str | torch.device | None = None) -> dict:
    """Phase-1 training throughput with the process loader feeding the step
    (synthetic YCB, full augmentation): achieved steps/s, the device-only
    rate on one batch, and the input-bound fraction (0 when the host keeps
    up). bfloat16 compute, as the JAX benchmark's (``cfg.bf16_compute``);
    parameters and Adam state stay float32."""
    from densefusion_tpu_torch.data import (
        BatchLoader, PrefetchIterator, YCBDataset, to_device,
    )
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        create_train_state, make_pose_train_step,
    )
    from densefusion_tpu_torch.utils.config import RunConfig, check_ported

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ds = YCBDataset(_ycb_root(dataset_root, "ycb_e2ebench_"), mode="train",
                    num_points=num_points, crop_size=crop_size,
                    cache_frames=8192)
    for i in range(len(ds)):   # warm the frame cache BEFORE the pool forks
        ds[i]
    loader = BatchLoader(ds, batch, shuffle=True, num_workers=workers,
                         drop_last=True, worker_mode="process")
    cfg = RunConfig.preset("ycb", num_points=num_points, crop_size=crop_size,
                           bf16_compute=True)
    check_ported(cfg, dev)
    num_obj = len(ds.classes)
    state = create_train_state(PoseNet(num_obj, dtype=torch.bfloat16),
                               PoseRefineNet(num_obj, dtype=torch.bfloat16),
                               cfg.lr, cfg.seed, dev)
    step = make_pose_train_step(state, use_adds=True)
    try:
        it = loader.epoch(0)
        first = to_device(next(it), dev)
        it.close()   # drains the ring before the next epoch starts
        m = step(first, cfg.w)   # warm-up
        sync()

        # device-only rate (the same batch on the device, no host loader)
        t0 = time.perf_counter()
        for _ in range(device_steps):
            m = step(first, cfg.w)
        sync()
        dev_rate = device_steps / (time.perf_counter() - t0)

        # end to end: the prefetched loader feeding the step
        done, epoch = 0, 1
        t0 = time.perf_counter()
        while done < steps:
            for b in PrefetchIterator(loader.epoch(epoch), depth=3):
                m = step(to_device(b, dev), cfg.w)
                done += 1
                if done >= steps:
                    break
            epoch += 1
        sync()
        e2e_rate = steps / (time.perf_counter() - t0)
    finally:
        loader.close()
    if not torch.isfinite(m["loss"]):
        raise RuntimeError(f"non-finite training loss {float(m['loss'])}")
    return {
        "train_e2e_batch": batch,
        "train_e2e_steps_per_s": e2e_rate,
        "train_e2e_frames_per_s": e2e_rate * batch,
        "train_device_only_steps_per_s": dev_rate,
        "train_e2e_input_bound_fraction": max(0.0, 1.0 - e2e_rate / dev_rate),
        "dtype": "bfloat16",
        "device": _device_name(dev),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--what", default="all",
                   choices=["all", "knn", "inference", "latency", "train",
                            "refine", "seg", "scaling", "loader",
                            "train_e2e"])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--queries", type=int, default=NUM_QUERY,
                   help="knn: query count (a smaller one for a CPU run)")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--batch", type=int, default=None,
                   help="batch size (default: 8 for train / refine, 16 for "
                        "inference / loader / train_e2e, 4 for seg)")
    p.add_argument("--dataset_root", default=None,
                   help="loader / train_e2e: an existing YCB-format root "
                        "(default: generate a synthetic one)")
    p.add_argument("--steps", type=int, default=60,
                   help="train_e2e: loader-fed steps")
    p.add_argument("--device_steps", type=int, default=10,
                   help="train_e2e: steps on one batch for the device-only "
                        "rate")
    p.add_argument("--num_points", type=int, default=1000,
                   help="loader / train_e2e: cloud points per sample")
    p.add_argument("--crop_size", type=int, default=192,
                   help="loader / train_e2e: crop size (smaller for a CPU "
                        "run)")
    p.add_argument("--trace_dir", default=None,
                   help="capture a torch.profiler trace (TensorBoard) of "
                        "the benchmarked region")
    args = p.parse_args(argv)
    from densefusion_tpu_torch.utils.profiling import trace_context
    data_kw = dict(workers=args.workers, batch=args.batch or 16,
                   dataset_root=args.dataset_root,
                   num_points=args.num_points, crop_size=args.crop_size,
                   device=args.device)
    results = {}
    with trace_context(args.trace_dir):
        if args.what in ("all", "knn"):
            results.update(bench_knn(device=args.device,
                                     num_query=args.queries))
        if args.what in ("all", "inference"):
            results.update(bench_inference(batch=args.batch or 16,
                                           device=args.device))
        if args.what == "latency":
            results.update(bench_latency(device=args.device))
        if args.what in ("all", "train"):
            results.update(bench_train_step(batch=args.batch or 8,
                                            device=args.device))
        if args.what == "refine":
            results.update(bench_refine_step(batch=args.batch or 8,
                                             device=args.device))
        if args.what == "seg":
            results.update(bench_seg(batch=args.batch or 4,
                                     device=args.device))
        if args.what == "scaling":
            results.update(bench_scaling(device=args.device))
        if args.what == "loader":
            results.update(bench_loader(**data_kw))
        if args.what == "train_e2e":
            results.update(bench_train_e2e(steps=args.steps,
                                           device_steps=args.device_steps,
                                           **data_kw))
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
