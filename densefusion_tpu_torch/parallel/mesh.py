"""Process groups and the device mesh, over ``torch.distributed``.

Counterpart of ``densefusion_tpu/parallel/mesh.py``. One process drives one
device and is one rank; a mesh names the ranks' axes (``("data",)`` or
``("data", "point")``). Collectives ride NCCL on the card and gloo on the
CPU (``device="cpu"``); nothing here drops from one to the other.
"""

from __future__ import annotations

import math
import os
import queue as queue_mod
import time
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from densefusion_tpu_torch.device import resolve_device

# Every process group gets this timeout, so a lost rank fails its peers'
# collectives within a minute instead of hanging them.
TIMEOUT = timedelta(seconds=60)


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device: str | torch.device | None = None) -> None:
    """Start this process's default process group: NCCL on CUDA (the
    default), gloo for ``device="cpu"``.

    ``coordinator`` is where rank 0's store listens, ``"host:port"`` or an
    ``init_method`` URL (``tcp://...``, ``file://...``), with
    ``num_processes`` ranks of which this is ``process_id``. Without a
    coordinator, a launcher's environment (``torchrun``'s ``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) gives the
    group; without that either, the group is this process alone, over an
    in-process store (no network). A CUDA rank takes card ``LOCAL_RANK``,
    else ``rank % device_count``. No-op when a default group exists; raises
    if that group's backend is not the one ``device`` needs."""
    dev = resolve_device(device)
    backend = _backend(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"a {dist.get_backend()} process group exists; "
                             f"device {dev} needs {backend}")
        return
    env = os.environ
    if coordinator is not None:
        rank = local = process_id or 0
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        init = {"init_method": url, "world_size": num_processes}
    elif "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        if num_processes not in (None, world) \
                or process_id not in (None, rank):
            raise ValueError(f"the environment gives rank {rank} of {world}, "
                             f"asked for {process_id} of {num_processes}")
        local = int(env.get("LOCAL_RANK", rank))
        init = {"init_method": "env://", "world_size": world}
    else:
        if num_processes not in (None, 1):
            raise ValueError("several processes need a coordinator or a "
                             "launcher's WORLD_SIZE and RANK")
        rank = local = 0
        init = {"store": dist.HashStore(), "world_size": 1}
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, timeout=TIMEOUT, **init)


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None,
              device: str | torch.device | None = None) -> DeviceMesh:
    """A mesh over every rank of the default process group (started first,
    by :func:`initialize_distributed` with no coordinator, if there is
    none). ``n_devices``, when
    given, must be the world size. Default shape: all ranks on the first
    axis, the other axes of size 1; a ``(data, point)`` mesh shards a batch
    on ``data`` and the points of each sample on ``point``. Runs on CUDA
    unless ``device="cpu"``; without a card it raises."""
    initialize_distributed(device=device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"the mesh spans every rank: asked for {n} of a "
                         f"world of {world}")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not fit {n} ranks on "
                         f"axes {axis_names}")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def local_batch_slice(global_batch: int, mesh: DeviceMesh) -> slice:
    """This rank's slice of a globally sharded batch: each rank loads only
    its shard of frames."""
    n = mesh.size()
    per = global_batch // n
    i = mesh.get_rank()
    return slice(i * per, (i + 1) * per)


def spawn_ranks(target, world: int, args: tuple = (),
                timeout_s: float = 600.0) -> dict:
    """Run ``target(rank, world, *args, queue)`` in ``world`` spawned
    processes, one per rank (one per card on CUDA). Each rank puts one
    ``(rank, result, error)`` on ``queue``, ``error`` a traceback or None.
    Returns ``{rank: result}``. Raises ``RuntimeError`` with the first
    error, when a rank exits without putting its tuple, or after
    ``timeout_s``; every process has exited when it returns or raises."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, *args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            try:
                rank, res, err = q.get(timeout=5.0)
            except queue_mod.Empty:
                # a rank's tuple reaches the pipe before the rank exits
                lost = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if lost or time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(results))
                    raise RuntimeError(
                        f"ranks {missing} of {world} gave no result within "
                        f"{timeout_s} s (exit codes "
                        f"{[p.exitcode for p in procs]})") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return results
