"""One rank of the port's multi-process CPU tests (``test_torch_parallel.py``,
``test_torch_dp.py``, ``test_torch_cli.py``).

Started by ``multiprocessing``'s spawn method, so it imports torch and the
port only (no JAX): it joins a gloo group of ``world`` ranks, runs one case
on the port's mesh and collectives, and puts ``(rank, result, error)`` on
the queue, numpy arrays in the result. ``init`` is either a coordinator URL
(a ``FileStore``) or the environment a launcher such as ``torchrun`` would
set; then the case's ``make_mesh`` starts the group from it.
"""

from __future__ import annotations

import os
import traceback

import torch
import torch.distributed as dist


def _np(x):
    return x.detach().cpu().numpy()


def _nn_cases(par, mesh, cases, axis):
    out = []
    for q, r in cases:
        q, r = torch.from_numpy(q), torch.from_numpy(r)
        out.append({
            "sharded": tuple(map(_np, par.sharded_nearest_neighbor(
                q, r, mesh, axis=axis))),
            "ring": tuple(map(_np, par.ring_nearest_neighbor(
                q, r, mesh, axis=axis)))})
    return out


def _hyp(par, mesh, inputs, **kw):
    R = torch.from_numpy(inputs["R"]).requires_grad_(True)
    t = torch.from_numpy(inputs["t"]).requires_grad_(True)
    model, target, wgt = (torch.from_numpy(inputs[k])
                          for k in ("model", "target", "wgt"))
    sym = torch.from_numpy(inputs["sym"])
    dis = par.sharded_hypothesis_mean_dist(R, t, model, target, sym, mesh,
                                           **kw)
    (dis * wgt).sum().backward()
    return {"dis": _np(dis), "gR": _np(R.grad), "gt": _np(t.grad)}


def line(rank, inputs):
    """A 1-D ``(data,)`` mesh over every rank."""
    from densefusion_tpu_torch import parallel as par
    from densefusion_tpu_torch.data import PoseSample

    mesh = par.make_mesh(inputs["world"], device="cpu")
    shard = par.make_shard_batch_fn(mesh)
    batch = PoseSample(*inputs["batch"])
    placed = shard({"sample": batch, "step": 7,
                    "w": torch.from_numpy(inputs["batch"][0])})
    own = torch.full((3,), float(rank))
    return {
        "nn": _nn_cases(par, mesh, inputs["nn"], "data"),
        "hyp": _hyp(par, mesh, inputs["hyp"]),
        "shard_points": placed["sample"].points,
        "shard_sym": placed["sample"].sym,
        "shard_w": _np(placed["w"]),
        "step": placed["step"],
        "replicated": _np(par.replicate({"x": own}, mesh)["x"]),
        "mean": _np(par.psum_mean(own, mesh)),
        "local_slice": par.local_batch_slice(16, mesh),
    }


def grid(rank, inputs):
    """A 2-D ``(data, point)`` mesh of shape ``inputs["shape"]``."""
    from densefusion_tpu_torch import parallel as par

    mesh = par.make_mesh(inputs["world"], axis_names=("data", "point"),
                         shape=inputs["shape"], device="cpu")
    return {
        "nn": _nn_cases(par, mesh, inputs["nn"], "point"),
        "hyp": _hyp(par, mesh, inputs["hyp"], axis="point",
                    batch_axis="data"),
    }


def _module_state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _rel_err(got: dict, want: dict) -> float:
    """The largest ``max|got - want| / max|want|`` over the tensors."""
    return max(float((got[k] - w).abs().max() / w.abs().max().clamp_min(
        1e-30)) for k, w in want.items())


def _steps(spec, weights, batches, sharding, shard):
    """Run one step case (``spec``) from the saved weights on the whole
    batches (``sharding`` None: one device) or this rank's rows; -> the
    metrics, each compared step's gradients, the trained module's state
    and the dropout generator's state."""
    from densefusion_tpu_torch.data import PoseSample, to_device
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.models.layers import Dropout2d
    from densefusion_tpu_torch.train import (
        TrainState, make_optimizer, make_pose_train_step,
        make_refine_train_step,
    )

    pose, ref = PoseNet(weights["num_obj"]), PoseRefineNet(weights["num_obj"])
    pose.load_state_dict(weights["posenet"])
    ref.load_state_dict(weights["refiner"])
    if not spec["dropout"]:
        for m in pose.modules():
            if isinstance(m, Dropout2d):
                m.p = 0.0
    state = TrainState(step=0, posenet=pose, refiner=ref,
                       optimizer=make_optimizer(pose.parameters(),
                                                spec["lr"]),
                       generator=torch.Generator().manual_seed(7))
    if spec["phase"] == 1:
        step = make_pose_train_step(state, True, spec["grad_accum"], sharding)
        module = pose
    else:
        step = make_refine_train_step(state, 2, spec["grad_accum"], sharding)
        module = ref
    metrics, grads = [], []
    for i, b in enumerate(spec["order"]):
        batch = PoseSample(*batches[b])
        if sharding is not None:
            batch = shard(batch)
        m = step(to_device(batch, "cpu"), 0.015)
        metrics.append((float(m["loss"]), float(m["dis"])))
        if (i + 1) % spec["grad_accum"] == 0:   # an applied update
            grads.append({k: p.grad.clone()
                          for k, p in module.named_parameters()
                          if p.grad is not None})
    return metrics, grads, _module_state(module), \
        state.generator.get_state()


def dp(rank, inputs):
    """Data-parallel steps, the trainer and mesh serving on one ``(data,)``
    mesh: each step case against the one-device step on the whole batch
    (computed here, so only errors travel), the trainer over one epoch, and
    ``PoseEstimator(mesh=)`` beside the meshless one."""
    from unittest import mock

    from densefusion_tpu_torch import parallel as par
    from densefusion_tpu_torch.train import steps as steps_mod

    torch.manual_seed(0)
    mesh = par.make_mesh(inputs["world"], device="cpu")
    shard = par.make_shard_batch_fn(mesh)
    weights = torch.load(inputs["weights"])
    batches = inputs["batches"]
    out = {"steps": {}}
    refs = {}
    for name, spec in inputs["steps"].items():
        key = repr(sorted((k, v) for k, v in spec.items()
                          if k not in ("control", "full")))
        if key not in refs:
            refs[key] = _steps(spec, weights, batches, None, None)
        ref = refs[key]
        if spec.get("control"):
            # each rank normalises by its own valid count
            with mock.patch.object(steps_mod._GlobalBatch, "loss",
                                   lambda self, local: local):
                got = _steps(spec, weights, batches, shard.sharding, shard)
        else:
            got = _steps(spec, weights, batches, shard.sharding, shard)
        res = {
            "metrics": got[0], "ref_metrics": ref[0],
            "grad_err": max(_rel_err(g, w) for g, w in zip(got[1], ref[1])),
            "param_err": max(float((got[2][k] - w).abs().max())
                             for k, w in ref[2].items()),
            "generator_equal": bool(torch.equal(got[3], ref[3])),
            "digest": _digest(got[2])}
        if spec.get("full") and rank == 0:
            res["grads"] = [{k: _np(v) for k, v in g.items()} for g in got[1]]
            res["params"] = {k: _np(v) for k, v in got[2].items()}
        out["steps"][name] = res
    out["trainer"] = _trainer(rank, inputs["trainer"], shard)
    out["serve"] = _serve(inputs["serve"], weights, mesh)
    return out


def _digest(state: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for v in state.values():
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _trainer(rank, spec, shard):
    """One epoch of ``Trainer(shard_batch=)``: the test distances it took
    its gates on, the files this rank wrote, its parameters' digest, and
    whether its loader's rows are the one-process loader's rows."""
    from unittest import mock

    import numpy as np

    from densefusion_tpu_torch.data import BatchLoader
    from densefusion_tpu_torch.train import Trainer, loop
    from densefusion_tpu_torch.utils.config import RunConfig
    from densefusion_tpu_torch.utils.logging import MetricsWriter

    cfg = RunConfig(**spec)
    trainer = Trainer(cfg, device="cpu", shard_batch=shard)
    tests, saves, writes = [], [], []
    test_epoch, save = trainer.test_epoch, loop.save_checkpoint

    def recorded_test():
        tests.append(test_epoch())
        return tests[-1]

    def recorded_save(path, *a, **k):
        saves.append(os.path.basename(path))
        return save(path, *a, **k)

    trainer.test_epoch = recorded_test
    if isinstance(trainer.metrics, MetricsWriter):   # a rank that writes
        write = trainer.metrics.write
        trainer.metrics.write = lambda **r: (writes.append(r["kind"]),
                                             write(**r))
    with mock.patch.object(loop, "save_checkpoint", recorded_save):
        trainer.setup()
        trainer.run()
    whole = BatchLoader(trainer.train_ds, cfg.batch_size, shuffle=True,
                        num_workers=0, seed=cfg.seed)
    rows = shard.sharding.slice(cfg.batch_size)
    same = [all(np.array_equal(a, b[rows]) for a, b in zip(mine, full))
            for mine, full in zip(trainer.train_loader.epoch(1),
                                  whole.epoch(1))]
    return {"tests": tests, "saves": saves, "writes": writes,
            "digest": trainer.param_digest(), "loader_rows_equal": same,
            "loader_shard": trainer.train_loader.shard,
            **_collective_stops(rank, trainer)}


def _collective_stops(rank, trainer):
    """The trainer's stop and restart decisions on every rank: a STOP file
    that only rank 1 sees, and an RSS limit that only rank 2 crosses."""
    import dataclasses
    from unittest import mock

    from densefusion_tpu_torch.train import loop

    out = {"stop_seen": trainer._any_rank(rank == 1)}
    trainer.cfg = dataclasses.replace(trainer.cfg, rss_restart_gb=1e6)
    with mock.patch.object(loop, "_rss_gb",
                           lambda: 2e6 if rank == 2 else 0.0):
        try:
            trainer._check_rss()
            out["restart"] = False
        except loop.RestartRequested:
            out["restart"] = True
    return out


def _serve(spec, weights, mesh):
    """``estimate_batch`` of the samples on the mesh and without it."""
    from densefusion_tpu_torch.data import PoseSample
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.serve import PoseEstimator

    samples = [PoseSample(*s) for s in spec["samples"]]
    got = {}
    for name, m in (("mesh", mesh), ("single", None)):
        nobj = weights["num_obj"]
        est = PoseEstimator(PoseNet(nobj), PoseRefineNet(nobj),
                            weights["posenet"], weights["refiner"],
                            num_points=spec["num_points"],
                            crop_size=spec["crop"], refine_iters=2,
                            device="cpu", mesh=m)
        got[name] = est.estimate_batch(samples)
    return got


def cli(rank, inputs):
    """``cli.train --data_parallel --device cpu``: the group comes from the
    launcher's environment alone; -> the trainer's epoch and digest."""
    from densefusion_tpu_torch.cli import train

    tr = train.main(inputs["argv"])
    return {"epoch": tr.curriculum.epoch, "digest": tr.param_digest(),
            "writer": tr.writer, "batch_rows": len(next(iter(
                tr.train_loader.epoch(0))).valid)}


CASES = {"line": line, "grid": grid, "dp": dp, "cli": cli}


def spawn(case: str, inputs: dict, init, world: int,
          timeout_s: float) -> list:
    """Run ``case`` on ``world`` spawned ranks, their group started from
    ``init`` (a coordinator URL or a launcher's environment); -> their
    results by rank. Raises ``RuntimeError`` with a rank's traceback, or
    when a rank gives no result within ``timeout_s``; every rank has
    exited when it returns or raises."""
    from densefusion_tpu_torch.parallel import spawn_ranks

    results = spawn_ranks(run, world, (init, case, inputs), timeout_s)
    return [results[r] for r in range(world)]


def launcher_env(world: int) -> dict:
    """The environment a launcher such as ``torchrun`` sets for a group of
    ``world`` ranks on a free localhost port (each rank adds its ``RANK``)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return {"WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def run(rank: int, world: int, init: str | dict, case: str, inputs: dict,
        queue) -> None:
    torch.set_num_threads(1)
    from densefusion_tpu_torch.parallel import initialize_distributed

    try:
        if isinstance(init, dict):
            os.environ.update(init, RANK=str(rank), LOCAL_RANK=str(rank))
        else:
            initialize_distributed(init, world, rank, device="cpu")
        res = CASES[case](rank, inputs)
        if dist.is_initialized():
            res["group"] = (dist.get_rank(), dist.get_world_size())
        queue.put((rank, res, None))
    except Exception:   # reported to the parent, which fails the test
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

