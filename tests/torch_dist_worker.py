"""One rank of the port's multi-process CPU tests (``test_torch_parallel.py``).

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


CASES = {"line": line, "grid": grid}


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
        res["group"] = (dist.get_rank(), dist.get_world_size())
        queue.put((rank, res, None))
    except Exception:   # reported to the parent, which fails the test
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

