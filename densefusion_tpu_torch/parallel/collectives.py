"""Mesh-sharded nearest-neighbour searches, the hypothesis-sharded ADD(-S)
distance and metric reductions, over ``torch.distributed``.

Counterpart of ``densefusion_tpu/parallel/collectives.py``. Each function
takes the global tensors (every rank passes the same ones, as the JAX
functions take global arrays), computes this rank's part and returns the
whole result, gathered, on every rank:

* :func:`sharded_nearest_neighbor`: the reference axis sharded, queries
  replicated. Each rank searches its reference shard (kernel 3 on the
  card) and two ``all_reduce(MIN)`` resolve the winner: the distance, then
  the smallest global index attaining it.
* :func:`ring_nearest_neighbor`: both axes sharded. Each rank keeps its
  query shard while the reference tiles rotate around the ring, with a
  running (min, argmin) per local query; per-rank memory is O(Q/S + R/S).
* :func:`sharded_hypothesis_mean_dist`: the fused ADD(-S) distance with the
  hypothesis axis sharded (and the batch, on a ``(data, point)`` mesh).

Non-divisible axes are padded: refs with far-away sentinel points that
never win, hypotheses and queries with zeros that are cut off again.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from densefusion_tpu_torch.ops.add_dist import hypothesis_mean_dist
from densefusion_tpu_torch.ops.knn import nearest_neighbor
from densefusion_tpu_torch.parallel.sharding import (
    BatchSharding, batch_sharding,
)

# Padded reference rows sit at this coordinate: squared distance ~3e30, huge
# but finite in float32 (inf coordinates would make ||r||^2 - 2 q.r NaN).
_SENTINEL = 1.0e15
_NO_INDEX = torch.iinfo(torch.int64).max


def _pad_axis0(x: torch.Tensor, multiple: int, value: float) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + x.shape[1:], value)])


class _AllGather(torch.autograd.Function):
    """Concatenate every rank's ``x`` along ``dim`` in axis order. The
    result is replicated, so every rank is taken to compute the same loss
    from it: the backward keeps this rank's slice of the incoming gradient
    (a SUM reduce-scatter would scale it by the number of ranks)."""

    @staticmethod
    def forward(ctx, x, dim: int, sharding: BatchSharding):
        ctx.dim, ctx.sharding = dim, sharding
        parts = [torch.empty_like(x) for _ in range(sharding.size)]
        dist.all_gather(parts, x.contiguous(), group=sharding.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        sl = ctx.sharding.slice(g.shape[ctx.dim])
        return g.narrow(ctx.dim, sl.start, sl.stop - sl.start), None, None


def _gather(x: torch.Tensor, sharding: BatchSharding,
            dim: int = 0) -> torch.Tensor:
    return _AllGather.apply(x, dim, sharding)


class _Shard(torch.autograd.Function):
    """This rank's slice along ``dim`` of an ``x`` every rank holds whole.
    The gradient reaching the slice is this rank's part only, so the
    backward sums the ranks' parts (each zero outside its slice): every rank
    then holds the whole gradient of ``x``, as JAX gives the whole gradient
    of a global array."""

    @staticmethod
    def forward(ctx, x, dim: int, sharding: BatchSharding):
        ctx.dim, ctx.sharding, ctx.n = dim, sharding, x.shape[dim]
        sl = sharding.slice(ctx.n)
        return x.narrow(dim, sl.start, sl.stop - sl.start).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        sl = ctx.sharding.slice(ctx.n)
        shape = list(g.shape)
        shape[ctx.dim] = ctx.n
        full = g.new_zeros(shape)
        full.narrow(ctx.dim, sl.start, sl.stop - sl.start).copy_(g)
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=ctx.sharding.group)
        return full, None, None


def _shard(x: torch.Tensor, sharding: BatchSharding,
           dim: int = 0) -> torch.Tensor:
    return _Shard.apply(x, dim, sharding)


def sharded_nearest_neighbor(query: torch.Tensor, ref: torch.Tensor,
                             mesh: DeviceMesh, axis: str = "data"):
    """1-NN with the reference axis sharded over ``axis``.

    query (Q, 3) replicated, ref (R, 3) any R (sentinel-padded to the axis
    size) -> (squared distance (Q,) float32, index (Q,) int64), global
    0-based indices into ref, the same on every rank. Exact ties across
    shards go to the smallest global index."""
    sh = batch_sharding(mesh, axis)
    ref_p = _pad_axis0(ref.detach().float(), sh.size, _SENTINEL)
    shard = ref_p[sh.slice(ref_p.shape[0])]
    d, i = nearest_neighbor(query.detach().float(), shard)
    d = d.clamp_min(0.0)
    best = d.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MIN, group=sh.group)
    cand = torch.where(d == best, i + sh.index * shard.shape[0], _NO_INDEX)
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=sh.group)
    return best, cand


def ring_nearest_neighbor(query: torch.Tensor, ref: torch.Tensor,
                          mesh: DeviceMesh, axis: str = "data"):
    """1-NN with both the query and the reference axis sharded over
    ``axis``: each rank holds Q/S queries and one R/S reference tile; the
    tiles rotate S - 1 times around the ring (rank j sends to j - 1, so
    after step s rank ``me`` holds the tile of ``(me + s) % S``). query
    (Q, 3), ref (R, 3), any sizes -> (squared distance (Q,), index (Q,)
    int64) on every rank; indices global, ties to the smallest."""
    sh = batch_sharding(mesh, axis)
    n_q = query.shape[0]
    q_p = _pad_axis0(query.detach().float(), sh.size, 0.0)
    ref_p = _pad_axis0(ref.detach().float(), sh.size, _SENTINEL)
    q_local = q_p[sh.slice(q_p.shape[0])]
    tile = ref_p[sh.slice(ref_p.shape[0])]
    shard_size = tile.shape[0]
    best_d = torch.full(q_local.shape[:1], float("inf"), device=q_p.device)
    best_i = torch.full(q_local.shape[:1], _NO_INDEX, device=q_p.device)
    send_to = dist.get_global_rank(sh.group, (sh.index - 1) % sh.size)
    recv_from = dist.get_global_rank(sh.group, (sh.index + 1) % sh.size)
    for s in range(sh.size):
        owner = (sh.index + s) % sh.size
        d, i = nearest_neighbor(q_local, tile)
        gi = i + owner * shard_size
        # exact ties resolve to the smaller global index, so the result
        # does not depend on the rotation order
        take = (d < best_d) | ((d == best_d) & (gi < best_i))
        best_d = torch.where(take, d, best_d)
        best_i = torch.where(take, gi, best_i)
        if s + 1 < sh.size:
            nxt = torch.empty_like(tile)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, tile, send_to, sh.group),
                    dist.P2POp(dist.irecv, nxt, recv_from, sh.group)]):
                req.wait()
            tile = nxt
    return _gather(best_d, sh)[:n_q], _gather(best_i, sh)[:n_q]


def sharded_hypothesis_mean_dist(R: torch.Tensor, t: torch.Tensor,
                                 model: torch.Tensor, target: torch.Tensor,
                                 sym: torch.Tensor, mesh: DeviceMesh,
                                 axis: str = "data", *,
                                 batch_axis: str | None = None,
                                 use_adds: bool = True) -> torch.Tensor:
    """Fused ADD(-S) hypothesis distance with the hypothesis axis sharded
    over ``axis``: each rank runs
    :func:`~densefusion_tpu_torch.ops.add_dist.hypothesis_mean_dist` on its
    slice of the N hypotheses (zero-padded to the axis size). On a
    ``(data, point)`` mesh, ``batch_axis`` also shards the batch, so a
    data-parallel step composes with hypothesis sharding.

    R (B, N, 3, 3), t (B, N, 3), model / target (B, M, 3), sym (B,) ->
    dis (B, N) on every rank, differentiable in (R, t). Every rank must
    compute the same loss from ``dis`` and run its backward; each rank then
    holds the whole gradient of (R, t)."""
    n = R.shape[1]
    sh = batch_sharding(mesh, axis)
    pad = (-n) % sh.size
    if pad:
        R = torch.cat([R, R.new_zeros((R.shape[0], pad, 3, 3))], dim=1)
        t = torch.cat([t, t.new_zeros((t.shape[0], pad, 3))], dim=1)
    if batch_axis is not None:
        bsh = batch_sharding(mesh, batch_axis)
        rows = bsh.slice(R.shape[0])
        R, t = _shard(R, bsh), _shard(t, bsh)
        model, target, sym = model[rows], target[rows], sym[rows]
    dis = hypothesis_mean_dist(_shard(R, sh, 1), _shard(t, sh, 1), model,
                               target, sym, use_adds=use_adds)
    dis = _gather(dis, sh, dim=1)
    if batch_axis is not None:
        dis = _gather(dis, bsh, dim=0)
    return dis[:, :n]


def psum_mean(x: torch.Tensor, mesh: DeviceMesh,
              axis: str = "data") -> torch.Tensor:
    """Mean of ``x`` over the ranks of a mesh axis, for metric reductions."""
    sh = batch_sharding(mesh, axis)
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=sh.group)
    return out / sh.size
