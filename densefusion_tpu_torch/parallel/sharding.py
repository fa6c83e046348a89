"""Batch placement over a mesh: axis-0 slices and replication.

Counterpart of ``densefusion_tpu/parallel/sharding.py``. A JAX array is
global and its sharding says which device holds which part; here every rank
is its own process, so placing a batch means each rank keeping its own
axis-0 slice, and replicating means broadcasting from rank 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class BatchSharding:
    """One mesh axis as this rank sees it: the axis's process group, its
    number of ranks and this rank's place on it."""

    group: ProcessGroup
    size: int
    index: int

    def slice(self, n: int) -> slice:
        """This rank's part of an axis of length ``n``, which the axis's
        size must divide."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not split over "
                             f"{self.size} ranks")
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> BatchSharding:
    """The sharding that splits axis 0 over the mesh axis ``axis``."""
    dim = mesh.mesh_dim_names.index(axis)
    return BatchSharding(mesh.get_group(axis), mesh.size(dim),
                         mesh.get_local_rank(axis))


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate(tree: Any, over: DeviceMesh | BatchSharding,
              in_place: bool = False) -> Any:
    """Every tensor of ``tree`` as the first rank holds it, on every rank:
    of the whole mesh (``over`` a ``DeviceMesh``) or of one axis's group
    (``over`` a :class:`BatchSharding`). Copies, the inputs untouched; or,
    with ``in_place``, the tensors themselves overwritten (modules'
    parameters and buffers). Other leaves pass through."""
    group = over.group if isinstance(over, BatchSharding) else None
    src = 0 if group is None else dist.get_global_rank(group, 0)

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        out = x.data if in_place else x.detach().clone().contiguous()
        dist.broadcast(out, src=src, group=group)
        return out
    return _tree_map(bcast, tree)


def make_shard_batch_fn(mesh: DeviceMesh, axis: str = "data"):
    """Returns f(batch) keeping this rank's axis-0 slice of every leaf with
    ``ndim >= 1`` (tensors or numpy arrays); scalars and 0-d leaves stay
    whole, as JAX replicates them. ``f.sharding`` is the axis's
    :class:`BatchSharding`: ``Trainer(shard_batch=f)`` reads it to load and
    step on this rank's rows only."""
    sharding = batch_sharding(mesh, axis)

    def f(batch):
        return _tree_map(
            lambda x: x[sharding.slice(x.shape[0])]
            if getattr(x, "ndim", 0) >= 1 else x, batch)

    f.sharding = sharding
    return f

