"""Nearest-neighbour search, k-NN, the ADD-S remap and the differentiable
ADD-S min distance.

Counterpart of ``densefusion_tpu/ops/knn.py``. Its three TPU kernels become
hand-written Hopper kernels:

- ``_nn_kernel`` (``densefusion_tpu/ops/knn.py:89``, rank-2 1-NN) and
  ``_nn_kernel_bt`` (``:211``, batched 1-NN) -> ``csrc/nn.cu``, entry points
  ``nn_launch`` and ``nn_batched_launch`` (wrappers :data:`nn_kernel` and
  :data:`nn_batched_kernel`);
- ``_remap_kernel_bt`` (``:303``) -> ``csrc/adds_remap.cu``
  (:data:`adds_remap_kernel`).

Beside each wrapper is its plain PyTorch version, which the CPU tests use
and which ``chip_smoke.py`` holds the kernel against on the card. The
public functions take the plain versions for CPU tensors and the kernels
for CUDA tensors; a kernel that cannot build or launch raises.

Semantics: 0-based indices (int64) of the nearest ``ref`` point per
``query`` point, ties to the lowest index. The remap outputs are
non-differentiable (the remapped target is ground truth at every call
site); :func:`adds_min_sqdist_minus_qsq` is the differentiable distance.
"""

from __future__ import annotations

import ctypes

import torch

from densefusion_tpu_torch.ops import build

# Queries per chunk of the plain search are capped so one (B, chunk, R)
# score block holds at most this many elements.
_CHUNK_ELEMS = 1 << 24


def _scores(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """q (B, Qc, 3), r (B, R, 3) -> (B, Qc, R) scores ``||r||^2 - 2 q.r``.

    Written as separate elementwise operations in a fixed order so that
    every score is rounded exactly as the CUDA kernels round it (no matmul,
    whose blocking and FMAs would round differently and could flip ties)."""
    rx, ry, rz = r[..., 0][:, None, :], r[..., 1][:, None, :], \
        r[..., 2][:, None, :]
    qx, qy, qz = q[..., 0][..., None], q[..., 1][..., None], \
        q[..., 2][..., None]
    rsq = rx * rx + ry * ry + rz * rz
    dot = qx * rx + qy * ry + qz * rz
    return rsq - dot * 2.0


def _qsq(q: torch.Tensor) -> torch.Tensor:
    """``||q||^2`` over the last axis as ``(x*x + y*y) + z*z``, the order
    ``csrc/nn.cu`` rounds it in (``.sum(-1)`` may add in another order)."""
    qx, qy, qz = q.unbind(-1)
    return qx * qx + qy * qy + qz * qz


def _nearest(query: torch.Tensor, ref: torch.Tensor):
    """Chunked brute force: (min score (B, Q), argmin index (B, Q))."""
    b, nq, _ = query.shape
    chunk = max(1, _CHUNK_ELEMS // max(1, b * ref.shape[1]))
    best, idx = [], []
    for s in range(0, nq, chunk):
        sc = _scores(query[:, s:s + chunk], ref)
        v, i = sc.min(dim=-1)    # ties -> the first (lowest) index
        best.append(v)
        idx.append(i)
    return torch.cat(best, dim=1), torch.cat(idx, dim=1)


# ---------------------------------------------------------------------------
# 1-NN: plain versions and the kernels of csrc/nn.cu
# ---------------------------------------------------------------------------

def nearest_neighbor_plain_batched(query: torch.Tensor, ref: torch.Tensor):
    """Plain version of the batched kernel: query (B, Q, 3), ref (B, R, 3)
    -> (squared distance (B, Q) float32, index (B, Q) int64)."""
    query, ref = query.float(), ref.float()
    s, i = _nearest(query, ref)
    return s + _qsq(query), i


def nearest_neighbor_plain(query: torch.Tensor, ref: torch.Tensor):
    """Plain version of the rank-2 kernel: query (Q, 3), ref (R, 3) ->
    (squared distance (Q,) float32, index (Q,) int64)."""
    d, i = nearest_neighbor_plain_batched(query[None], ref[None])
    return d[0], i[0]


class NNKernel(build.Kernel):
    """ctypes wrapper of one entry point of ``csrc/nn.cu``: ``batched``
    False is kernel 3 (query (Q, 3), ref (R, 3)), True is kernel 4
    ((B, Q, 3), (B, R, 3))."""

    def __init__(self, name: str, symbol: str, batched: bool):
        super().__init__(name, "nn", symbol, [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * (3 if batched else 2))
        self.batched = batched

    def __call__(self, query: torch.Tensor, ref: torch.Tensor):
        """float32 contiguous CUDA tensors on one device, (Q, 3) and (R, 3)
        or, batched, (B, Q, 3) and (B, R, 3) -> (squared distance float32,
        index int64), each of the query's shape without its last axis."""
        dev = build.cuda_device(self.name, query, ref)
        rank = 3 if self.batched else 2
        for name, t in (("query", query), ("ref", ref)):
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.dim() != rank or t.shape[-1] != 3:
                raise ValueError(f"{self.name} kernel: {name} must be a "
                                 f"contiguous float32 rank-{rank} (..., 3) "
                                 f"tensor, got {t.dtype} {tuple(t.shape)}")
        nq, nr = query.shape[-2], ref.shape[-2]
        bsz = query.shape[0] if self.batched else 1
        if (self.batched and ref.shape[0] != bsz) or not 1 <= bsz <= 65535 \
                or nr < 1 or max(nq, nr) >= 2 ** 31:
            raise ValueError(f"{self.name} kernel: need 1 <= B <= 65535 "
                             "matching batches and 1 <= R, Q < 2^31, got "
                             f"{tuple(query.shape)} vs {tuple(ref.shape)}")
        dist = torch.empty(query.shape[:-1], dtype=torch.float32, device=dev)
        idx = torch.empty(query.shape[:-1], dtype=torch.int64, device=dev)
        if nq == 0:
            return dist, idx
        sizes = (bsz, nq, nr) if self.batched else (nq, nr)
        self.launch(dev, query.data_ptr(), ref.data_ptr(), dist.data_ptr(),
                    idx.data_ptr(), *sizes)
        return dist, idx


def scan_split(bsz: int, n: int, m: int, min_kernel: bool = False) -> int:
    """Warps per slot of queries (1, 2, 4 or 8) that the shared scan of
    ``csrc/nn_scan.cuh`` takes: for B samples of n queries against m refs
    (``csrc/nn.cu``, ``csrc/adds_remap.cu``) or, with ``min_kernel``, for B
    rows of n hypotheses of m model points (the min kernel of
    ``csrc/add_dist.cu``). Above 1, that many warps share each query and
    merge their winners. Needs the card."""
    fn = build.load("nn").scan_split
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    return fn(int(min_kernel), bsz, n, m)


nn_kernel = NNKernel("nn", "nn_launch", batched=False)
nn_batched_kernel = NNKernel("nn_batched", "nn_batched_launch", batched=True)


def nearest_neighbor(query: torch.Tensor, ref: torch.Tensor):
    """1-NN: for each query (..., Q, 3) point, (squared distance (..., Q)
    float32, index (..., Q) int64) of the nearest ref (..., R, 3) point.

    Rank 2 is one cloud (kernel 3); a higher rank flattens the leading dims
    into a batch (kernel 4). CPU tensors take the plain versions; CUDA
    tensors the kernels, which raise if they cannot build or launch."""
    if query.dim() != ref.dim() or query.dim() < 2:
        raise ValueError(f"rank mismatch: {tuple(query.shape)} vs "
                         f"{tuple(ref.shape)}")
    query, ref = query.detach(), ref.detach()
    cpu = query.device.type == "cpu" and ref.device.type == "cpu"
    if query.dim() == 2:
        if cpu:
            return nearest_neighbor_plain(query, ref)
        return nn_kernel(query.float().contiguous(), ref.float().contiguous())
    lead = query.shape[:-2]
    q = query.reshape((-1,) + query.shape[-2:])
    r = ref.reshape((-1,) + ref.shape[-2:])
    if cpu:
        d, i = nearest_neighbor_plain_batched(q, r)
    else:
        d, i = nn_batched_kernel(q.float().contiguous(),
                                 r.float().contiguous())
    return d.reshape(lead + d.shape[-1:]), i.reshape(lead + i.shape[-1:])


def knn(query: torch.Tensor, ref: torch.Tensor, k: int = 1):
    """k-NN: (squared distances (..., Q, k), indices (..., Q, k) int64),
    ascending, exact ties lowest index first. k=1 takes the 1-NN search;
    k>1 a stable sort of the full distance matrix, as the JAX package takes
    ``lax.top_k`` outside any kernel (never needed by the pipelines;
    ``torch.topk`` leaves equal values in no set order)."""
    if k == 1:
        d, i = nearest_neighbor(query, ref)
        return d[..., None], i[..., None]
    q, r = query.float(), ref.float()
    d = ((q * q).sum(-1, keepdim=True) - 2.0 * q @ r.transpose(-1, -2)
         + (r * r).sum(-1)[..., None, :])
    d, i = torch.sort(d, dim=-1, stable=True)
    return d[..., :k], i[..., :k]


# ---------------------------------------------------------------------------
# ADD-S remap: plain version and the kernel of csrc/adds_remap.cu
# ---------------------------------------------------------------------------

def adds_remap_plain(query: torch.Tensor, ref: torch.Tensor,
                     active: torch.Tensor | None = None):
    """Plain version of the remap kernel: query (B, Q, 3), ref (B, R, 3),
    active (B,) or None -> (coords (B, Q, 3), score (B, Q)), the nearest
    ref's coordinates and its score ``||r||^2 - 2 q.r``; rows with
    ``active == 0`` are zeros."""
    query, ref = query.float(), ref.float()
    s, i = _nearest(query, ref)
    coords = torch.gather(ref, 1, i[..., None].expand(-1, -1, 3))
    if active is not None:
        keep = active.to(device=query.device, dtype=torch.bool)
        coords = torch.where(keep[:, None, None], coords, 0.0)
        s = torch.where(keep[:, None], s, 0.0)
    return coords, s


class AddsRemapKernel(build.Kernel):
    """ctypes wrapper of ``csrc/adds_remap.cu``."""

    def __init__(self):
        super().__init__("adds_remap", "adds_remap", "adds_remap_launch",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)

    def __call__(self, query: torch.Tensor, ref: torch.Tensor,
                 active: torch.Tensor | None = None):
        """query (B, Q, 3), ref (B, R, 3) float32 contiguous CUDA tensors on
        one device, active (B,) int32 or None -> (coords (B, Q, 3),
        score (B, Q)) float32."""
        dev = build.cuda_device(self.name, query, ref)
        for name, t in (("query", query), ("ref", ref)):
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.dim() != 3 or t.shape[-1] != 3:
                raise ValueError(f"{self.name} kernel: {name} must be a "
                                 "contiguous float32 (B, n, 3) tensor, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        bsz, nq, _ = query.shape
        nr = ref.shape[1]
        if ref.shape[0] != bsz or not 1 <= bsz <= 65535 or nr < 1:
            raise ValueError(f"{self.name} kernel: need 1 <= B <= 65535 "
                             "matching batches and R >= 1, got "
                             f"{tuple(query.shape)} vs {tuple(ref.shape)}")
        if active is not None and (
                active.device != dev or active.dtype != torch.int32
                or active.shape != (bsz,) or not active.is_contiguous()):
            raise ValueError(f"{self.name} kernel: active must be a "
                             f"contiguous int32 ({bsz},) tensor on {dev}")
        coords = torch.empty((bsz, nq, 3), dtype=torch.float32, device=dev)
        score = torch.empty((bsz, nq), dtype=torch.float32, device=dev)
        if nq == 0:
            return coords, score
        self.launch(dev, query.data_ptr(), ref.data_ptr(),
                    None if active is None else active.data_ptr(),
                    coords.data_ptr(), score.data_ptr(), bsz, nq, nr)
        return coords, score


adds_remap_kernel = AddsRemapKernel()


def adds_remap(query: torch.Tensor, ref: torch.Tensor,
               active: torch.Tensor | None = None):
    """(coords (B, Q, 3), score (B, Q)) of each query's nearest ref point.
    CPU tensors take the plain version; CUDA tensors the kernel, which
    raises if it cannot build or launch."""
    query, ref = query.detach(), ref.detach()
    if query.device.type == "cpu" and ref.device.type == "cpu":
        return adds_remap_plain(query, ref, active)
    if active is not None:
        active = active.to(device=query.device, dtype=torch.int32)
    return adds_remap_kernel(query.float().contiguous(),
                             ref.float().contiguous(), active)


def adds_remap_targets(pred: torch.Tensor, target: torch.Tensor,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """ADD-S target remap: for each predicted point its nearest target point.
    pred (..., P, 3), target (..., M, 3) -> (..., P, 3)."""
    lead = pred.shape[:-2]
    coords, _ = adds_remap(pred.reshape((-1,) + pred.shape[-2:]),
                           target.reshape((-1,) + target.shape[-2:]),
                           None if active is None else active.reshape(-1))
    return coords.reshape(lead + coords.shape[-2:])


# ---------------------------------------------------------------------------
# Differentiable ADD-S min distance (no (B, N, M, 3) difference tensor)
# ---------------------------------------------------------------------------

class AddsMinSqdistMinusQsq(torch.autograd.Function):
    """The remap's winning score ``d^2 - ||pred||^2`` per pred point, with
    the exact subgradient ``-2 * nearest coords`` (the argmin is
    piecewise constant; ``_min_sqdist_bwd``,
    ``densefusion_tpu/ops/knn.py:581``). target and active are data."""

    @staticmethod
    def forward(ctx, pred, target, active):
        coords, dm = adds_remap(pred, target, active)
        ctx.save_for_backward(coords)
        return dm

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        return -2.0 * g[..., None] * coords, None, None


def adds_min_sqdist_minus_qsq(pred: torch.Tensor, target: torch.Tensor,
                              active: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """pred (B, Q, 3), target (B, R, 3) -> (B, Q): each pred point's squared
    distance to its nearest target point MINUS ``||pred||^2`` (add
    ``(pred**2).sum(-1)`` for the true d^2). Differentiable in ``pred``;
    ``target`` is data. ``active`` (B,) gates rows (gated rows are zeros,
    with zero gradient). CUDA tensors launch the remap kernel, CPU tensors
    take its plain version."""
    return AddsMinSqdistMinusQsq.apply(pred.float(), target, active)
