"""Nearest-neighbour search and the ADD-S remap.

Counterpart of ``densefusion_tpu/ops/knn.py``. The TPU kernel on the serving
path, ``_remap_kernel_bt`` (``densefusion_tpu/ops/knn.py:303``), becomes the
hand-written Hopper kernel ``csrc/adds_remap.cu``; beside it here is its
plain PyTorch version, which the CPU tests use and which ``chip_smoke.py``
holds the kernel against on the card.

Semantics: 0-based indices of the nearest ``ref`` point per ``query`` point,
ties to the lowest index. The remap outputs are non-differentiable (the
remapped target is ground truth at every call site).
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
    every score is rounded exactly as the CUDA kernel rounds it (no matmul,
    whose blocking and FMAs would round differently and could flip ties)."""
    rx, ry, rz = r[..., 0][:, None, :], r[..., 1][:, None, :], \
        r[..., 2][:, None, :]
    qx, qy, qz = q[..., 0][..., None], q[..., 1][..., None], \
        q[..., 2][..., None]
    rsq = rx * rx + ry * ry + rz * rz
    dot = qx * rx + qy * ry + qz * rz
    return rsq - dot * 2.0


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


def nearest_neighbor(query: torch.Tensor, ref: torch.Tensor):
    """Plain 1-NN: query (B, Q, 3), ref (B, R, 3) -> (squared distance
    (B, Q), index (B, Q) int64), ties to the lowest index."""
    query, ref = query.float(), ref.float()
    s, i = _nearest(query, ref)
    return s + (query * query).sum(-1), i


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


class AddsRemapKernel:
    """ctypes wrapper of ``csrc/adds_remap.cu``. ``launches`` counts the
    kernel's launches; nothing else changes it."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            fn = build.load("adds_remap").adds_remap_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, query: torch.Tensor, ref: torch.Tensor,
                 active: torch.Tensor | None = None):
        """query (B, Q, 3), ref (B, R, 3) float32 contiguous CUDA tensors on
        one device, active (B,) int32 or None -> (coords (B, Q, 3),
        score (B, Q)) float32."""
        dev = query.device
        if dev.type != "cuda" or ref.device != dev:
            raise ValueError("adds_remap kernel: query and ref must be on "
                             f"one CUDA device, got {dev} and {ref.device}")
        for name, t in (("query", query), ("ref", ref)):
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.dim() != 3 or t.shape[-1] != 3:
                raise ValueError(f"adds_remap kernel: {name} must be a "
                                 "contiguous float32 (B, n, 3) tensor, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        bsz, nq, _ = query.shape
        nr = ref.shape[1]
        if ref.shape[0] != bsz or not 1 <= bsz <= 65535 or nr < 1:
            raise ValueError("adds_remap kernel: need 1 <= B <= 65535 "
                             "matching batches and R >= 1, got "
                             f"{tuple(query.shape)} vs {tuple(ref.shape)}")
        if active is not None and (
                active.device != dev or active.dtype != torch.int32
                or active.shape != (bsz,) or not active.is_contiguous()):
            raise ValueError("adds_remap kernel: active must be a contiguous "
                             f"int32 ({bsz},) tensor on {dev}")
        coords = torch.empty((bsz, nq, 3), dtype=torch.float32, device=dev)
        score = torch.empty((bsz, nq), dtype=torch.float32, device=dev)
        if nq == 0:
            return coords, score
        fn = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(query.data_ptr(), ref.data_ptr(),
                     None if active is None else active.data_ptr(),
                     coords.data_ptr(), score.data_ptr(), bsz, nq, nr, stream)
        if err != 0:
            raise RuntimeError(f"adds_remap kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
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
