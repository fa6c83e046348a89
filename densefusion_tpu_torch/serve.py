"""Serving API: raw RGB-D inputs -> pose estimates (counterpart of
``densefusion_tpu/serve.py``).

Wraps host-side sample assembly (mask -> bbox ladder -> choose ->
back-projection -> canonical crop) and the estimate + refine pipeline behind
one object; a whole frame's detections run as one batch.

Example::

    est = PoseEstimator.from_checkpoint(
        "trained_models/ycb/checkpoint_best_refine", num_obj=21,
        num_points=1000)
    poses = est.estimate_frame(rgb, depth, label, YCB_CAM_1)

or from state_dicts under the reference's names::

    posenet, refiner = PoseNet(num_obj=21), PoseRefineNet(num_obj=21)
    est = PoseEstimator(posenet, refiner, posenet_state, refiner_state,
                        num_points=1000, crop_size=192, refine_iters=2)

Over several cards, one process per card, each calling with the same
samples (``densefusion_tpu_torch.parallel.make_mesh``)::

    est = PoseEstimator.from_checkpoint(..., mesh=make_mesh())
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from densefusion_tpu_torch.data.common import (
    assemble_sample, pinhole_point_fn_np,
)
from densefusion_tpu_torch.data.schema import PoseSample, collate
from densefusion_tpu_torch.eval.pipeline import InferencePipeline
from densefusion_tpu_torch.geometry.bbox import bbox_from_mask
from densefusion_tpu_torch.geometry.camera import CameraIntrinsics
from densefusion_tpu_torch.utils.profiling import span


class PoseEstimator:
    def __init__(self, posenet, refiner, posenet_state, refiner_state,
                 num_points: int = 500, crop_size: int = 192,
                 refine_iters: int = 2, seed: int = 0, device=None,
                 mesh=None):
        """``posenet_state`` / ``refiner_state`` are state_dicts under the
        reference's names (see :mod:`densefusion_tpu_torch.compat`), loaded
        with ``strict=True``; ``refiner_state`` may be None when there is no
        refiner. ``device=None`` means CUDA, and raises without a card.

        ``mesh`` (a ``DeviceMesh`` with a ``data`` axis; every rank builds
        its estimator and calls it with the same samples) serves over its
        ranks, as ``densefusion_tpu/serve.py``'s ``mesh=`` does: rank 0's
        parameters are replicated once, each batch is padded to a multiple
        of the ranks with invalid samples, each rank runs its rows, and the
        poses are gathered, so every rank returns the whole batch. ``device``
        must be the mesh's (the rank's card, or the CPU under gloo)."""
        from densefusion_tpu_torch.parallel.sharding import (
            batch_sharding, replicate,
        )

        posenet.load_state_dict(posenet_state, strict=True)
        if refiner is not None:
            refiner.load_state_dict(refiner_state, strict=True)
        self.num_points = num_points
        self.crop_size = crop_size
        self.pipeline = InferencePipeline(posenet, refiner,
                                          refine_iters=refine_iters,
                                          device=device)
        self.rng = np.random.default_rng(seed)
        self.sharding = None if mesh is None else batch_sharding(mesh)
        if self.sharding is not None:
            nets = [m for m in (posenet, refiner) if m is not None]
            replicate([t for m in nets
                       for t in (*m.parameters(), *m.buffers())],
                      self.sharding, in_place=True)

    @classmethod
    def from_checkpoint(cls, path: str, num_obj: int, num_points: int = 500,
                        crop_size: int = 192, refine_iters: int | None = None,
                        bf16: bool = False, **kwargs) -> "PoseEstimator":
        """An estimator from a checkpoint directory of either package
        (parameters only: ``restore_opt=False``), with the checkpoint's
        decoder (``decoder_flags()`` of its config); ``bf16=True`` serves
        with bf16 compute (``densefusion_tpu/serve.py:64,78-86``).
        ``refine_iters=None`` takes the checkpoint's trained depth (2 when
        it has no config); an untrained refiner clamps it to 0 with a
        warning (``clamp_refine_iters``)."""
        import torch

        from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
        from densefusion_tpu_torch.train.checkpoint import (
            clamp_refine_iters, load_state_dicts, peek_config,
        )

        ck_cfg = peek_config(path)
        if refine_iters is None:
            refine_iters = getattr(ck_cfg, "refine_iters", None) or 2
        refine_iters = clamp_refine_iters(path, refine_iters)
        flags = ck_cfg.decoder_flags() if ck_cfg is not None else {}
        dtype = torch.bfloat16 if bf16 else None
        posenet_state, refiner_state = load_state_dicts(path)
        return cls(PoseNet(num_obj, dtype=dtype, **flags),
                   PoseRefineNet(num_obj, dtype=dtype), posenet_state,
                   refiner_state, num_points=num_points, crop_size=crop_size,
                   refine_iters=refine_iters, **kwargs)

    # -- host-side assembly ----------------------------------------------

    def make_sample(self, rgb: np.ndarray, depth: np.ndarray,
                    mask: np.ndarray, obj_idx: int,
                    intrinsics: CameraIntrinsics,
                    unit_scale: float = 1.0,
                    bbox: tuple[int, int, int, int] | None = None
                    ) -> PoseSample:
        """Raw frame + object mask -> one PoseSample (target / model points
        are placeholders: serving needs only the estimate)."""
        depth = np.asarray(depth)
        mask = np.asarray(mask, bool) & (depth != 0)
        if bbox is None:
            bbox = bbox_from_mask(mask)
            if bbox is None:
                return PoseSample.invalid(self.num_points, 8, self.crop_size)
        point_fn = pinhole_point_fn_np(depth, intrinsics,
                                       intrinsics.depth_scale, unit_scale)
        placeholder = np.zeros((8, 3), np.float32)
        return assemble_sample(
            rgb=np.asarray(rgb)[..., :3], mask=mask, bbox=bbox,
            point_fn=point_fn, model_points=placeholder, target=placeholder,
            obj_idx=obj_idx, sym=False, num_points=self.num_points,
            crop_size=self.crop_size, rng=self.rng)

    # -- inference --------------------------------------------------------

    def estimate_batch(self, samples: Sequence[PoseSample]):
        """-> numpy (quat (B, 4) wxyz, trans (B, 3) meters, conf (B,),
        valid (B,) bool). On a mesh, every rank passes the same samples and
        gets the whole batch's poses."""
        samples = list(samples)
        n = len(samples)
        with span("serve.request", units=n):
            sh = self.sharding
            if sh is not None:
                pad = PoseSample.invalid(self.num_points,
                                         samples[0].model_points.shape[0],
                                         self.crop_size)
                samples += [pad] * (-n % sh.size)
            with span("serve.collate"):
                batch = collate(samples)
            rows = batch if sh is None else PoseSample(
                *(x[sh.slice(len(samples))] for x in batch))
            out = self.pipeline(rows.img, rows.points, rows.choose,
                                rows.obj_idx)
            if sh is not None:
                out = tuple(_gather_rows(x, sh) for x in out)
            quat, trans, conf = (x[:n].cpu().numpy() for x in out)
        return quat, trans, conf, np.asarray(batch.valid)[:n]

    def estimate(self, rgb, depth, mask, obj_idx, intrinsics,
                 unit_scale: float = 1.0, bbox=None):
        """One detection -> (quat (4,), trans (3,), conf), or None for an
        empty mask (lost detection)."""
        sample = self.make_sample(rgb, depth, mask, obj_idx, intrinsics,
                                  unit_scale, bbox)
        if not sample.valid:
            return None
        q, t, c, _ = self.estimate_batch([sample])
        return q[0], t[0], float(c[0])

    def estimate_frame(self, rgb, depth, label, intrinsics,
                       unit_scale: float = 1.0,
                       object_ids: Sequence[int] | None = None,
                       min_pixels: int = 50,
                       label_to_class=lambda label_id: label_id - 1):
        """All objects of one frame as ONE batch.

        ``label`` is an integer object-id map (segmenter output or PoseCNN
        labels); every id present (or each of ``object_ids``) with at least
        ``min_pixels`` depth-valid pixels becomes one detection. Returns
        ``{label_id: (quat (4,) wxyz, trans (3,), conf)}``; undetected or
        too-small objects are absent.
        """
        label = np.asarray(label)
        ids = (sorted(int(i) for i in np.unique(label) if i != 0)
               if object_ids is None else list(object_ids))
        samples, kept = [], []
        for i in ids:
            sample = self.make_sample(rgb, depth, label == i,
                                      label_to_class(i), intrinsics,
                                      unit_scale)
            if sample.valid and int(np.count_nonzero(
                    (label == i) & (np.asarray(depth) != 0))) >= min_pixels:
                samples.append(sample)
                kept.append(i)
        if not samples:
            return {}
        quat, trans, conf, _ = self.estimate_batch(samples)
        return {i: (quat[k], trans[k], float(conf[k]))
                for k, i in enumerate(kept)}


def _gather_rows(x: torch.Tensor, sharding) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in rank order."""
    parts = [torch.empty_like(x) for _ in range(sharding.size)]
    dist.all_gather(parts, x.contiguous(), group=sharding.group)
    return torch.cat(parts)
