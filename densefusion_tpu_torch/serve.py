"""Serving API: raw RGB-D inputs -> pose estimates (counterpart of
``densefusion_tpu/serve.py``).

Wraps host-side sample assembly (mask -> bbox ladder -> choose ->
back-projection -> canonical crop) and the estimate + refine pipeline behind
one object; a whole frame's detections run as one batch.

Example::

    posenet, refiner = PoseNet(num_obj=21), PoseRefineNet(num_obj=21)
    est = PoseEstimator(posenet, refiner, posenet_state, refiner_state,
                        num_points=1000, crop_size=192, refine_iters=2)
    poses = est.estimate_frame(rgb, depth, label, YCB_CAM_1)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from densefusion_tpu_torch.data.common import assemble_sample
from densefusion_tpu_torch.data.schema import PoseSample, collate
from densefusion_tpu_torch.eval.pipeline import InferencePipeline
from densefusion_tpu_torch.geometry.bbox import bbox_from_mask
from densefusion_tpu_torch.geometry.camera import CameraIntrinsics


class PoseEstimator:
    def __init__(self, posenet, refiner, posenet_state, refiner_state,
                 num_points: int = 500, crop_size: int = 192,
                 refine_iters: int = 2, seed: int = 0, device=None):
        """``posenet_state`` / ``refiner_state`` are state_dicts under the
        reference's names (see :mod:`densefusion_tpu_torch.compat`), loaded
        with ``strict=True``; ``refiner_state`` may be None when there is no
        refiner. ``device=None`` means CUDA, and raises without a card."""
        posenet.load_state_dict(posenet_state, strict=True)
        if refiner is not None:
            refiner.load_state_dict(refiner_state, strict=True)
        self.num_points = num_points
        self.crop_size = crop_size
        self.pipeline = InferencePipeline(posenet, refiner,
                                          refine_iters=refine_iters,
                                          device=device)
        self.rng = np.random.default_rng(seed)

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
        cam = intrinsics

        def point_fn(rows, cols):
            z = depth[rows, cols].astype(np.float32) / cam.depth_scale
            x3 = (cols.astype(np.float32) - cam.cx) * z / cam.fx
            y3 = (rows.astype(np.float32) - cam.cy) * z / cam.fy
            return np.stack([x3, y3, z], -1) * unit_scale

        placeholder = np.zeros((8, 3), np.float32)
        return assemble_sample(
            rgb=np.asarray(rgb)[..., :3], mask=mask, bbox=bbox,
            point_fn=point_fn, model_points=placeholder, target=placeholder,
            obj_idx=obj_idx, sym=False, num_points=self.num_points,
            crop_size=self.crop_size, rng=self.rng)

    # -- inference --------------------------------------------------------

    def estimate_batch(self, samples: Sequence[PoseSample]):
        """-> numpy (quat (B, 4) wxyz, trans (B, 3) meters, conf (B,),
        valid (B,) bool)."""
        batch = collate(list(samples))
        quat, trans, conf = self.pipeline(batch.img, batch.points,
                                          batch.choose, batch.obj_idx)
        return (quat.cpu().numpy(), trans.cpu().numpy(), conf.cpu().numpy(),
                np.asarray(batch.valid))

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
