"""Sample schema and batch collation (host-side numpy; counterpart of
``densefusion_tpu/data/schema.py``)."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# (v/255 - mean)/std == (v - mean*255)/(std*255): one fused step on 0-255.
IMAGENET_MEAN_255 = IMAGENET_MEAN * 255.0
IMAGENET_STD_255 = IMAGENET_STD * 255.0


def normalize_image(img_hwc_uint8_or_float: np.ndarray,
                    raw255: bool = False) -> np.ndarray:
    """(H, W, 3) 0-255 pixels -> ImageNet-normalized float32. ``raw255=True``
    normalizes the raw 0-255 values as the reference does."""
    img = np.asarray(img_hwc_uint8_or_float, np.float32)
    if raw255:
        return (img - IMAGENET_MEAN) / IMAGENET_STD
    return (img - IMAGENET_MEAN_255) / IMAGENET_STD_255


class PoseSample(NamedTuple):
    """One object-crop sample: the six tensors of the reference's dataset
    contract plus sym/valid flags."""

    points: np.ndarray        # (N, 3) f32 back-projected cloud, meters
    choose: np.ndarray        # (N,) i32 flat pixel index into the crop
    img: np.ndarray           # (H, W, 3) f32 normalized crop
    target: np.ndarray        # (M, 3) f32 gt-posed model points
    model_points: np.ndarray  # (M, 3) f32 canonical model points
    obj_idx: np.ndarray       # () i32 class index
    sym: np.ndarray           # () bool symmetric-object flag
    valid: np.ndarray         # () bool False == lost detection (empty mask)

    @staticmethod
    def invalid(num_points: int, num_mesh: int, crop: int) -> "PoseSample":
        """Lost-detection stand-in with the static shapes of a real sample,
        so batches stay uniform; consumers mask it out via ``valid``."""
        return PoseSample(
            points=np.zeros((num_points, 3), np.float32),
            choose=np.zeros((num_points,), np.int32),
            img=np.zeros((crop, crop, 3), np.float32),
            target=np.zeros((num_mesh, 3), np.float32),
            model_points=np.full((num_mesh, 3), 1e-3, np.float32),
            obj_idx=np.zeros((), np.int32),
            sym=np.zeros((), bool),
            valid=np.zeros((), bool),
        )


def collate(samples: Sequence[PoseSample]) -> PoseSample:
    """Stack samples into a batched PoseSample of (B, ...) arrays."""
    return PoseSample(*(np.stack([getattr(s, f) for s in samples])
                        for f in PoseSample._fields))
