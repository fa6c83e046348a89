"""Object-crop sample assembly shared by the dataset readers and serving
(host-side; counterpart of ``densefusion_tpu/data/common.py``).

mask -> bbox ladder -> choose sampling -> depth back-projection -> crop
normalization, with the crop resized to one canonical size and ``choose``
remapped to it, so every sample has the same shapes. Back-projection and
the fused normalize + resize and ``choose`` remap run in the host library
(:mod:`densefusion_tpu_torch.native`); the numpy code is their plain
version.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from densefusion_tpu_torch import native
from densefusion_tpu_torch.geometry.bbox import (
    snap_bbox, remap_choose_to_resized,
)
from densefusion_tpu_torch.data.schema import (
    PoseSample, normalize_image, IMAGENET_MEAN_255, IMAGENET_STD_255,
)
from densefusion_tpu_torch.data.augment import resize_bilinear_np


def pinhole_point_fn(depth: np.ndarray, cam, depth_scale: float,
                     unit_scale: float = 1.0):
    """Returns ``point_fn(rows, cols) -> (n, 3)`` back-projecting those
    pixels of ``depth`` through the host library (the same float32
    arithmetic as :func:`pinhole_point_fn_np`). ``cam`` needs fx/fy/cx/cy
    attributes; ``depth_scale`` converts raw depth units, ``unit_scale``
    converts to meters."""
    if not native.available():
        return pinhole_point_fn_np(depth, cam, depth_scale, unit_scale)

    def point_fn(rows, cols):
        return native.backproject(
            depth[rows, cols], rows, cols, cam.fx, cam.fy, cam.cx, cam.cy,
            depth_scale, unit_scale)
    return point_fn


def pinhole_point_fn_np(depth: np.ndarray, cam, depth_scale: float,
                        unit_scale: float = 1.0):
    """The numpy back-projection: :func:`pinhole_point_fn`'s plain version,
    and the serving path's (as in the JAX package's ``serve.py``)."""
    def point_fn(rows, cols):
        z = np.asarray(depth)[rows, cols].astype(np.float32) / depth_scale
        x3 = (cols.astype(np.float32) - cam.cx) * z / cam.fx
        y3 = (rows.astype(np.float32) - cam.cy) * z / cam.fy
        return np.stack([x3, y3, z], -1) * unit_scale
    return point_fn


def choose_mask_pixels(mask_crop: np.ndarray, num_points: int,
                       rng: np.random.Generator) -> np.ndarray | None:
    """Flat indices of up to ``num_points`` True pixels of a crop mask: a
    uniform subsample when there are more, wrap-padding when fewer. None for
    an empty mask."""
    choose = np.flatnonzero(mask_crop.reshape(-1))
    if choose.size == 0:
        return None
    if choose.size > num_points:
        choose = rng.choice(choose, size=num_points, replace=False)
        choose.sort()
    else:
        choose = np.pad(choose, (0, num_points - choose.size), "wrap")
    return choose.astype(np.int64)


def assemble_sample(
    *,
    rgb: np.ndarray | None = None,   # (H, W, 3) full frame
    mask: np.ndarray | None = None,  # (H, W) bool valid-object pixels
    bbox: tuple[int, int, int, int],  # tight (rmin, rmax, cmin, cmax)
    point_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    model_points: np.ndarray,        # (M, 3) canonical, meters
    target: np.ndarray,              # (M, 3) gt-posed, meters
    obj_idx: int,
    sym: bool,
    num_points: int,
    crop_size: int,
    rng: np.random.Generator,
    add_t: np.ndarray | None = None,  # (3,) translation noise, meters
    rgb_transform=None,               # applied to the crop (e.g. jitter)
    crop_fn=None,                     # (rmin, rmax, cmin, cmax) -> crop rgb
    mask_fn=None,                     # (rmin, rmax, cmin, cmax) -> bool window
    frame_hw: tuple[int, int] | None = None,  # (H, W), required with mask_fn
    native_crop: bool = False,        # keep the snapped crop's own shape
) -> PoseSample:
    """Build one PoseSample. ``point_fn(rows, cols) -> (n, 3)`` back-projects
    absolute pixel coordinates to metric 3D.

    ``rgb_transform`` runs on the snapped crop only. ``crop_fn`` produces
    the finished crop for the snapped window instead of slicing ``rgb``
    (compositing, noise and jitter restricted to the pixels used). ``mask_fn``
    likewise produces just the snapped window of the mask instead of a
    full-frame ``mask``. ``native_crop=True`` keeps the snapped crop's shape
    with ``choose`` in its coordinates (the reference's exact input
    geometry; such samples batch only with crops of the same shape).
    """
    h, w = frame_hw if mask is None else mask.shape
    rmin, rmax, cmin, cmax = snap_bbox(*bbox, img_h=h, img_w=w)
    crop_h, crop_w = rmax - rmin, cmax - cmin

    mask_win = (mask[rmin:rmax, cmin:cmax] if mask is not None
                else mask_fn(rmin, rmax, cmin, cmax))
    choose = choose_mask_pixels(mask_win, num_points, rng)
    if choose is None:
        return PoseSample.invalid(num_points, model_points.shape[0], crop_size)

    rows = rmin + choose // crop_w
    cols = cmin + choose % crop_w
    cloud = point_fn(rows, cols).astype(np.float32)

    tgt = np.asarray(target, np.float32)
    if add_t is not None:
        cloud = cloud + add_t
        tgt = tgt + add_t

    if crop_fn is not None:
        crop_rgb = crop_fn(rmin, rmax, cmin, cmax)
    else:
        crop_rgb = rgb[rmin:rmax, cmin:cmax]
    if rgb_transform is not None:
        crop_rgb = rgb_transform(crop_rgb)
    choose = (rows - rmin) * crop_w + (cols - cmin)
    resized = (crop_h, crop_w) != (crop_size, crop_size)
    if native_crop:
        img = normalize_image(crop_rgb)
    elif native.available():
        # the library normalizes and resizes in one pass, even at size
        img = native.normalize_resize(crop_rgb, crop_size, crop_size,
                                      IMAGENET_MEAN_255, IMAGENET_STD_255)
        if resized:
            choose = native.remap_choose(choose, crop_h, crop_w,
                                         crop_size, crop_size)
    else:
        img = normalize_image(crop_rgb)
        if resized:
            img = resize_bilinear_np(img, crop_size, crop_size)
            choose = remap_choose_to_resized(choose, crop_h, crop_w,
                                             crop_size, crop_size)

    return PoseSample(
        points=cloud,
        choose=choose.astype(np.int32),
        img=img.astype(np.float32),
        target=tgt,
        model_points=np.asarray(model_points, np.float32),
        obj_idx=np.asarray(obj_idx, np.int32),
        sym=np.asarray(sym, bool),
        valid=np.ones((), bool),
    )


def subsample_model_points(points: np.ndarray, num: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Random subset of ``num`` model points (tiled when there are fewer)."""
    if len(points) <= num:
        reps = -(-num // len(points))
        return np.tile(points, (reps, 1))[:num]
    idx = rng.choice(len(points), size=num, replace=False)
    return points[idx]
