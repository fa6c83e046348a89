"""Object-crop sample assembly (host-side numpy; counterpart of
``densefusion_tpu/data/common.py`` on its numpy path).

mask -> bbox ladder -> choose sampling -> depth back-projection -> crop
normalization, with the crop resized to one canonical size and ``choose``
remapped to it, so every sample has the same shapes.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from densefusion_tpu_torch.geometry.bbox import (
    snap_bbox, remap_choose_to_resized,
)
from densefusion_tpu_torch.data.schema import PoseSample, normalize_image


def resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) image, half-pixel convention."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h - 0.5, 0, h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


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
    rgb: np.ndarray,                  # (H, W, 3) full frame
    mask: np.ndarray,                 # (H, W) bool valid-object pixels
    bbox: tuple[int, int, int, int],  # tight (rmin, rmax, cmin, cmax)
    point_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    model_points: np.ndarray,         # (M, 3) canonical, meters
    target: np.ndarray,               # (M, 3) gt-posed, meters
    obj_idx: int,
    sym: bool,
    num_points: int,
    crop_size: int,
    rng: np.random.Generator,
) -> PoseSample:
    """Build one PoseSample. ``point_fn(rows, cols) -> (n, 3)`` back-projects
    absolute pixel coordinates to metric 3D."""
    h, w = mask.shape
    rmin, rmax, cmin, cmax = snap_bbox(*bbox, img_h=h, img_w=w)
    crop_h, crop_w = rmax - rmin, cmax - cmin

    choose = choose_mask_pixels(mask[rmin:rmax, cmin:cmax], num_points, rng)
    if choose is None:
        return PoseSample.invalid(num_points, model_points.shape[0], crop_size)

    rows = rmin + choose // crop_w
    cols = cmin + choose % crop_w
    cloud = point_fn(rows, cols).astype(np.float32)

    img = normalize_image(rgb[rmin:rmax, cmin:cmax])
    if (crop_h, crop_w) != (crop_size, crop_size):
        img = resize_bilinear_np(img, crop_size, crop_size)
        choose = remap_choose_to_resized(choose, crop_h, crop_w,
                                         crop_size, crop_size)

    return PoseSample(
        points=cloud,
        choose=choose.astype(np.int32),
        img=img.astype(np.float32),
        target=np.asarray(target, np.float32),
        model_points=np.asarray(model_points, np.float32),
        obj_idx=np.asarray(obj_idx, np.int32),
        sym=np.asarray(sym, bool),
        valid=np.ones((), bool),
    )
