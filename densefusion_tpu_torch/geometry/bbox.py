"""Bounding-box ladder utilities (host-side numpy; counterpart of
``densefusion_tpu/geometry/bbox.py``).

Every object crop snaps to one of 17 sizes in 40-px steps, then is resized
to one canonical size with its ``choose`` indices remapped, so one set of
tensor shapes covers all crops.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# The reference's `border_list`.
BORDER_LADDER = [-1, 40, 80, 120, 160, 200, 240, 280, 320, 360, 400, 440, 480,
                 520, 560, 600, 640, 680]


def _snap_up(extent: int) -> int:
    """Smallest ladder rung strictly greater than ``extent``; an extent
    exactly on a rung (or past the top) is left unchanged."""
    for lo, hi in zip(BORDER_LADDER[:-1], BORDER_LADDER[1:]):
        if lo < extent < hi:
            return hi
    return extent


def snap_bbox(rmin: int, rmax: int, cmin: int, cmax: int,
              img_h: int = 480, img_w: int = 640):
    """Snap a bbox to the size ladder, re-center it, and shift it inside the
    image. Returns (rmin, rmax, cmin, cmax)."""
    r_b = _snap_up(rmax - rmin)
    c_b = _snap_up(cmax - cmin)
    center_r = (rmin + rmax) // 2
    center_c = (cmin + cmax) // 2
    rmin, rmax = center_r - r_b // 2, center_r + r_b // 2
    cmin, cmax = center_c - c_b // 2, center_c + c_b // 2
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > img_h:
        rmin -= rmax - img_h
        rmax = img_h
    if cmax > img_w:
        cmin -= cmax - img_w
        cmax = img_w
    return max(rmin, 0), rmax, max(cmin, 0), cmax


def bbox_from_mask(mask: np.ndarray, largest_component: bool = True):
    """Tight bbox (rmin, rmax, cmin, cmax) of a binary mask; None for an
    empty mask. With ``largest_component=True`` only the largest connected
    region counts (guards against speckle in predicted masks); with False
    the box spans every True pixel (a ground-truth label whose object an
    occluder splits into islands)."""
    mask = np.asarray(mask).astype(bool)
    if not mask.any():
        return None
    if largest_component:
        labels, n = ndimage.label(mask)
        if n > 1:
            sizes = ndimage.sum(mask, labels, index=np.arange(1, n + 1))
            mask = labels == (1 + int(np.argmax(sizes)))
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return int(rmin), int(rmax) + 1, int(cmin), int(cmax) + 1


def remap_choose_to_resized(choose: np.ndarray, crop_h: int, crop_w: int,
                            out_h: int, out_w: int) -> np.ndarray:
    """Remap flat ``choose`` indices of a (crop_h, crop_w) crop to the
    nearest pixels of the crop resized to (out_h, out_w), under the
    half-pixel convention (ties round half-up)."""
    rows = choose // crop_w
    cols = choose % crop_w
    new_rows = np.clip(np.floor((rows + 0.5) * out_h / crop_h), 0, out_h - 1)
    new_cols = np.clip(np.floor((cols + 0.5) * out_w / crop_w), 0, out_w - 1)
    return (new_rows * out_w + new_cols).astype(choose.dtype)
