"""Pinhole camera intrinsics and depth back-projection (counterpart of
``densefusion_tpu/geometry/camera.py``).

Back-projection of a masked depth pixel at ``(row, col)``::

    z = depth / depth_scale
    x = (col - cx) * z / fx
    y = (row - cy) * z / fy
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics. ``depth_scale`` converts stored depth units to the
    working metric unit (10000 for YCB's ``factor_depth``; LineMOD uses 1.0
    then /1000 to meters)."""

    fx: float
    fy: float
    cx: float
    cy: float
    depth_scale: float = 1.0

    def as_tensor(self, device=None) -> torch.Tensor:
        """``[fx, fy, cx, cy, depth_scale]`` as float32, the ``cam``
        argument of :func:`backproject_pixels`."""
        return torch.tensor([self.fx, self.fy, self.cx, self.cy,
                             self.depth_scale], dtype=torch.float32,
                            device=device)


# Canonical intrinsics of the reference datasets.
YCB_CAM_1 = CameraIntrinsics(fx=1066.778, fy=1067.487, cx=312.9869,
                             cy=241.3109, depth_scale=10000.0)
YCB_CAM_2 = CameraIntrinsics(fx=1077.836, fy=1078.189, cx=323.7872,
                             cy=279.6921, depth_scale=10000.0)
LINEMOD_CAM = CameraIntrinsics(fx=572.41140, fy=573.57043, cx=325.26110,
                               cy=242.04899, depth_scale=1.0)


def backproject_pixels(depth: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, cam: torch.Tensor,
                       unit_scale: float = 1.0) -> torch.Tensor:
    """Back-project selected pixels to 3D points.

    ``depth``, ``rows``, ``cols``: (..., N) raw depth values and pixel
    coordinates; ``cam``: (..., 5) ``[fx, fy, cx, cy, depth_scale]``
    (:meth:`CameraIntrinsics.as_tensor`), per sample so mixed-intrinsics
    batches work; ``unit_scale``: a last metric conversion (1/1000 for
    LineMOD's mm). Returns the (..., N, 3) cloud in the camera frame, x
    right, y down, z forward.
    """
    fx, fy = cam[..., 0:1], cam[..., 1:2]
    cx, cy = cam[..., 2:3], cam[..., 3:4]
    dscale = cam[..., 4:5]
    z = depth.to(torch.float32) / dscale
    x = (cols.to(torch.float32) - cx) * z / fx
    y = (rows.to(torch.float32) - cy) * z / fy
    return torch.stack([x, y, z], dim=-1) * unit_scale


def backproject_depth_map(depth: torch.Tensor, cam: torch.Tensor,
                          unit_scale: float = 1.0) -> torch.Tensor:
    """Back-project a full (H, W) depth map to an (H, W, 3) cloud."""
    h, w = depth.shape[-2], depth.shape[-1]
    rows = torch.arange(h, dtype=torch.float32,
                        device=depth.device)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32,
                        device=depth.device)[None, :].expand(h, w)
    return backproject_pixels(depth, rows, cols, cam, unit_scale)
