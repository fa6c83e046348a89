"""Pinhole camera intrinsics (host-side; counterpart of
``densefusion_tpu/geometry/camera.py``).

Back-projection of a masked depth pixel at ``(row, col)``::

    z = depth / depth_scale
    x = (col - cx) * z / fx
    y = (row - cy) * z / fy
"""

from __future__ import annotations

import dataclasses


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


# Canonical intrinsics of the reference datasets.
YCB_CAM_1 = CameraIntrinsics(fx=1066.778, fy=1067.487, cx=312.9869,
                             cy=241.3109, depth_scale=10000.0)
YCB_CAM_2 = CameraIntrinsics(fx=1077.836, fy=1078.189, cx=323.7872,
                             cy=279.6921, depth_scale=10000.0)
LINEMOD_CAM = CameraIntrinsics(fx=572.41140, fy=573.57043, cx=325.26110,
                               cy=242.04899, depth_scale=1.0)
