"""Geometry: quaternion math and depth back-projection (torch), camera
intrinsics and the bbox ladder (host-side numpy)."""

from densefusion_tpu_torch.geometry.quaternion import (
    quat_normalize,
    quat_to_matrix,
    matrix_to_quat,
    quat_multiply,
    quat_conjugate,
    quat_rotate,
    pose_compose,
    invert_pose,
    apply_pose,
    transform_points,
    untransform_points,
    quat_from_euler,
    euler_matrix,
    random_quaternion,
)
from densefusion_tpu_torch.geometry.camera import (
    CameraIntrinsics, YCB_CAM_1, YCB_CAM_2, LINEMOD_CAM,
    backproject_pixels, backproject_depth_map,
)
from densefusion_tpu_torch.geometry.bbox import (
    BORDER_LADDER, snap_bbox, bbox_from_mask, remap_choose_to_resized,
)

__all__ = [
    "quat_normalize", "quat_to_matrix", "matrix_to_quat", "quat_multiply",
    "quat_conjugate", "quat_rotate", "pose_compose", "invert_pose",
    "apply_pose", "transform_points", "untransform_points",
    "quat_from_euler", "euler_matrix", "random_quaternion",
    "CameraIntrinsics", "YCB_CAM_1", "YCB_CAM_2", "LINEMOD_CAM",
    "backproject_pixels", "backproject_depth_map",
    "BORDER_LADDER", "snap_bbox", "bbox_from_mask", "remap_choose_to_resized",
]
