"""Quaternion / rotation math on torch tensors.

Counterpart of ``densefusion_tpu/geometry/quaternion.py`` with the same
conventions:

* quaternions are ``(w, x, y, z)``, scalar first;
* points are row vectors and a pose ``(q, t)`` maps ``p`` to
  ``R(q) @ p + t``, evaluated in batch as ``points @ R.T + t``;
* ``untransform_points`` is the canonicalization ``(points - t) @ R``.

All functions broadcast over leading batch dimensions, but
``unit_quat_matrix_np``: the host-side numpy rotation that the readers, the
generators and the YCB scorer share.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) (..., 4) to unit norm."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz),       2.0 * (wy + xz),
            2.0 * (xy + wz),       1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy),       2.0 * (wx + yz),       1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def unit_quat_matrix_np(w: float, x: float, y: float, z: float
                        ) -> np.ndarray:
    """The 3x3 rotation of a unit quaternion's components, numpy: each
    caller normalizes the quaternion in its JAX counterpart's order, so its
    outputs stay bit-equal to the JAX ones (``test_torch_cad.py``,
    ``test_torch_ycb_toolbox.py``, ``test_torch_data.py``)."""
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (w * y + x * z)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (w * x + y * z), 1 - 2 * (x * x + y * y)],
    ])


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz, w >= 0
    (branchless Shepperd: the best-conditioned of four candidates)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                         dim=-1)
    case = pivots.argmax(dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)   # (..., 4 cases, 4 comps)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product: R(quat_multiply(q1, q2)) == R(q1) @ R(q2)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, -x, -y, -z): the vector part negated on the device, with no
    host table to copy (the values of ``q * [1, -1, -1, -1]``)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4) without the
    matrix: v' = v + w*t + cross(q_vec, t), t = 2*cross(q_vec, v)."""
    qv, w = q[..., 1:], q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_from_euler(ai, aj, ak) -> torch.Tensor:
    """'sxyz' Euler angles -> quaternion(s) wxyz."""
    ai, aj, ak = (torch.as_tensor(a, dtype=torch.float32) / 2.0
                  for a in (ai, aj, ak))
    ci, si = torch.cos(ai), torch.sin(ai)
    cj, sj = torch.cos(aj), torch.sin(aj)
    ck, sk = torch.cos(ak), torch.sin(ak)
    return torch.stack(
        [
            ci * cj * ck + si * sj * sk,
            si * cj * ck - ci * sj * sk,
            ci * sj * ck + si * cj * sk,
            ci * cj * sk - si * sj * ck,
        ],
        dim=-1,
    )


def euler_matrix(ai, aj, ak) -> torch.Tensor:
    """'sxyz' Euler angles -> 3x3 rotation(s)."""
    return quat_to_matrix(quat_from_euler(ai, aj, ak))


def random_quaternion(generator: torch.Generator | None = None,
                      shape=()) -> torch.Tensor:
    """Uniform random unit quaternion(s) wxyz of ``shape``, drawn from
    ``generator`` (on its device)."""
    device = generator.device if generator is not None else None
    u1, u2, u3 = torch.rand((3, *shape), generator=generator, device=device)
    u2, u3 = u2 * (2.0 * torch.pi), u3 * (2.0 * torch.pi)
    a, b = torch.sqrt(1.0 - u1), torch.sqrt(u1)
    return torch.stack(
        [b * torch.cos(u3), a * torch.sin(u2), a * torch.cos(u2),
         b * torch.sin(u3)],
        dim=-1,
    )


def pose_compose(q1, t1, q2, t2):
    """(q1,t1) o (q2,t2): p -> R1 (R2 p + t2) + t1 (the refinement
    composition ``T <- T @ T2``)."""
    return quat_multiply(q1, q2), quat_rotate(q1, t2) + t1


def invert_pose(q: torch.Tensor, t: torch.Tensor):
    qc = quat_conjugate(q)
    return qc, -quat_rotate(qc, t)


def apply_pose(points: torch.Tensor, q: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """points (..., N, 3) -> R(q) @ p + t per point."""
    return transform_points(points, quat_to_matrix(q), t)


def transform_points(points: torch.Tensor, R: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """points @ R.T + t (forward rigid transform, row vectors)."""
    return points @ R.transpose(-1, -2) + t[..., None, :]


def untransform_points(points: torch.Tensor, R: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """(points - t) @ R: re-express a cloud in the pose's frame."""
    return (points - t[..., None, :]) @ R
