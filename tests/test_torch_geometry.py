"""Port parity: geometry (quaternions on torch, camera / bbox host helpers)
against ``densefusion_tpu.geometry``. Tolerance: atol 1e-6 in float32 —
the same formulas in the same order, so only last-bit rounding differs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import densefusion_tpu.geometry as jg
from densefusion_tpu.geometry import bbox as jbbox
import densefusion_tpu_torch.geometry as tg

from tests.torch_port_util import to_np


def _quats(rng, n=64):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", [
    "quat_normalize", "quat_to_matrix", "quat_conjugate", "matrix_to_quat",
])
def test_unary_quaternion_ops(rng, name):
    q = rng.standard_normal((64, 4)).astype(np.float32)
    if name == "matrix_to_quat":
        q = np.array(jg.quat_to_matrix(jnp.asarray(_quats(rng))))
    want = getattr(jg, name)(jnp.asarray(q))
    got = getattr(tg, name)(torch.from_numpy(q))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)


def test_quat_multiply_and_rotate(rng):
    q1, q2 = _quats(rng), _quats(rng)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tg.quat_multiply(torch.from_numpy(q1), torch.from_numpy(q2))),
        np.asarray(jg.quat_multiply(jnp.asarray(q1), jnp.asarray(q2))),
        atol=1e-6)
    np.testing.assert_allclose(
        to_np(tg.quat_rotate(torch.from_numpy(q1), torch.from_numpy(v))),
        np.asarray(jg.quat_rotate(jnp.asarray(q1), jnp.asarray(v))),
        atol=1e-6)


def test_pose_compose_invert_apply(rng):
    q1, q2 = _quats(rng, 8), _quats(rng, 8)
    t1, t2 = (rng.standard_normal((2, 8, 3)) * 0.3).astype(np.float32)
    pts = (rng.standard_normal((8, 20, 3)) * 0.1).astype(np.float32)
    T = [torch.from_numpy(a) for a in (q1, t1, q2, t2, pts)]
    J = [jnp.asarray(a) for a in (q1, t1, q2, t2, pts)]
    pairs = [
        (tg.pose_compose(*T[:4]), jg.pose_compose(*J[:4])),
        (tg.invert_pose(T[0], T[1]), jg.invert_pose(J[0], J[1])),
        ((tg.apply_pose(T[4], T[0], T[1]),), (jg.apply_pose(J[4], J[0],
                                                             J[1]),)),
        ((tg.untransform_points(T[4], tg.quat_to_matrix(T[0]), T[1]),),
         (jg.untransform_points(J[4], jg.quat_to_matrix(J[0]), J[1]),)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-6)


def test_bbox_helpers_match(rng):
    """Host bbox ladder, largest-component bbox and choose remap are exact
    copies of the JAX package's numpy helpers."""
    for _ in range(20):
        r0, c0 = rng.integers(0, 400), rng.integers(0, 560)
        box = (int(r0), int(r0 + rng.integers(1, 300)),
               int(c0), int(c0 + rng.integers(1, 300)))
        assert tg.snap_bbox(*box) == jbbox.snap_bbox(*box)
    mask = np.zeros((60, 80), bool)
    mask[5:20, 10:30] = True
    mask[40:45, 60:62] = True           # speckle: the smaller component
    assert tg.bbox_from_mask(mask) == jbbox.bbox_from_mask(mask)
    assert tg.bbox_from_mask(np.zeros((4, 4), bool)) is None
    choose = rng.integers(0, 80 * 120, size=500)
    np.testing.assert_array_equal(
        tg.remap_choose_to_resized(choose, 80, 120, 48, 48),
        jbbox.remap_choose_to_resized(choose, 80, 120, 48, 48))
