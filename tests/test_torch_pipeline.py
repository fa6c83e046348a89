"""Port parity of the whole serving and scoring slice: InferencePipeline
(K=2 refine iterations, with the unrefined hypothesis), pose_distances with
symmetric and asymmetric rows, the numpy metrics, and
PoseEstimator.estimate_frame on a numpy-made RGB-D frame — each against the
JAX package with the same weights (carried by ``densefusion_tpu_torch.compat``)
and the same seed.

Tolerance: atol 1e-4 on poses and distances (float32 through the whole
network and two refine iterations, summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from densefusion_tpu.eval import InferencePipeline as JPipeline
from densefusion_tpu.eval import metrics as jmetrics
from densefusion_tpu.geometry.camera import LINEMOD_CAM as J_CAM
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.serve import PoseEstimator as JEstimator
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.eval import InferencePipeline, metrics
from densefusion_tpu_torch.geometry import LINEMOD_CAM
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
from densefusion_tpu_torch.serve import PoseEstimator

from tests.torch_port_util import (
    NUM_OBJ, EMB, init_params, posenet_inputs, jnp_args, to_np,
)

ATOL = 1e-4
CROP, N = 48, 40


@pytest.fixture(scope="module")
def nets():
    """JAX modules and params (confidence head widened so the argmax over
    hypotheses has a clear margin) and the port's loaded state_dicts."""
    rng = np.random.default_rng(2)
    inputs = posenet_inputs(rng, 4, CROP, N)
    jpose, jref = JPoseNet(num_obj=NUM_OBJ), JRefiner(num_obj=NUM_OBJ)
    p_pose = init_params(jpose, rng, *jnp_args(*inputs), conf_scale=8.0)
    p_ref = init_params(jref, rng, jnp.zeros((1, N, 3)),
                        jnp.zeros((1, N, EMB)), jnp.zeros((1,), jnp.int32))
    return dict(jpose=jpose, jref=jref, p_pose=p_pose, p_ref=p_ref,
                sd_pose=compat.posenet_state_dict_from_flax(p_pose),
                sd_ref=compat.refiner_state_dict_from_flax(p_ref),
                inputs=inputs)


def _port_nets(nets):
    pose, ref = PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ)
    pose.load_state_dict(nets["sd_pose"], strict=True)
    ref.load_state_dict(nets["sd_ref"], strict=True)
    return pose, ref


def _assert_margin(nets, inputs):
    """The chosen hypothesis must not hinge on float noise: the top-2
    confidence gap of every row is ten times the 1e-5 to which
    ``test_torch_models.py`` holds pred_c."""
    c = np.sort(np.asarray(nets["jpose"].apply(
        nets["p_pose"], *jnp_args(*inputs))["pred_c"]), axis=1)
    assert (c[:, -1] - c[:, -2]).min() > 1e-4


def test_inference_pipeline_k2_with_unrefined(nets):
    inputs = nets["inputs"]
    _assert_margin(nets, inputs)
    jpipe = JPipeline(nets["jpose"], nets["jref"], refine_iters=2,
                      return_unrefined=True)
    want = jpipe(nets["p_pose"], nets["p_ref"], *jnp_args(*inputs))
    pipe = InferencePipeline(*_port_nets(nets), refine_iters=2,
                             return_unrefined=True, device="cpu")
    got = pipe(*inputs)
    assert len(got) == 5
    for name, g, w in zip(("q0", "t0", "q", "t", "conf"), got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=ATOL,
                                   err_msg=name)


def test_pose_distances_mixed_symmetry(rng):
    b, m = 6, 50
    model = (0.05 * rng.standard_normal((b, m, 3))).astype(np.float32)
    q = rng.standard_normal((b, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = (rng.standard_normal((b, 3)) * 0.1).astype(np.float32)
    # gt-posed targets: a nearby pose, shuffled so ADD and ADD-S differ
    target = model + (0.01 * rng.standard_normal((b, m, 3))).astype(
        np.float32) + t[:, None]
    target = target[:, rng.permutation(m)]
    sym = np.array([True, False, True, False, False, True])
    want = jmetrics.pose_distances(*jnp_args(model, q, t, target, sym))
    got = metrics.pose_distances(*(torch.from_numpy(a) for a in
                                   (model, q, t, target, sym)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL)
    # the symmetric rows really take ADD-S, not ADD
    add = to_np(metrics.add_distance(
        torch.from_numpy(model), torch.from_numpy(target)))
    assert not np.allclose(to_np(got)[sym], add[sym])


@pytest.mark.parametrize("name", ["adi_distance", "adds_distance",
                                  "add_distance", "translation_error"])
def test_point_metrics(rng, name):
    a = rng.standard_normal((3, 30, 3)).astype(np.float32)
    b = rng.standard_normal((3, 30, 3)).astype(np.float32)
    want = getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def test_numpy_metrics_and_rotation_error(rng):
    d = np.abs(rng.standard_normal(200)) * 0.05
    thr = np.full(200, 0.04)
    assert metrics.vocap_auc(d) == jmetrics.vocap_auc(d)
    assert metrics.accuracy_under_threshold(d) == \
        jmetrics.accuracy_under_threshold(d)
    assert metrics.success_rate(d, thr) == jmetrics.success_rate(d, thr)
    R = np.linalg.qr(rng.standard_normal((2, 5, 3, 3)))[0].astype(np.float32)
    R = R * np.sign(np.linalg.det(R))[..., None, None]
    np.testing.assert_allclose(
        to_np(metrics.rotation_error_deg(torch.from_numpy(R[0]),
                                         torch.from_numpy(R[1]))),
        np.asarray(jmetrics.rotation_error_deg(jnp.asarray(R[0]),
                                               jnp.asarray(R[1]))),
        atol=1e-3)


def _frame(rng):
    """A 480x640 RGB-D frame (depth in mm) with three labelled objects."""
    h, w = 480, 640
    rgb = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    depth = np.zeros((h, w), np.uint16)
    label = np.zeros((h, w), np.uint8)
    for i, (r, c, hh, ww) in enumerate(
            [(100, 120, 60, 50), (250, 300, 45, 70), (300, 500, 70, 66)], 1):
        label[r:r + hh, c:c + ww] = i
        depth[r:r + hh, c:c + ww] = rng.integers(550, 800, size=(hh, ww))
    return rgb, depth, label


def test_pose_estimator_estimate_frame(nets, rng):
    rgb, depth, label = _frame(rng)
    kw = dict(num_points=N, crop_size=CROP, refine_iters=2, seed=0)
    jest = JEstimator(nets["jpose"], nets["jref"], nets["p_pose"],
                      nets["p_ref"], **kw)
    est = PoseEstimator(*_port_nets(nets), nets["sd_pose"], nets["sd_ref"],
                        device="cpu", **kw)
    # host assembly first: both packages crop through their native
    # libraries (one source), so the samples are equal
    for i in (1, 2, 3):
        js = jest.make_sample(rgb, depth, label == i, i - 1, J_CAM, 1e-3)
        ps = est.make_sample(rgb, depth, label == i, i - 1, LINEMOD_CAM, 1e-3)
        np.testing.assert_array_equal(ps.choose, js.choose)
        np.testing.assert_array_equal(ps.points, js.points)
        np.testing.assert_array_equal(ps.img, js.img)
    jest.rng, est.rng = np.random.default_rng(0), np.random.default_rng(0)

    want = jest.estimate_frame(rgb, depth, label, J_CAM, unit_scale=1e-3)
    got = est.estimate_frame(rgb, depth, label, LINEMOD_CAM, unit_scale=1e-3)
    assert set(got) == set(want) == {1, 2, 3}
    for i in want:
        for g, w in zip(got[i], want[i]):
            np.testing.assert_allclose(g, w, atol=ATOL, err_msg=str(i))
