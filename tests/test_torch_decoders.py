"""Port parity of the zero-border dense decoder (``fused_decoder=False``) and
the reference-exact decoder (``align_corners=True``): their resize and
sparse-tap helpers, PSPNet dense and sparse, PoseNet and the whole serving
slice (``InferencePipeline``, K=2, and ``PoseEstimator.estimate_frame``),
each against the JAX package with the same weights, carried by
``densefusion_tpu_torch.compat``.

Tolerance: rtol 1e-4 / atol 1e-5 for layers and networks in float32, as in
``test_torch_models.py``; atol 1e-4 for poses after two refine iterations,
as in ``test_torch_pipeline.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densefusion_tpu.eval import InferencePipeline as JPipeline
from densefusion_tpu.geometry.camera import LINEMOD_CAM as J_CAM
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.models import layers as jlayers
from densefusion_tpu.models import pspnet as jpspnet
from densefusion_tpu.serve import PoseEstimator as JEstimator
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.eval import InferencePipeline
from densefusion_tpu_torch.geometry import LINEMOD_CAM
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
from densefusion_tpu_torch.models import layers, pspnet
from densefusion_tpu_torch.serve import PoseEstimator

from tests.torch_port_util import (
    NUM_OBJ, EMB, init_params, posenet_inputs, jnp_args, to_np,
)

TOL = dict(rtol=1e-4, atol=1e-5)
POSE_ATOL = 1e-4
CROP, N, B = 40, 48, 2      # test_torch_models.py's size

DECODERS = {"dense": dict(fused_decoder=False),
            "align": dict(align_corners=True)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("src,out", [
    ((5, 5), (10, 10)),   # the decoder's 2x
    ((3, 6), (6, 12)),
    ((1, 4), (2, 8)),     # a size-1 axis maps to source 0
    ((4, 4), (4, 4)),     # same size: the identity
])
def test_resize_bilinear_align_corners(rng, src, out):
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    want = jlayers.resize_bilinear(jnp.asarray(x), out, align_corners=True)
    got = layers.resize_bilinear(_nchw(x), out, align_corners=True)
    np.testing.assert_allclose(to_np(got).transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)


def _taps_inputs(rng, h, w, n=40):
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    rows = rng.integers(0, 2 * h, (2, n)).astype(np.int32)
    cols = rng.integers(0, 2 * w, (2, n)).astype(np.int32)
    # every border pixel class: the four corners and edge midpoints
    rows[:, :4], cols[:, :4] = [0, 0, 2 * h - 1, 2 * h - 1], \
        [0, 2 * w - 1, 0, 2 * w - 1]
    rows[:, 4:6], cols[:, 4:6] = [0, h], [w, 2 * w - 1]
    return x, rows, cols


@pytest.mark.parametrize("border", ["zero", "replicate"])
@pytest.mark.parametrize("hw", [(5, 5), (4, 7)], ids=str)
def test_sparse_upsample_taps(rng, hw, border):
    x, rows, cols = _taps_inputs(rng, *hw)
    want = jpspnet.sparse_upsample_taps(*jnp_args(x, rows, cols),
                                        border=border)
    got = pspnet.sparse_upsample_taps(
        _nchw(x), torch.from_numpy(rows).long(),
        torch.from_numpy(cols).long(), border=border)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [(5, 5), (4, 7), (3, 12)], ids=str)
def test_sparse_upsample_taps_align(rng, hw):
    x, rows, cols = _taps_inputs(rng, *hw)
    want = jpspnet.sparse_upsample_taps_align(*jnp_args(x, rows, cols))
    got = pspnet.sparse_upsample_taps_align(
        _nchw(x), torch.from_numpy(rows).long(),
        torch.from_numpy(cols).long())
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused,border", [(False, "replicate"),
                                          (False, "zero"),
                                          (True, "zero")])
def test_psp_upsample_modes(rng, fused, border):
    """The stage module's dense (edge or zero padded) and fused zero-border
    modes against the flax module on the same parameters."""
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 8, 4)) / 8).astype(np.float32)
    b = (0.05 * rng.standard_normal(4)).astype(np.float32)
    jm = jpspnet.PSPUpsample(4, fused=fused, border=border)
    params = {"params": {"conv": {"kernel": jnp.asarray(k),
                                  "bias": jnp.asarray(b)},
                         "prelu": {"slope": jnp.asarray(0.2)}}}
    want = jm.apply(params, jnp.asarray(x))
    m = pspnet.PSPUpsample(8, 4, fused=fused, border=border)
    with torch.no_grad():
        m.conv[1].weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        m.conv[1].bias.copy_(torch.from_numpy(b))
        m.conv[2].weight.fill_(0.2)
        got = m(_nchw(x))
    np.testing.assert_allclose(to_np(got).transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def pose():
    """JAX PoseNet params from the seed (one tree serves every decoder) and
    the port's state_dict of them."""
    rng = np.random.default_rng(1)
    inputs = posenet_inputs(rng, B, CROP, N)
    params = init_params(JPoseNet(num_obj=NUM_OBJ), rng, *jnp_args(*inputs))
    return params, compat.posenet_state_dict_from_flax(params), inputs


def _port_posenet(state_dict, **decoder):
    model = PoseNet(NUM_OBJ, **decoder)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def test_every_decoder_reads_the_same_state_dict(pose):
    keys = {name: set(PoseNet(NUM_OBJ, **kw).state_dict())
            for name, kw in {"fused": {}, **DECODERS}.items()}
    assert keys["dense"] == keys["fused"] == keys["align"] == set(pose[1])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_pspnet(pose, decoder, sparse):
    params, sd, (img, _, choose, _) = pose
    kw = DECODERS[decoder]
    cnn = {"params": params["params"]["cnn"]}
    sample = jnp.asarray(choose) if sparse else None
    want = jpspnet.PSPNet(**kw).apply(cnn, jnp.asarray(img),
                                      sample_at=sample)
    psp = _port_posenet(sd, **kw).cnn.model.module
    with torch.no_grad():
        got = psp(torch.from_numpy(img),
                  torch.from_numpy(choose).long() if sparse else None)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_sparse_decode_equals_dense_gathered(pose, decoder):
    _, sd, (img, _, choose, _) = pose
    psp = _port_posenet(sd, **DECODERS[decoder]).cnn.model.module
    with torch.no_grad():
        sparse = psp(torch.from_numpy(img), torch.from_numpy(choose).long())
        dense = psp(torch.from_numpy(img))
    dense_at = to_np(dense).reshape(B, CROP * CROP, EMB)[
        np.arange(B)[:, None], choose]
    np.testing.assert_allclose(to_np(sparse), dense_at, **TOL)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_posenet(pose, decoder):
    params, sd, inputs = pose
    kw = DECODERS[decoder]
    want = JPoseNet(num_obj=NUM_OBJ, **kw).apply(params, *jnp_args(*inputs))
    with torch.no_grad():
        got = _port_posenet(sd, **kw)(*(torch.from_numpy(a) for a in inputs))
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)


@pytest.fixture(scope="module")
def nets():
    """As ``test_torch_pipeline.py``: the confidence head widened so the
    argmax over hypotheses has a clear margin under every decoder."""
    rng = np.random.default_rng(2)
    inputs = posenet_inputs(rng, 4, CROP, N)
    p_pose = init_params(JPoseNet(num_obj=NUM_OBJ), rng, *jnp_args(*inputs),
                         conf_scale=8.0)
    p_ref = init_params(JRefiner(num_obj=NUM_OBJ), rng,
                        jnp.zeros((1, N, 3)), jnp.zeros((1, N, EMB)),
                        jnp.zeros((1,), jnp.int32))
    return p_pose, p_ref, inputs


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_inference_pipeline_k2(nets, decoder):
    """The whole slice under each new decoder: PoseNet, argmax confidence
    and two refine iterations, against the JAX pipeline."""
    p_pose, p_ref, inputs = nets
    kw = DECODERS[decoder]
    jpose = JPoseNet(num_obj=NUM_OBJ, **kw)
    c = np.sort(np.asarray(jpose.apply(p_pose, *jnp_args(*inputs))
                           ["pred_c"]), axis=1)
    assert (c[:, -1] - c[:, -2]).min() > 1e-4   # no near-tie to flip
    want = JPipeline(jpose, JRefiner(num_obj=NUM_OBJ), refine_iters=2)(
        p_pose, p_ref, *jnp_args(*inputs))
    ref = PoseRefineNet(NUM_OBJ)
    ref.load_state_dict(compat.refiner_state_dict_from_flax(p_ref),
                        strict=True)
    pipe = InferencePipeline(
        _port_posenet(compat.posenet_state_dict_from_flax(p_pose), **kw),
        ref, refine_iters=2, device="cpu")
    got = pipe(*inputs)
    for name, g, w in zip(("q", "t", "conf"), got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=POSE_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_pose_estimator_estimate_frame(nets, decoder):
    """``PoseEstimator`` over each new decoder on a 480x640 RGB-D frame with
    two labelled objects (depth in mm), against the JAX estimator."""
    p_pose, p_ref, _ = nets
    kw = DECODERS[decoder]
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, size=(480, 640, 3)).astype(np.uint8)
    depth = np.zeros((480, 640), np.uint16)
    label = np.zeros((480, 640), np.uint8)
    for i, (r, c, hh, ww) in enumerate([(100, 120, 60, 50),
                                        (250, 300, 45, 70)], 1):
        label[r:r + hh, c:c + ww] = i
        depth[r:r + hh, c:c + ww] = rng.integers(550, 800, size=(hh, ww))
    est_kw = dict(num_points=N, crop_size=CROP, refine_iters=2, seed=0)
    jest = JEstimator(JPoseNet(num_obj=NUM_OBJ, **kw),
                      JRefiner(num_obj=NUM_OBJ), p_pose, p_ref, **est_kw)
    ref = PoseRefineNet(NUM_OBJ)
    est = PoseEstimator(PoseNet(NUM_OBJ, **kw), ref,
                        compat.posenet_state_dict_from_flax(p_pose),
                        compat.refiner_state_dict_from_flax(p_ref),
                        device="cpu", **est_kw)
    want = jest.estimate_frame(rgb, depth, label, J_CAM, unit_scale=1e-3)
    got = est.estimate_frame(rgb, depth, label, LINEMOD_CAM, unit_scale=1e-3)
    assert set(got) == set(want) == {1, 2}
    for i in want:
        for g, w in zip(got[i], want[i]):
            np.testing.assert_allclose(g, w, atol=POSE_ATOL, err_msg=str(i))
