"""Port parity: layers, DilatedResNet, PSPNet (the fused decoder, sparse and
dense; the other decoders are in ``test_torch_decoders.py``), PoseNet and
PoseRefineNet against their flax modules with the same weights, carried by
``densefusion_tpu_torch.compat`` (itself checked key for key against
``densefusion_tpu.compat``).

Tolerance: rtol 1e-4 / atol 1e-5 in float32 — the same arithmetic,
summed in another order by another conv / matmul library.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densefusion_tpu import compat as jcompat
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.models import layers as jlayers
from densefusion_tpu.models.pspnet import PSPNet as JPSPNet
from densefusion_tpu.models.resnet import DilatedResNet as JResNet
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
from densefusion_tpu_torch.models import layers

from tests.torch_port_util import (
    NUM_OBJ, EMB, init_params, posenet_inputs, jnp_args, to_np,
)

TOL = dict(rtol=1e-4, atol=1e-5)
CROP, N, B = 40, 48, 2     # 40 px: a 5x5 trunk map, so PSP sizes 2, 3, 6
                           # take the non-divisible pooling branch


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return to_np(t).transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def pose():
    """JAX PoseNet params (every leaf from the seed) and the port's PoseNet
    loaded with them."""
    rng = np.random.default_rng(1)
    inputs = posenet_inputs(rng, B, CROP, N)
    jm = JPoseNet(num_obj=NUM_OBJ)
    params = init_params(jm, rng, *jnp_args(*inputs))
    model = PoseNet(NUM_OBJ)
    model.load_state_dict(compat.posenet_state_dict_from_flax(params),
                          strict=True)
    return jm, params, model.eval(), inputs


def _same_state_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), want[k], err_msg=k)


def test_compat_matches_jax_export(pose):
    _, params, _, _ = pose
    _same_state_dict(compat.posenet_state_dict_from_flax(params),
                     jcompat.posenet_state_dict_from_params(params))


def test_compat_refiner_matches_jax_export(rng):
    jr = JRefiner(num_obj=NUM_OBJ)
    params = init_params(jr, rng, jnp.zeros((1, 8, 3)),
                         jnp.zeros((1, 8, EMB)), jnp.zeros((1,), jnp.int32))
    _same_state_dict(compat.refiner_state_dict_from_flax(params),
                     jcompat.refiner_state_dict_from_params(params))


@pytest.mark.parametrize("h,w", [(5, 5), (6, 4)])
def test_phase_upsample_conv3x3_replicate(rng, h, w):
    x = rng.standard_normal((2, h, w, 6)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 6, 5)) / 5).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jlayers.phase_upsample_conv3x3(jnp.asarray(x), jnp.asarray(k),
                                          jnp.asarray(b), border="replicate")
    got = layers.phase_upsample_conv3x3(
        _nchw(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b), border="replicate")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw,size", [
    ((6, 6), 3),      # divisible: the JAX package's reshape-mean branch
    ((6, 6), 6),
    ((5, 5), 3),      # non-divisible: its exact-window branch
    ((4, 7), 6),      # output larger than the input on one axis
])
def test_adaptive_avg_pool2d(rng, hw, size):
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    want = jlayers.adaptive_avg_pool2d(jnp.asarray(x), (size, size))
    got = layers.adaptive_avg_pool2d(_nchw(x), size)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("src,out", [
    ((2, 2), (5, 5)),     # upsample
    ((1, 1), (5, 5)),     # the size-1 PSP prior
    ((6, 6), (5, 5)),     # downsample: jax.image.resize antialiases
    ((3, 6), (24, 4)),
])
def test_resize_bilinear_half_pixel(rng, src, out):
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    want = jlayers.resize_bilinear(jnp.asarray(x), out)
    got = layers.resize_bilinear(_nchw(x), out)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_dilated_resnet(pose):
    _, params, model, (img, *_) = pose
    want = JResNet().apply({"params": params["params"]["cnn"]["trunk"]},
                           jnp.asarray(img))
    with torch.no_grad():
        got = model.cnn.model.module.feats(_nchw(img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)


def test_pspnet_sparse_decode(pose):
    """The sparse decode equals the flax module's sparse decode and the
    port's own dense decode gathered at ``choose``."""
    _, params, model, (img, _, choose, _) = pose
    cnn = {"params": params["params"]["cnn"]}
    want = JPSPNet().apply(cnn, jnp.asarray(img),
                           sample_at=jnp.asarray(choose))
    psp = model.cnn.model.module
    with torch.no_grad():
        sparse = psp(torch.from_numpy(img), torch.from_numpy(choose).long())
        dense = psp(torch.from_numpy(img))
    np.testing.assert_allclose(to_np(sparse), np.asarray(want), **TOL)
    dense_at = to_np(dense).reshape(B, CROP * CROP, EMB)[
        np.arange(B)[:, None], choose]
    np.testing.assert_allclose(to_np(sparse), dense_at, **TOL)
    # and the dense map itself matches the flax dense decode
    np.testing.assert_allclose(
        to_np(dense), np.asarray(JPSPNet().apply(cnn, jnp.asarray(img))),
        **TOL)


def test_posenet(pose):
    jm, params, model, inputs = pose
    want = jm.apply(params, *jnp_args(*inputs))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert not got["emb"].requires_grad


def test_pose_refine_net(rng):
    jr = JRefiner(num_obj=NUM_OBJ)
    pts = (0.05 * rng.standard_normal((3, N, 3))).astype(np.float32)
    emb = rng.standard_normal((3, N, EMB)).astype(np.float32)
    obj = np.array([2, 0, 1], np.int32)
    params = init_params(jr, rng, *jnp_args(pts, emb, obj))
    model = PoseRefineNet(NUM_OBJ)
    model.load_state_dict(compat.refiner_state_dict_from_flax(params),
                          strict=True)
    want = jr.apply(params, *jnp_args(pts, emb, obj))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (pts, emb, obj)))
    for k in ("pred_r", "pred_t"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_chip_smoke_param_trees_match_flax(pose):
    """``chip_smoke.py`` builds the JAX package's parameter trees by hand
    (it may not import JAX); they must match flax's, leaf for leaf."""
    import chip_smoke

    _, params, _, _ = pose
    assert chip_smoke.posenet_param_shapes(NUM_OBJ) == \
        jax.tree.map(np.shape, params)
    ref = jax.eval_shape(JRefiner(num_obj=NUM_OBJ).init, jax.random.key(0),
                         jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, EMB)),
                         jnp.zeros((1,), jnp.int32))
    assert chip_smoke.refiner_param_shapes(NUM_OBJ) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
