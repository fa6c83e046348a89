"""Port parity of the model options: the resnet34-152 trunks, the
space-to-depth stem, ``sparse_emb=False`` and ``remat_cnn``, against the
JAX package on the CPU with the same weights (carried by
``densefusion_tpu_torch.compat``, whose maps now cover every trunk).

Tolerance: rtol 1e-4 / atol 1e-5 in float32, as ``test_torch_models.py``
(the same arithmetic summed in another order); resnet101 and 152, whose
100-odd convolutions grow that order's noise on elements near zero,
within 1e-5 of the largest element; the space-to-depth stem
against the plain one at 1e-4, the JAX package's own bound
(``tests/test_models.py:62-79``). ``remat_cnn`` only reschedules the
backward pass, so a train-mode step with it equals the plain step bit for
bit, dropout masks included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densefusion_tpu import compat as jcompat
from densefusion_tpu.losses import pose_loss as j_pose_loss
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models.pspnet import PSPNet as JPSPNet
from densefusion_tpu.models.resnet import DilatedResNet as JResNet
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.losses import pose_loss
from densefusion_tpu_torch.models import PoseNet, PSPNet
from densefusion_tpu_torch.models.resnet import DilatedResNet, RESNET_SPECS
from densefusion_tpu_torch.train import make_optimizer

from tests.torch_port_util import (
    NUM_OBJ, fill_params, init_params, jnp_args, posenet_inputs, to_np,
)

TOL = dict(rtol=1e-4, atol=1e-5)
B, CROP, N = 2, 32, 24
W = 0.015


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return to_np(t).transpose(0, 2, 3, 1)


def _trunk(variant, rng, hw=32, **kw):
    """(JAX trunk params, the port's trunk loaded with them, input)."""
    x = rng.standard_normal((1, hw, hw, 3)).astype(np.float32)
    params = fill_params(jax.eval_shape(JResNet(variant=variant).init,
                                        jax.random.key(0), jnp.asarray(x)),
                         rng)
    state = compat._export({"params": {"trunk": params["params"]}},
                           compat._trunk_map("", variant))
    model = DilatedResNet(variant, **kw)
    model.load_state_dict(state, strict=True)
    return params, model.eval(), x


@pytest.mark.parametrize("variant", ["resnet34", "resnet50"])
def test_trunk_matches_jax(variant):
    params, model, x = _trunk(variant, np.random.default_rng(0))
    want = JResNet(variant=variant).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(_nchw(x))
    assert model.out_features == want[0].shape[-1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("variant,blocks", [("resnet101", (3, 4, 23, 3)),
                                            ("resnet152", (3, 8, 36, 3))])
def test_deep_trunks(variant, blocks):
    """resnet101 / 152 at 32x32: the reference's block counts, its
    state_dict keys (a Bottleneck's conv1..3, the first block's
    ``downsample.0``), the (stage 4, stage 3) shapes at stride 8, and one
    forward against JAX."""
    params, model, x = _trunk(variant, np.random.default_rng(1))
    assert RESNET_SPECS[variant][1] == blocks
    keys = set(model.state_dict())
    assert {f"layer{s}.{b}.conv3.weight" for s in range(1, 5)
            for b in range(blocks[s - 1])} <= keys
    assert {k for k in keys if "downsample" in k} == {
        f"layer{s}.0.downsample.0.weight" for s in range(1, 5)}
    want = JResNet(variant=variant).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(_nchw(x))
    assert got[0].shape == (1, 2048, 4, 4) and got[1].shape == (1, 1024, 4, 4)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(_nhwc(g) - w).max() <= 1e-5 * np.abs(w).max()


def test_pspnet_resnet50_matches_jax():
    """PSPNet on the resnet50 trunk: its PSP module reads the 2048-wide
    stage 4 (``PSPModule`` infers it in JAX); dense and sparse decodes."""
    rng = np.random.default_rng(2)
    img = rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32)
    choose = rng.integers(0, CROP * CROP, (B, N)).astype(np.int32)
    jm = JPSPNet(variant="resnet50")
    params = fill_params(jax.eval_shape(jm.init, jax.random.key(0),
                                        jnp.asarray(img)), rng)
    state = compat._export({"params": {"cnn": params["params"]}},
                           compat._pspnet_map("", "resnet50"))
    model = PSPNet("resnet50")
    model.load_state_dict(state, strict=True)
    assert model.psp.stages[0][1].weight.shape == (2048, 2048, 1, 1)
    with torch.no_grad():
        dense = model.eval()(torch.from_numpy(img))
        sparse = model(torch.from_numpy(img), torch.from_numpy(choose).long())
    np.testing.assert_allclose(to_np(dense), np.asarray(
        jm.apply(params, jnp.asarray(img))), **TOL)
    np.testing.assert_allclose(to_np(sparse), np.asarray(
        jm.apply(params, jnp.asarray(img), sample_at=jnp.asarray(choose))),
        **TOL)


def test_compat_round_trip_resnet50():
    """flax -> torch -> flax is exact for a resnet50 PoseNet, the torch
    names equal the JAX package's export, and Adam's moments go to optax's
    tree and back under the same map."""
    rng = np.random.default_rng(3)
    inputs = posenet_inputs(rng, 1, CROP, N)
    params = init_params(JPoseNet(num_obj=NUM_OBJ, cnn_variant="resnet50"),
                         rng, *jnp_args(*inputs))
    state = compat.posenet_state_dict_from_flax(params, "resnet50")
    want = jcompat.posenet_state_dict_from_params(params, "resnet50")
    assert set(state) == set(want)
    net = PoseNet(NUM_OBJ, cnn_variant="resnet50")
    net.load_state_dict(state, strict=True)
    back = compat.posenet_params_from_state_dict(net.state_dict(),
                                                 "resnet50")
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    opt = make_optimizer(net.parameters(), 1e-3)
    for i, p in enumerate(net.parameters()):
        p.grad = torch.full_like(p, 0.001 * (i + 1))
    opt.step()
    tree = compat.adam_to_optax(opt, net, "pose")
    fresh = make_optimizer(net.parameters(), 1e-3)
    compat.adam_from_optax(fresh, net, "pose", tree)
    for p in net.parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.state[p][k], opt.state[p][k])


def test_s2d_stem():
    """The space-to-depth stem against the JAX one and against the plain
    stem, from the same state_dict."""
    rng = np.random.default_rng(4)
    params, plain, x = _trunk("resnet18", rng, hw=48)
    s2d = DilatedResNet("resnet18", s2d_stem=True)
    s2d.load_state_dict(plain.state_dict(), strict=True)
    want = JResNet(variant="resnet18", s2d_stem=True).apply(params,
                                                            jnp.asarray(x))
    with torch.no_grad():
        got = s2d.eval()(_nchw(x))
        ref = plain(_nchw(x))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(to_np(g), to_np(r), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pose():
    """Seeded inputs, JAX PoseNet params and the port's PoseNet states."""
    rng = np.random.default_rng(5)
    inputs = posenet_inputs(rng, B, CROP, N)
    params = init_params(JPoseNet(num_obj=NUM_OBJ), rng, *jnp_args(*inputs),
                         conf_scale=8.0)
    return inputs, params, compat.posenet_state_dict_from_flax(params)


def test_sparse_emb_false(pose):
    """``sparse_emb=False`` (the whole embedding map, gathered at
    ``choose``) against JAX's and against the port's sparse decode."""
    inputs, params, state = pose
    want = JPoseNet(num_obj=NUM_OBJ, sparse_emb=False).apply(
        params, *jnp_args(*inputs))
    outs = {}
    for sparse in (False, True):
        net = PoseNet(NUM_OBJ, sparse_emb=sparse)
        net.load_state_dict(state, strict=True)
        with torch.no_grad():
            outs[sparse] = net.eval()(*(torch.from_numpy(a)
                                        for a in inputs))
    for k in want:
        np.testing.assert_allclose(to_np(outs[False][k]),
                                   np.asarray(want[k]), err_msg=k, **TOL)
        np.testing.assert_allclose(to_np(outs[False][k]),
                                   to_np(outs[True][k]), err_msg=k, **TOL)


def _loss(out, inputs, target, model_points, sym):
    pts = torch.from_numpy(inputs[1])
    return pose_loss(out["pred_r"], out["pred_t"], out["pred_c"],
                     target, model_points, pts, sym, W, use_adds=True,
                     pred_c_logit=out["pred_c_logit"]).loss


def _targets(inputs):
    rng = np.random.default_rng(6)
    model = torch.from_numpy(rng.uniform(-0.05, 0.05, (B, 30, 3))
                             .astype(np.float32))
    target = model + torch.tensor([0.0, 0.0, 0.6])
    return target, model, torch.tensor([True, False])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_remat_cnn_train_step_bit_exact(pose, dtype):
    """A train-mode phase-1 loss and backward with ``remat_cnn`` equals the
    plain one bit for bit, loss and every gradient, on the same seeded
    dropout generator, which both leave in the same state; the CNN runs
    twice (the recomputation) instead of once."""
    inputs, _, state = pose
    target, model, sym = _targets(inputs)
    runs = {}
    for remat in (False, True):
        net = PoseNet(NUM_OBJ, dtype=dtype, remat_cnn=remat)
        net.load_state_dict(state, strict=True)
        calls = []
        net.cnn.model.module.register_forward_pre_hook(
            lambda *_: calls.append(1))
        gen = torch.Generator().manual_seed(9)
        out = net.train()(*(torch.from_numpy(a) for a in inputs),
                          generator=gen)
        loss = _loss(out, inputs, target, model, sym)
        loss.backward()
        runs[remat] = (loss.detach(), {k: p.grad for k, p in
                                       net.named_parameters()},
                       gen.get_state(), len(calls))
    (l0, g0, s0, c0), (l1, g1, s1, c1) = runs[False], runs[True]
    assert (c0, c1) == (1, 2)
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert set(g0) == set(g1)
    for k in g0:
        assert g0[k] is not None and torch.equal(g0[k], g1[k]), k


def test_remat_cnn_matches_jax(pose):
    """The phase-1 loss and gradient with ``remat_cnn`` against JAX's
    ``remat_cnn=True`` (dropout off, as ``test_torch_train.py`` compares
    the plain step): loss to rtol 1e-5, every gradient within 1e-4 of its
    largest element."""
    inputs, params, state = pose
    target, model, sym = _targets(inputs)
    jm = JPoseNet(num_obj=NUM_OBJ, remat_cnn=True)

    def loss_fn(p):
        out = jm.apply(p, *jnp_args(*inputs), train=False)
        return j_pose_loss(out["pred_r"], out["pred_t"], out["pred_c"],
                           jnp.asarray(target.numpy()),
                           jnp.asarray(model.numpy()),
                           jnp.asarray(inputs[1]), jnp.asarray(sym.numpy()),
                           W, use_adds=True,
                           pred_c_logit=out["pred_c_logit"]).loss

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = compat.posenet_state_dict_from_flax(jax.tree.map(np.array, jgrads))
    net = PoseNet(NUM_OBJ, remat_cnn=True)
    net.load_state_dict(state, strict=True)
    out = net.eval()(*(torch.from_numpy(a) for a in inputs))
    loss = _loss(out, inputs, target, model, sym)
    loss.backward()
    np.testing.assert_allclose(to_np(loss), np.asarray(want_loss), rtol=1e-5)
    for k, p in net.named_parameters():
        w = want[k].numpy()
        assert np.abs(to_np(p.grad) - w).max() <= 1e-4 * np.abs(w).max(), k
