"""Port parity: the training path against the JAX package.

* a phase-1 loss and its gradient (dropout off: the two frameworks' dropout
  masks cannot match), against ``jax.value_and_grad`` of the same loss with
  ``train=False``; the JAX gradient tree is carried to torch names by
  ``compat.posenet_state_dict_from_flax``. Loss to rtol 1e-5; every
  parameter's gradient to ``max|diff| <= 1e-4 * max|grad|`` (the same
  float32 arithmetic summed in another order; measured about 3e-6);
* one and two Adam updates against ``optax.adam`` from the same gradients;
* a phase-2 step against the JAX ``make_refine_train_step`` itself (it is
  deterministic), and the eval step against ``make_eval_step``;
* ``Dropout2d``, the initializers, the batch helper and the step wiring.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from densefusion_tpu.data import PoseSample as JPoseSample
from densefusion_tpu.losses import pose_loss as j_pose_loss
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.train.state import TrainState as JTrainState
from densefusion_tpu.train.state import Curriculum as JCurriculum
from densefusion_tpu.train.state import make_optimizer as j_make_optimizer
from densefusion_tpu.train.steps import (
    make_eval_step as j_make_eval_step,
    make_refine_train_step as j_make_refine_train_step,
)
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.data import PoseSample, to_device
from densefusion_tpu_torch.losses import pose_loss
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
from densefusion_tpu_torch.models.layers import Dropout2d
from densefusion_tpu_torch.models.init import init_posenet_, init_refiner_
from densefusion_tpu_torch.train import (
    Curriculum, TrainState, create_train_state, make_eval_step,
    make_optimizer, make_pose_train_step, make_refine_train_step,
)

from tests.torch_port_util import NUM_OBJ, EMB, init_params, to_np

B, CROP, N, M = 3, 32, 40, 30
W = 0.015
LR = 1e-3


def _batch(rng) -> PoseSample:
    """Three samples of one scene scale: row 0 symmetric, row 2 invalid."""
    model = rng.uniform(-0.05, 0.05, (B, M, 3))
    target = model + np.array([0.0, 0.0, 0.6]) \
        + 0.01 * rng.standard_normal((B, 1, 3))
    points = np.concatenate([target, target], axis=1)[:, :N] \
        + 0.005 * rng.standard_normal((B, N, 3))
    return PoseSample(
        points=points.astype(np.float32),
        choose=rng.integers(0, CROP * CROP, (B, N)).astype(np.int32),
        img=rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32),
        target=target.astype(np.float32),
        model_points=model.astype(np.float32),
        obj_idx=np.array([2, 0, 1], np.int32),
        sym=np.array([True, False, False]),
        valid=np.array([True, True, False]))


@pytest.fixture(scope="module")
def setup():
    """The batch, JAX params for both networks (every leaf from the seed,
    confidences widened so the argmax hypothesis is clear), and the port's
    networks loaded with them."""
    rng = np.random.default_rng(4)
    batch = _batch(rng)
    args = (jnp.asarray(batch.img), jnp.asarray(batch.points),
            jnp.asarray(batch.choose), jnp.asarray(batch.obj_idx))
    jpose, jref = JPoseNet(num_obj=NUM_OBJ), JRefiner(num_obj=NUM_OBJ)
    p_pose = init_params(jpose, rng, *args, conf_scale=8.0)
    p_ref = init_params(jref, rng, args[1], jnp.zeros((B, N, EMB)), args[3])
    return batch, jpose, jref, p_pose, p_ref


def _port_state(setup, lr=LR) -> TrainState:
    batch, _, _, p_pose, p_ref = setup
    pose, ref = PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ)
    pose.load_state_dict(compat.posenet_state_dict_from_flax(p_pose))
    ref.load_state_dict(compat.refiner_state_dict_from_flax(p_ref))
    return TrainState(step=0, posenet=pose, refiner=ref,
                      optimizer=make_optimizer(pose.parameters(), lr),
                      generator=torch.Generator().manual_seed(0))


def _assert_grads_close(named_grads, want: dict, rel: float):
    assert set(named_grads) == set(want)
    for k, g in named_grads.items():
        w = want[k].numpy()
        err = np.abs(to_np(g) - w).max()
        assert err <= rel * np.abs(w).max(), (k, err, np.abs(w).max())


def test_phase1_loss_and_grads_match_jax(setup):
    batch, jpose, _, p_pose, _ = setup

    def loss_fn(params):
        out = jpose.apply(params, jnp.asarray(batch.img),
                          jnp.asarray(batch.points),
                          jnp.asarray(batch.choose),
                          jnp.asarray(batch.obj_idx), train=False)
        return j_pose_loss(out["pred_r"], out["pred_t"], out["pred_c"],
                           jnp.asarray(batch.target),
                           jnp.asarray(batch.model_points),
                           jnp.asarray(batch.points), jnp.asarray(batch.sym),
                           W, use_adds=True,
                           sample_weight=jnp.asarray(batch.valid,
                                                     jnp.float32),
                           pred_c_logit=out["pred_c_logit"]).loss

    want_loss, jgrads = jax.value_and_grad(loss_fn)(p_pose)
    want = compat.posenet_state_dict_from_flax(
        jax.tree.map(np.array, jgrads))

    state = _port_state(setup)
    b = to_device(batch, "cpu")
    out = state.posenet.eval()(b.img, b.points, b.choose, b.obj_idx)
    lo = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"], b.target,
                   b.model_points, b.points, b.sym, W, use_adds=True,
                   sample_weight=b.valid, pred_c_logit=out["pred_c_logit"])
    lo.loss.backward()
    np.testing.assert_allclose(to_np(lo.loss), np.asarray(want_loss),
                               rtol=1e-5)
    _assert_grads_close({k: p.grad for k, p in
                         state.posenet.named_parameters()}, want, 1e-4)


@pytest.mark.parametrize("steps", [1, 2])
def test_adam_matches_optax(rng, steps):
    """torch Adam (``make_optimizer``) against ``optax.adam`` with the
    JAX package's settings, on the same gradients: params to rtol 1e-6 /
    atol 1e-9 after each update."""
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32)
             for _ in range(steps)]
    tx = j_make_optimizer(LR)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([tp], LR)
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(to_np(tp), np.asarray(jp), rtol=1e-6,
                                   atol=1e-9)


def _jax_batch(batch):
    return JPoseSample(*(jnp.asarray(v) for v in batch))


def test_phase2_step_matches_jax(setup):
    """One refine step (K=2, summed losses, Adam over the refiner) against
    the JAX package's ``make_refine_train_step``: metrics to rtol 1e-5, the
    gradient (read back from Adam's first moment, ``mu = 0.1 g``) to
    ``1e-4 * max|grad|`` per parameter, and the updated parameters to
    atol 1e-6 wherever ``|g|`` is above 1e-4 of its parameter's largest.
    Adam's first update is ``lr * g / (|g| + eps)``, which for a gradient
    at rounding-noise size is any value in [-lr, lr]: those elements are
    held to that bound only."""
    batch, jpose, jref, p_pose, p_ref = setup
    tx = j_make_optimizer(LR)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params_pose=p_pose,
                         params_refine=p_ref, opt_state=tx.init(p_ref),
                         rng=jax.random.key(0))
    jstep = j_make_refine_train_step(jpose, jref, tx, refine_iters=2)
    jnew, jmetrics = jstep(jstate, _jax_batch(batch), jnp.float32(W))
    mu = jnew.opt_state[0].mu
    want_g = compat.refiner_state_dict_from_flax(
        jax.tree.map(lambda x: np.asarray(x) / 0.1, mu))
    want_p = compat.refiner_state_dict_from_flax(
        jax.tree.map(np.array, jnew.params_refine))
    before = compat.refiner_state_dict_from_flax(p_ref)

    state = _port_state(setup)
    step = make_refine_train_step(state, refine_iters=2)
    metrics = step(to_device(batch, "cpu"), W)
    assert state.step == 1
    for k in ("loss", "dis"):
        np.testing.assert_allclose(to_np(metrics[k]),
                                   np.asarray(jmetrics[k]), rtol=1e-5)
    named = dict(state.refiner.named_parameters())
    _assert_grads_close({k: p.grad for k, p in named.items()}, want_g, 1e-4)
    for k, p in named.items():
        g = want_g[k].numpy()
        clear = np.abs(g) > 1e-4 * np.abs(g).max()
        got, want = to_np(p), want_p[k].numpy()
        np.testing.assert_allclose(got[clear], want[clear], rtol=0, atol=1e-6,
                                   err_msg=k)
        # |update| <= lr, plus the float32 rounding of the parameter
        assert np.abs(got - before[k].numpy()).max() <= LR + 1e-6
    # the PoseNet is frozen in phase 2
    for k, v in state.posenet.state_dict().items():
        np.testing.assert_array_equal(
            to_np(v), compat.posenet_state_dict_from_flax(p_pose)[k])


def test_eval_step_matches_jax(setup):
    batch, jpose, jref, p_pose, p_ref = setup
    jstep = j_make_eval_step(jpose, jref, refine_iters=2, use_adds=True)
    jdis, jvalid = jstep(p_pose, p_ref, _jax_batch(batch), jnp.float32(W))
    dis, valid = make_eval_step(_port_state(setup), 2, True)(
        to_device(batch, "cpu"), W)
    np.testing.assert_allclose(to_np(dis), np.asarray(jdis), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(to_np(valid), np.asarray(jvalid))


def test_phase1_step_updates_posenet(setup):
    """The phase-1 step wiring: train mode with the state's generator, a
    fresh Adam over the PoseNet, metrics left as tensors, every parameter
    that gets a gradient moved, the refiner untouched."""
    batch = setup[0]
    state = _port_state(setup)
    before = {k: v.clone() for k, v in state.posenet.state_dict().items()}
    ref_before = {k: v.clone() for k, v in state.refiner.state_dict().items()}
    step = make_pose_train_step(state, use_adds=True)
    metrics = step(to_device(batch, "cpu"), W)
    assert state.step == 1 and state.posenet.training
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in metrics.values())
    assert np.isfinite(float(metrics["loss"]))
    moved = [k for k, v in state.posenet.state_dict().items()
             if not torch.equal(v, before[k])]
    assert len(moved) > 0.9 * len(before)
    for k, v in state.refiner.state_dict().items():
        assert torch.equal(v, ref_before[k])


def test_dropout2d():
    x = torch.ones((2, 4096, 3, 3))
    drop = Dropout2d(0.3)
    y = drop(x, torch.Generator().manual_seed(7))
    per_map = y.flatten(2)
    # whole (sample, channel) maps are dropped or scaled by 1 / (1 - p)
    assert torch.all(per_map.amin(-1) == per_map.amax(-1))
    values = torch.unique(y)
    assert len(values) == 2 and values[0] == 0.0
    assert float(values[1]) == pytest.approx(1 / 0.7)
    kept = float((per_map[..., 0] > 0).float().mean())
    assert abs(kept - 0.7) < 0.03
    # the same seed draws the same mask, another seed another
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(7)))
    assert not torch.equal(y, drop(x, torch.Generator().manual_seed(8)))
    assert drop.eval()(x, torch.Generator().manual_seed(7)) is x


def test_posenet_dropout_follows_generator(setup):
    batch = to_device(setup[0], "cpu")
    pose = _port_state(setup).posenet
    args = (batch.img, batch.points, batch.choose, batch.obj_idx)
    with torch.no_grad():
        ev = pose.eval()(*args)["pred_t"]
        pose.train()
        a = pose(*args, generator=torch.Generator().manual_seed(3))["pred_t"]
        b = pose(*args, generator=torch.Generator().manual_seed(3))["pred_t"]
        c = pose(*args, generator=torch.Generator().manual_seed(4))["pred_t"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, ev)


def test_init_matches_flax_statistics():
    """Fresh weights against the JAX package's flax init: zeros and the
    identity-quaternion biases exactly, and every kernel of 4096 or more
    elements within 10% of flax's standard deviation (sampling error
    about 1% each)."""
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.standard_normal((1, CROP, CROP, 3)), jnp.float32)
    pts = jnp.zeros((1, 16, 3))
    obj = jnp.zeros((1,), jnp.int32)
    want = {**{("pose", k): v for k, v in
               compat.posenet_state_dict_from_flax(jax.tree.map(
                   np.array, jax.jit(JPoseNet(num_obj=NUM_OBJ).init)(
                       jax.random.key(0), img, pts,
                       jnp.zeros((1, 16), jnp.int32), obj))).items()},
            **{("ref", k): v for k, v in
               compat.refiner_state_dict_from_flax(jax.tree.map(
                   np.array, jax.jit(JRefiner(num_obj=NUM_OBJ).init)(
                       jax.random.key(1), pts, jnp.zeros((1, 16, EMB)),
                       obj))).items()}}
    pose, ref = PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ)
    gen = torch.Generator().manual_seed(0)
    init_posenet_(pose, gen)
    init_refiner_(ref, gen)
    got = {**{("pose", k): v for k, v in pose.state_dict().items()},
           **{("ref", k): v for k, v in ref.state_dict().items()}}
    assert set(got) == set(want)
    checked = 0
    for key, w in want.items():
        g = to_np(got[key])
        w = np.asarray(w)
        if not w.std() or w.size < 4096:
            # zeros, constants (PReLU slopes, identity-quaternion biases)
            if not w.std():
                np.testing.assert_array_equal(g, w, err_msg=str(key))
            continue
        assert abs(g.std() / w.std() - 1) < 0.1, key
        assert abs(g.mean()) < 0.1 * w.std(), key
        checked += 1
    assert checked > 30
    r_bias = to_np(pose.conv4_r.bias).reshape(NUM_OBJ, 4)
    np.testing.assert_array_equal(r_bias, np.tile([1.0, 0, 0, 0],
                                                  (NUM_OBJ, 1)))


def test_create_train_state_is_seeded():
    a = create_train_state(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ), LR, 5,
                           device="cpu")
    b = create_train_state(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ), LR, 5,
                           device="cpu")
    for x, y in zip(a.posenet.state_dict().values(),
                    b.posenet.state_dict().values()):
        assert torch.equal(x, y)
    assert a.step == 0
    assert {id(p) for p in a.optimizer.param_groups[0]["params"]} == \
        {id(p) for p in a.posenet.parameters()}
    assert a.optimizer.defaults["betas"] == (0.9, 0.999)
    assert a.optimizer.defaults["eps"] == 1e-8


def test_to_device_dtypes(setup):
    b = to_device(setup[0], "cpu")
    assert b.choose.dtype == torch.long and b.obj_idx.dtype == torch.long
    assert b.sym.dtype == torch.bool and b.valid.dtype == torch.bool
    assert b.img.dtype == torch.float32 and b.img.shape == (B, CROP, CROP, 3)


def test_curriculum_round_trip_matches_jax():
    cur = Curriculum(epoch=3, lr=3e-5, refine_started=True, refine_steps=9)
    assert cur.to_dict() == JCurriculum(**cur.to_dict()).to_dict()
    assert Curriculum.from_dict({**cur.to_dict(), "future": 1}) == cur
