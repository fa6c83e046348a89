"""Port parity: ``pose_loss`` and ``refiner_loss`` against the JAX package's
(its XLA distance path on the CPU), on the same numpy-seeded predictions,
with one invalid row. Values and detached outputs to rtol 1e-5 / atol 1e-6
(float32, another summation order); gradients with respect to ``pred_r``,
``pred_t`` and ``pred_c_logit`` to rtol 1e-4 / atol 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from densefusion_tpu.losses import pose_loss as j_pose_loss
from densefusion_tpu.losses import refiner_loss as j_refiner_loss
from densefusion_tpu_torch.losses import pose_loss, refiner_loss

from tests.torch_port_util import to_np

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, N, M = 4, 24, 30
W = 0.015


def _data(rng):
    """Hypotheses around a shared object: (pred_r, pred_t, logit, target,
    model, points, sym, valid); row 3 is an invalid detection."""
    model = rng.uniform(-0.05, 0.05, (B, M, 3))
    target = model + np.array([0.0, 0.0, 0.7]) \
        + 0.01 * rng.standard_normal((B, 1, 3))
    points = target[:, :N] + 0.005 * rng.standard_normal((B, N, 3))
    pred_r = np.array([1.0, 0, 0, 0]) + 0.3 * rng.standard_normal((B, N, 4))
    pred_t = 0.02 * rng.standard_normal((B, N, 3))
    # a clear argmax-confidence winner per row
    logit = rng.standard_normal((B, N)) + 4.0 * (np.arange(N) == 5)
    sym = np.array([True, False, True, False])
    valid = np.array([True, True, True, False])
    f32 = [np.asarray(x, np.float32) for x in
           (pred_r, pred_t, logit, target, model, points)]
    return (*f32, sym, valid)


@pytest.mark.parametrize("use_adds", [True, False])
def test_pose_loss_matches_jax(rng, use_adds):
    pred_r, pred_t, logit, target, model, points, sym, valid = _data(rng)

    def jax_loss(r, tt, lg):
        out = j_pose_loss(r, tt, jax.nn.sigmoid(lg), jnp.asarray(target),
                          jnp.asarray(model), jnp.asarray(points),
                          jnp.asarray(sym), W, use_adds=use_adds,
                          sample_weight=jnp.asarray(valid, jnp.float32),
                          pred_c_logit=lg)
        return out.loss, out

    (jl, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(pred_r), jnp.asarray(pred_t), jnp.asarray(logit))

    r, tt, lg = (torch.from_numpy(x).requires_grad_(True)
                 for x in (pred_r, pred_t, logit))
    out = pose_loss(r, tt, torch.sigmoid(lg), torch.from_numpy(target),
                    torch.from_numpy(model), torch.from_numpy(points),
                    torch.from_numpy(sym), W, use_adds=use_adds,
                    sample_weight=torch.from_numpy(valid), pred_c_logit=lg)
    out.loss.backward()
    np.testing.assert_allclose(to_np(out.loss), np.asarray(jl), **TOL)
    for k in ("dis", "new_points", "new_target", "best_r", "best_t"):
        np.testing.assert_allclose(to_np(getattr(out, k)),
                                   np.asarray(getattr(jout, k)), err_msg=k,
                                   **TOL)
    for name, g, want in zip(("pred_r", "pred_t", "pred_c_logit"),
                             (r.grad, tt.grad, lg.grad), jgrads):
        np.testing.assert_allclose(to_np(g), np.asarray(want), err_msg=name,
                                   **GRAD_TOL)
    # the invalid row contributes no gradient
    assert not r.grad[3].any() and not lg.grad[3].any()
    assert not out.new_points.requires_grad


def test_pose_loss_without_logits_matches_jax(rng):
    """The ``log(c)`` barrier when no logits are given, unweighted mean."""
    pred_r, pred_t, logit, target, model, points, sym, _ = _data(rng)
    conf = 1.0 / (1.0 + np.exp(-logit.astype(np.float64)))
    conf = conf.astype(np.float32)
    jout = j_pose_loss(*(jnp.asarray(x) for x in
                         (pred_r, pred_t, conf, target, model, points, sym)),
                       W)
    out = pose_loss(*(torch.from_numpy(x) for x in
                      (pred_r, pred_t, conf, target, model, points, sym)), W)
    np.testing.assert_allclose(to_np(out.loss), np.asarray(jout.loss), **TOL)
    np.testing.assert_allclose(to_np(out.dis), np.asarray(jout.dis), **TOL)


def test_refiner_loss_matches_jax(rng):
    _, _, _, target, model, points, sym, valid = _data(rng)
    pred_r = (np.array([1.0, 0, 0, 0]) + 0.2 * rng.standard_normal((B, 4))) \
        .astype(np.float32)
    pred_t = (np.array([0.0, 0.0, 0.7])
              + 0.02 * rng.standard_normal((B, 3))).astype(np.float32)

    def jax_loss(r, tt):
        out = j_refiner_loss(r, tt, jnp.asarray(target), jnp.asarray(model),
                             jnp.asarray(points), jnp.asarray(sym),
                             sample_weight=jnp.asarray(valid, jnp.float32))
        return out.loss, out

    (jl, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(pred_r), jnp.asarray(pred_t))
    r, tt = (torch.from_numpy(x).requires_grad_(True)
             for x in (pred_r, pred_t))
    out = refiner_loss(r, tt, torch.from_numpy(target),
                       torch.from_numpy(model), torch.from_numpy(points),
                       torch.from_numpy(sym),
                       sample_weight=torch.from_numpy(valid))
    out.loss.backward()
    np.testing.assert_allclose(to_np(out.loss), np.asarray(jl), **TOL)
    for k in ("dis", "new_points", "new_target"):
        np.testing.assert_allclose(to_np(getattr(out, k)),
                                   np.asarray(getattr(jout, k)), err_msg=k,
                                   **TOL)
    for g, want in zip((r.grad, tt.grad), jgrads):
        np.testing.assert_allclose(to_np(g), np.asarray(want), **GRAD_TOL)
