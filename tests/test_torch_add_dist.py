"""Port parity: the fused ADD / ADD-S hypothesis distance.

The plain versions (which stand in for ``csrc/add_dist.cu`` on the CPU) are
held against the JAX package's Pallas kernels ``_paired_kernel`` and
``_min_kernel`` run through ``_fused_impl`` in TPU interpret mode, as
``tests/test_add_dist.py`` runs them: dis to rtol 1e-5 / atol 1e-7 and the
12 coefficients to atol 1e-6 (the same float32 arithmetic, summed in
another order; the Pallas kernels sum on the MXU). The autograd Function's
gradients are held against ``jax.grad`` of the XLA reference at rtol 1e-4 /
atol 1e-6, as the JAX package holds its own kernels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from densefusion_tpu.ops.add_dist import _fused_impl, hypothesis_mean_dist_xla
from densefusion_tpu_torch.geometry import quat_normalize, quat_to_matrix
from densefusion_tpu_torch.ops import add_dist

from tests.torch_port_util import to_np

DIS_TOL = dict(rtol=1e-5, atol=1e-7)
COEF_TOL = dict(rtol=0.0, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _problem(rng, b, n, m, ties=False, at_pose=False):
    """Hypotheses near a random ground-truth pose: R (B, N, 3, 3), t
    (B, N, 3), model / target (B, M, 3), float32 numpy. ``ties`` repeats
    the model points (so targets tie exactly in the ADD-S search);
    ``at_pose`` puts every hypothesis at the pose (d^2 below the floor)."""
    model = rng.uniform(-0.05, 0.05, (b, m // 2 if ties else m, 3))
    if ties:
        model = np.concatenate([model, model], axis=1)
    q_gt = to_np(quat_normalize(torch.from_numpy(rng.standard_normal((b, 4)))))
    R_gt = to_np(quat_to_matrix(torch.from_numpy(q_gt)))
    t_gt = rng.uniform(-0.3, 0.3, (b, 3))
    target = np.einsum("bmj,bcj->bmc", model, R_gt) + t_gt[:, None]
    if at_pose:
        R = np.broadcast_to(R_gt[:, None], (b, n, 3, 3))
        t = np.broadcast_to(t_gt[:, None], (b, n, 3))
    else:
        q = quat_normalize(torch.from_numpy(rng.standard_normal((b, n, 4))))
        R = to_np(quat_to_matrix(q))
        t = rng.uniform(-0.3, 0.3, (b, n, 3))
    return tuple(np.ascontiguousarray(x, np.float32)
                 for x in (R, t, model, target))


def _jax_fused(R, t, model, target, sym, use_adds):
    with pltpu.force_tpu_interpret_mode():
        dis, coef = _fused_impl(*(jnp.asarray(x) for x in
                                  (R, t, model, target, sym)), use_adds)
    return np.asarray(dis), np.asarray(coef)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("b,n,m,sym,use_adds,kw", [
    (2, 5, 12, [False, False], True, {}),
    (2, 5, 12, [True, True], True, {}),
    (3, 130, 9, [True, False, True], True, {}),     # N past one Pallas block
    (2, 1, 40, [True, False], True, {}),            # the refiner's N=1
    (2, 5, 12, [True, True], False, {}),            # use_adds off: all ADD
    (2, 6, 20, [True, False], True, {"ties": True}),
    (2, 4, 8, [True, False], True, {"at_pose": True}),
    # the paired kernel's split edges: fewer model points than the threads
    # that share a hypothesis, one point, and the refiner's N=1 at M=2600
    (2, 65, 7, [True, False], False, {}),
    (2, 1, 1, [True, False], False, {}),
    (2, 1, 2600, [True, False], False, {}),
])
def test_plain_matches_pallas(rng, b, n, m, sym, use_adds, kw):
    R, t, model, target = _problem(rng, b, n, m, **kw)
    sym = np.asarray(sym)
    want_d, want_c = _jax_fused(R, t, model, target, sym, use_adds)
    got_d, got_c = add_dist.dist_and_coef(*_torch(R, t, model, target, sym),
                                          use_adds)
    np.testing.assert_allclose(to_np(got_d), want_d, **DIS_TOL)
    np.testing.assert_allclose(to_np(got_c), want_c, **COEF_TOL)
    if kw.get("at_pose"):
        # below the floor: distance sqrt(EPS), coefficients exactly 0
        np.testing.assert_allclose(to_np(got_d), 1e-6, rtol=1e-3)
        assert not to_np(got_c).any()


def test_gated_rows_are_zero(rng):
    R, t, model, target = _problem(rng, 3, 7, 15)
    act = torch.tensor([1, 0, 1], dtype=torch.int32)
    for plain in (add_dist.paired_plain, add_dist.min_plain):
        d, c = plain(*_torch(R, t, model, target), act)
        assert not d[1].any() and not c[1].any()
        assert d[0].all() and d[2].all()


@pytest.mark.parametrize("sym", [[False, False, False], [True, True, True],
                                 [True, False, True]])
def test_function_grads_match_jax(rng, sym):
    """Backward ``g * coef`` through the autograd Function against
    ``jax.grad`` of the XLA reference formula, for both branches."""
    R, t, model, target = _problem(rng, 3, 6, 10)
    sym = np.asarray(sym)
    wgt = rng.uniform(0.2, 1.0, (3, 6)).astype(np.float32)

    def loss_jax(R_, t_):
        return jnp.sum(hypothesis_mean_dist_xla(
            R_, t_, jnp.asarray(model), jnp.asarray(target),
            jnp.asarray(sym), True) * wgt)

    gR_want, gt_want = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(R),
                                                          jnp.asarray(t))
    Rt, tt = _torch(R, t)
    Rt.requires_grad_(True)
    tt.requires_grad_(True)
    (add_dist.hypothesis_mean_dist(Rt, tt, *_torch(model, target, sym))
     * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(to_np(Rt.grad), np.asarray(gR_want),
                               **GRAD_TOL)
    np.testing.assert_allclose(to_np(tt.grad), np.asarray(gt_want),
                               **GRAD_TOL)


@pytest.mark.parametrize("nearest", [False, True])
def test_coefficients_are_autograd_of_naive_formula(rng, nearest):
    """The 12 coefficients equal torch autograd of the naive mean distance
    (the ADD-S target chosen without gradient), to rtol 1e-5 / atol 1e-7."""
    R, t, model, target = _torch(*_problem(rng, 2, 5, 11))
    act = torch.ones(2, dtype=torch.int32)
    plain = add_dist.min_plain if nearest else add_dist.paired_plain
    _, coef = plain(R, t, model, target, act)
    R, t = R.double().requires_grad_(True), t.double().requires_grad_(True)
    q = torch.einsum("bnij,bmj->bnmi", R, model.double()) + t[:, :, None]
    tgt = target.double()[:, None].expand_as(q)
    if nearest:
        idx = ((q[..., None, :] - target.double()[:, None, None]) ** 2) \
            .sum(-1).argmin(-1)
        tgt = torch.gather(target.double()[:, None].expand(-1, 5, -1, -1),
                           2, idx[..., None].expand(-1, -1, -1, 3))
    dis = torch.sqrt(((q - tgt) ** 2).sum(-1).clamp_min(add_dist.EPS)) \
        .mean(-1)
    rows = []
    for bi in range(2):
        for ni in range(5):
            gR, gt = torch.autograd.grad(dis[bi, ni], (R, t),
                                         retain_graph=True)
            rows.append(torch.cat([gR[bi, ni].flatten(), gt[bi, ni]]))
    want = torch.stack(rows).reshape(2, 5, 12)
    np.testing.assert_allclose(to_np(coef), to_np(want), rtol=1e-5,
                               atol=1e-7)


def test_casts_outside_function(rng):
    """float64 inputs compute in float32 and get float64 gradients back;
    model, target and sym get none."""
    R, t, model, target = _torch(*_problem(rng, 2, 3, 9))
    R, t = R.double().requires_grad_(True), t.double().requires_grad_(True)
    model = model.double().requires_grad_(True)
    dis = add_dist.hypothesis_mean_dist(R, t, model, target.double(),
                                        torch.tensor([True, False]))
    assert dis.dtype == torch.float32
    dis.sum().backward()
    assert R.grad.dtype == torch.float64 and t.grad.dtype == torch.float64
    assert model.grad is None


def test_cpu_tensors_take_plain_version_without_launch(rng, monkeypatch):
    for k in (add_dist.paired_kernel, add_dist.min_kernel):
        monkeypatch.setattr(k, "launches", 0)
    R, t, model, target = _torch(*_problem(rng, 2, 3, 9))
    add_dist.hypothesis_mean_dist(R, t, model, target,
                                  torch.tensor([True, False]))
    assert add_dist.paired_kernel.launches == 0
    assert add_dist.min_kernel.launches == 0
