"""Port parity: the mesh, batch placement and the mesh-sharded collectives
(``densefusion_tpu_torch/parallel``) in spawned gloo groups of 4 CPU ranks,
held to the JAX package's ``densefusion_tpu/parallel`` on ``make_mesh(4)``
of the conftest's 8 CPU devices (``backend="xla"``, as
``tests/test_parallel.py`` runs them).

Two groups are spawned, once each for the whole file: a 1-D ``(data,)``
mesh of 4, started from the environment a launcher such as ``torchrun``
sets (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free
localhost port), and a 2x2 ``(data, point)`` mesh over a ``FileStore``.
Every rank returns its results (``tests/torch_dist_worker.py``); each must
equal the others (the outputs are replicated). Tolerances: indices exactly;
distances rtol/atol 1e-5 (the port forms ``q.r`` by three rounded
products, XLA by a matmul); each rank's own gradient of ``sum(dis * w)``
within 1e-4 of each tensor's largest element (a gradient scaled by the
rank count, or one holding only the rank's slice, fails it). Each group
must finish within ``JOIN_S`` seconds or the test fails; its process group
times out first.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from densefusion_tpu.geometry import quat_to_matrix, random_quaternion
from densefusion_tpu.parallel import (
    make_mesh as j_make_mesh, make_shard_batch_fn as j_shard_batch_fn,
    ring_nearest_neighbor as j_ring, sharded_hypothesis_mean_dist as j_hyp,
    sharded_nearest_neighbor as j_sharded,
)

from tests import torch_dist_worker

WORLD = 4
JOIN_S = 90


def _spawn(case: str, inputs: dict, init) -> list:
    """Run ``case`` on WORLD spawned ranks, their group started from
    ``init`` (a coordinator URL or a launcher's environment); their results
    by rank."""
    try:
        return torch_dist_worker.spawn(case, inputs, init, WORLD, JOIN_S)
    except RuntimeError as e:
        pytest.fail(str(e))


def _hyp_problem(rng, b, n, m, sym):
    R = np.asarray(quat_to_matrix(random_quaternion(jax.random.key(2),
                                                    (b, n))), np.float32)
    t = rng.uniform(-0.3, 0.3, (b, n, 3)).astype(np.float32)
    model = rng.uniform(-0.05, 0.05, (b, m, 3)).astype(np.float32)
    rot = np.asarray(quat_to_matrix(random_quaternion(jax.random.key(4),
                                                      (b,))), np.float32)
    target = (model @ np.swapaxes(rot, -1, -2)
              + rng.uniform(-0.3, 0.3, (b, 1, 3))).astype(np.float32)
    wgt = rng.uniform(0.2, 1.0, (b, n)).astype(np.float32)
    return {"R": R, "t": t, "model": model, "target": target,
            "sym": np.asarray(sym), "wgt": wgt}


def _nn_problems(rng, shapes):
    out = []
    for nq, nr, dup in shapes:
        q = rng.standard_normal((nq, 3)).astype(np.float32)
        r = rng.standard_normal((nr, 3)).astype(np.float32)
        if dup:   # exact ties across shards
            r = np.concatenate([r, r])
        out.append((q, r))
    return out


# (Q, R, duplicate refs): R not dividing 4; M=2600 with ragged Q; R below
# the rank count (whole shards of sentinels); ties across shards
LINE_NN = [(130, 2601, False), (101, 2600, False), (17, 3, False),
           (90, 150, True)]
GRID_NN = [(33, 21, False)]


@pytest.fixture(scope="module")
def line_case():
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((8, 16, 3)).astype(np.float32),
             rng.integers(0, 100, (8, 16)).astype(np.int32),
             rng.standard_normal((8, 4, 4, 3)).astype(np.float32),
             rng.standard_normal((8, 5, 3)).astype(np.float32),
             rng.standard_normal((8, 5, 3)).astype(np.float32),
             np.arange(8, dtype=np.int32), np.arange(8) % 2 == 0,
             np.ones(8, bool))
    inputs = {"world": WORLD, "nn": _nn_problems(rng, LINE_NN),
              "hyp": _hyp_problem(rng, 3, 13, 11, [True, False, True]),
              "batch": batch}
    env = torch_dist_worker.launcher_env(WORLD)
    return inputs, _spawn("line", inputs, env)


@pytest.fixture(scope="module")
def grid_case(tmp_path_factory):
    rng = np.random.default_rng(1)
    inputs = {"world": WORLD, "shape": (2, 2),
              "nn": _nn_problems(rng, GRID_NN),
              "hyp": _hyp_problem(rng, 4, 13, 11,
                                  [True, False, True, False])}
    store = tmp_path_factory.mktemp("grid") / "store"
    return inputs, _spawn("grid", inputs, f"file://{store}")


def _same_on_every_rank(values):
    for v in values[1:]:
        np.testing.assert_array_equal(v, values[0])
    return values[0]


def _check_nn(inputs, results, jax_fn, key, **kw):
    fn = jax.jit(functools.partial(jax_fn, backend="xla", **kw))
    for c, (q, r) in enumerate(inputs["nn"]):
        d = _same_on_every_rank([res["nn"][c][key][0] for res in results])
        i = _same_on_every_rank([res["nn"][c][key][1] for res in results])
        dw, iw = fn(jnp.asarray(q), jnp.asarray(r))
        np.testing.assert_array_equal(i, np.asarray(iw))
        np.testing.assert_allclose(d, np.asarray(dw), rtol=1e-5, atol=1e-5)


def _check_hyp(inputs, results, mesh, **kw):
    h = {k: jnp.asarray(v) for k, v in inputs["hyp"].items()}

    def loss(R, t):
        return jnp.sum(j_hyp(R, t, h["model"], h["target"], h["sym"], mesh,
                             backend="xla", **kw) * h["wgt"])

    want = jax.jit(functools.partial(j_hyp, mesh=mesh, backend="xla", **kw))(
        h["R"], h["t"], h["model"], h["target"], h["sym"])
    got = _same_on_every_rank([res["hyp"]["dis"] for res in results])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
    gR_want, gt_want = jax.jit(jax.grad(loss, argnums=(0, 1)))(h["R"],
                                                                h["t"])
    for key, want_g in (("gR", gR_want), ("gt", gt_want)):
        want_g = np.asarray(want_g)
        for rank, res in enumerate(results):
            err = np.abs(res["hyp"][key] - want_g).max()
            assert err <= 1e-4 * np.abs(want_g).max(), (key, rank, err)


@pytest.mark.parametrize("case", ["line", "grid"])
def test_every_rank_joins_one_group(case, request):
    """Each spawned rank joined one group of WORLD at its own rank: from a
    launcher's environment alone (``line``: ``make_mesh`` started it) and
    from a coordinator URL (``grid``)."""
    _, results = request.getfixturevalue(f"{case}_case")
    assert [res["group"] for res in results] == [(r, WORLD)
                                                 for r in range(WORLD)]


def test_sharded_nearest_neighbor_4_ranks(line_case):
    inputs, results = line_case
    _check_nn(inputs, results, j_sharded, "sharded", mesh=j_make_mesh(4))


def test_ring_nearest_neighbor_4_ranks(line_case):
    inputs, results = line_case
    _check_nn(inputs, results, j_ring, "ring", mesh=j_make_mesh(4))


def test_sharded_hypothesis_mean_dist_4_ranks(line_case):
    inputs, results = line_case
    _check_hyp(inputs, results, j_make_mesh(4))


def test_batch_placement_4_ranks(line_case):
    """make_shard_batch_fn keeps each rank's axis-0 slice, as JAX's places
    one shard per device; scalars stay whole. replicate, psum_mean and
    local_batch_slice on the same group."""
    inputs, results = line_case
    from densefusion_tpu.data import PoseSample as JSample
    placed = j_shard_batch_fn(j_make_mesh(4))(
        JSample(*(jnp.asarray(x) for x in inputs["batch"])))
    for rank, res in enumerate(results):
        want = np.asarray(placed.points.addressable_shards[rank].data)
        np.testing.assert_array_equal(res["shard_points"], want)
        np.testing.assert_array_equal(
            res["shard_sym"],
            np.asarray(placed.sym.addressable_shards[rank].data))
        np.testing.assert_array_equal(res["shard_w"], want)
        assert res["step"] == 7
        assert res["local_slice"] == slice(4 * rank, 4 * rank + 4)
        np.testing.assert_array_equal(res["replicated"], np.zeros(3))
        np.testing.assert_allclose(res["mean"], np.full(3, 1.5))


def test_2d_mesh_data_point_sharding(grid_case):
    """2x2 (data, point) mesh: the hypothesis distance with the batch on
    ``data`` and the hypotheses on ``point`` (value and gradient), and both
    1-NN collectives on ``point``."""
    inputs, results = grid_case
    mesh = j_make_mesh(4, axis_names=("data", "point"), shape=(2, 2))
    _check_hyp(inputs, results, mesh, axis="point", batch_axis="data")
    _check_nn(inputs, results, j_sharded, "sharded", mesh=mesh,
              axis="point")
    _check_nn(inputs, results, j_ring, "ring", mesh=mesh, axis="point")
