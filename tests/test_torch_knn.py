"""Port parity: the plain versions of the 1-NN kernels and of the ADD-S
remap against the JAX package's Pallas kernels ``_nn_kernel``,
``_nn_kernel_bt`` and ``_remap_kernel_bt`` (run in TPU interpret mode, as
``tests/test_knn.py`` runs them) and against its XLA paths; ``knn`` and the
differentiable ``adds_min_sqdist_minus_qsq`` against the JAX functions; the
benchmark CLI on the CPU.

Tolerances: indices and remapped coordinates are compared EXACTLY (any
argmin disagreement shows, ties included); distances and scores to
rtol/atol 1e-5, since the Pallas kernels form q.r by a matmul and the port
by three rounded products; gradients to rtol 1e-4 / atol 1e-5. On exact
ties between refs at different places (x and y swapped) that rounding may
pick the other twin in the Pallas kernel: there its coordinates are held
to either twin and its scores to atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from densefusion_tpu.ops import adds_remap_targets as j_remap_targets
from densefusion_tpu.ops.knn import (
    adds_min_sqdist_minus_qsq as j_min_sqdist, adds_remap_pallas_batched,
    knn as j_knn, nearest_neighbor as j_nearest_neighbor,
    nearest_neighbor_pallas, nearest_neighbor_pallas_batched,
    nearest_neighbor_xla,
)
from densefusion_tpu_torch.cli import benchmark
from densefusion_tpu_torch.ops import knn

from tests.torch_port_util import to_np


def _pallas(q, r, active=None):
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        c, s = adds_remap_pallas_batched(
            jnp.asarray(q), jnp.asarray(r),
            None if active is None else jnp.asarray(active))
    return np.asarray(c), np.asarray(s)


def _plain(q, r, active=None):
    c, s = knn.adds_remap_plain(torch.from_numpy(q), torch.from_numpy(r),
                                None if active is None
                                else torch.from_numpy(active))
    return to_np(c), to_np(s)


@pytest.mark.parametrize("b,nq,nr", [
    (2, 300, 200),      # one tile each way
    (3, 37, 613),       # ragged Q and R, R past one Pallas ref tile
])
def test_remap_matches_pallas_and_xla(rng, b, nq, nr):
    q = rng.standard_normal((b, nq, 3)).astype(np.float32)
    r = rng.standard_normal((b, nr, 3)).astype(np.float32)
    got_c, got_s = _plain(q, r)
    want_c, want_s = _pallas(q, r)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    xla = np.asarray(j_remap_targets(jnp.asarray(q), jnp.asarray(r),
                                     backend="xla"))
    np.testing.assert_array_equal(got_c, xla)
    # the public entry on CPU tensors is the plain version
    np.testing.assert_array_equal(
        to_np(knn.adds_remap_targets(torch.from_numpy(q),
                                     torch.from_numpy(r))), got_c)


def test_remap_ties_pick_lowest_index(rng):
    """Duplicated refs tie exactly; the winner must be the lower index, as
    in the XLA argmin and the Pallas kernel's strict-< scan."""
    q = rng.standard_normal((2, 400, 3)).astype(np.float32)
    half = rng.standard_normal((2, 150, 3)).astype(np.float32)
    r = np.concatenate([half, half], axis=1)
    _, idx = knn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(r))
    idx = to_np(idx)
    assert idx.max() < 150
    for bi in range(2):
        _, want = nearest_neighbor_xla(jnp.asarray(q[bi]), jnp.asarray(r[bi]))
        np.testing.assert_array_equal(idx[bi], np.asarray(want))
    got_c, _ = _plain(q, r)
    np.testing.assert_array_equal(got_c, _pallas(q, r)[0])


def test_remap_active_mask(rng):
    q = rng.standard_normal((3, 100, 3)).astype(np.float32)
    r = rng.standard_normal((3, 80, 3)).astype(np.float32)
    active = np.array([1, 0, 1], np.int32)
    got_c, got_s = _plain(q, r, active)
    want_c, want_s = _pallas(q, r, active.astype(bool))
    assert not got_c[1].any() and not got_s[1].any()
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)


def _swapped_ties(rng, b, nq, nr):
    """Refs k and k + nr/2 at (x, y, z) and (y, x, z), queries with q_x =
    q_y, at the ADD-S geometry (a 5 cm object): each query scores both refs
    of a pair alike, bit for bit."""
    import chip_smoke

    return chip_smoke.swapped_remap_problem(rng, b, nq, nr)


def test_remap_plain_swapped_ties_pick_lower_twin(rng):
    """On ties between refs at different places the plain version (the
    kernel's yardstick on the card) keeps the lower twin for every query:
    the twin's score equals the winner's, and the winner's coordinates are
    the first copy's."""
    q, r = _swapped_ties(rng, 2, 300, 600)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    best, idx = knn._nearest(qt, rt)
    assert int(idx.max()) < 300
    twin = torch.gather(knn._scores(qt, rt), 2, (idx + 300)[..., None])[..., 0]
    assert torch.equal(twin, best)
    c, s = _plain(q, r)
    np.testing.assert_array_equal(
        c, np.take_along_axis(r, to_np(idx)[..., None], axis=1))
    np.testing.assert_array_equal(s, to_np(best))
    assert (c[..., 0] != c[..., 1]).all()   # a wrong twin would show


def test_remap_pallas_swapped_ties_pick_a_twin(rng):
    """The JAX Pallas kernel rounds its scores otherwise (``dot_general``
    and a summed ``rsq``), so a pinned exact tie is no tie there and it may
    keep either twin: its coordinates are the plain winner's or its twin's
    (x and y swapped), its scores within 1e-6 of the plain version's."""
    q, r = _swapped_ties(rng, 2, 300, 600)
    pc, ps = _plain(q, r)
    jc, js = _pallas(q, r)
    same = (jc == pc).all(-1)
    twin = (jc == pc[..., [1, 0, 2]]).all(-1)
    assert (same | twin).all()
    np.testing.assert_allclose(js, ps, rtol=0, atol=1e-6)


def test_remap_gated_ragged_past_one_tile_matches_pallas(rng):
    """A gated row and R = 1100, past the kernel's 1024-ref tile and two of
    the Pallas kernel's 512-ref tiles, with a ragged Q."""
    q = rng.standard_normal((3, 37, 3)).astype(np.float32)
    r = rng.standard_normal((3, 1100, 3)).astype(np.float32)
    active = np.array([1, 0, 1], np.int32)
    got_c, got_s = _plain(q, r, active)
    want_c, want_s = _pallas(q, r, active.astype(bool))
    assert not got_c[1].any() and not got_s[1].any()
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)


def test_nearest_neighbor_distances(rng):
    q = rng.standard_normal((2, 90, 3)).astype(np.float32)
    r = rng.standard_normal((2, 70, 3)).astype(np.float32)
    d, i = knn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(r))
    brute = ((q[:, :, None] - r[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(to_np(i), brute.argmin(-1))
    np.testing.assert_allclose(to_np(d), brute.min(-1), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_plain_version_without_launch(rng, monkeypatch):
    monkeypatch.setattr(knn.adds_remap_kernel, "launches", 0)
    q = torch.from_numpy(rng.standard_normal((2, 10, 3)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 12, 3)).astype(np.float32))
    knn.adds_remap(q, r, torch.tensor([True, False]))
    assert knn.adds_remap_kernel.launches == 0


# ---------------------------------------------------------------------------
# The 1-NN search (TPU kernels 3 and 4)
# ---------------------------------------------------------------------------

def _nn_pallas(q, r):
    fn = nearest_neighbor_pallas if q.ndim == 2 \
        else nearest_neighbor_pallas_batched
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        d, i = fn(jnp.asarray(q), jnp.asarray(r))
    return np.asarray(d), np.asarray(i)


def _nn_case(rng, kind, lead):
    """(query, ref) with leading dims ``lead``: ``ragged`` Q=37 against
    R=613 (past one 512-ref tile), ``ties`` duplicated refs, ``sentinel``
    refs padded with the collectives' far-away 1e15 points."""
    nq, nr = {"ragged": (37, 613), "ties": (200, 150),
              "sentinel": (90, 70)}[kind]
    q = rng.standard_normal(lead + (nq, 3)).astype(np.float32)
    r = rng.standard_normal(lead + (nr, 3)).astype(np.float32)
    if kind == "ties":
        r = np.concatenate([r, r], axis=-2)
    if kind == "sentinel":
        r = np.concatenate([r, np.full(lead + (5, 3), 1.0e15, np.float32)],
                           axis=-2)
    return q, r


@pytest.mark.parametrize("kind", ["ragged", "ties", "sentinel"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["rank2", "batched"])
def test_nn_plain_matches_pallas(rng, kind, lead):
    """Kernel 3's (rank 2) and kernel 4's (batched) plain versions against
    the Pallas kernels in interpret mode."""
    q, r = _nn_case(rng, kind, lead)
    plain = knn.nearest_neighbor_plain if not lead \
        else knn.nearest_neighbor_plain_batched
    d, i = plain(torch.from_numpy(q), torch.from_numpy(r))
    assert d.dtype == torch.float32 and i.dtype == torch.int64
    want_d, want_i = _nn_pallas(q, r)
    np.testing.assert_array_equal(to_np(i), want_i)
    np.testing.assert_allclose(to_np(d), want_d, rtol=1e-5, atol=1e-5)
    if kind == "ties":
        assert to_np(i).max() < r.shape[-2] // 2


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_nearest_neighbor_dispatch_matches_jax(rng, lead):
    """Rank 2, 3 and 4 through the public entry, against the JAX
    ``nearest_neighbor`` (XLA path, vmapped over the leading dims)."""
    q = rng.standard_normal(lead + (50, 3)).astype(np.float32)
    r = rng.standard_normal(lead + (40, 3)).astype(np.float32)
    d, i = knn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(r))
    want_d, want_i = j_nearest_neighbor(jnp.asarray(q), jnp.asarray(r),
                                        backend="xla")
    assert tuple(d.shape) == tuple(want_d.shape) == lead + (50,)
    np.testing.assert_array_equal(to_np(i), np.asarray(want_i))
    np.testing.assert_allclose(to_np(d), np.asarray(want_d), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_knn_matches_jax(rng, k):
    q = rng.standard_normal((2, 40, 3)).astype(np.float32)
    r = rng.standard_normal((2, 25, 3)).astype(np.float32)
    d, i = knn.knn(torch.from_numpy(q), torch.from_numpy(r), k=k)
    want_d, want_i = j_knn(jnp.asarray(q), jnp.asarray(r), k=k,
                           backend="xla")
    assert tuple(d.shape) == (2, 40, k)
    np.testing.assert_array_equal(to_np(i), np.asarray(want_i))
    np.testing.assert_allclose(to_np(d), np.asarray(want_d), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("lead", [(2,), ()], ids=["batched", "rank2"])
def test_knn_ties_lowest_index_first(rng, lead):
    """k=3 against 150 refs duplicated: the first two distances tie exactly
    in every row, and the lower index must come first, as the JAX ``knn``
    (``lax.top_k``) orders them."""
    q = rng.standard_normal(lead + (200, 3)).astype(np.float32)
    half = rng.standard_normal(lead + (150, 3)).astype(np.float32)
    r = np.concatenate([half, half], axis=-2)
    d, i = knn.knn(torch.from_numpy(q), torch.from_numpy(r), k=3)
    want_d, want_i = j_knn(jnp.asarray(q), jnp.asarray(r), k=3,
                           backend="xla")
    i, d = to_np(i), to_np(d)
    assert i.dtype == np.int64 and i.shape == lead + (200, 3)
    np.testing.assert_array_equal(i, np.asarray(want_i))
    np.testing.assert_allclose(d, np.asarray(want_d), rtol=1e-5, atol=1e-5)
    tied = d[..., 0] == d[..., 1]
    assert tied.mean() > 0.9
    assert (i[..., 0][tied] < i[..., 1][tied]).all()
    assert (i[..., 0] < 150).all()


@pytest.mark.parametrize("active", [None, [True, False]],
                         ids=["all-rows", "gated"])
def test_min_sqdist_value_and_gradient_match_jax(rng, active):
    """``adds_min_sqdist_minus_qsq`` and its backward ``-2 g coords``
    against ``jax.grad`` of the JAX function (XLA path)."""
    pred = rng.standard_normal((2, 50, 3)).astype(np.float32)
    target = rng.standard_normal((2, 30, 3)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (2, 50)).astype(np.float32)
    act = None if active is None else np.asarray(active)

    def j_loss(p):
        return jnp.sum(j_min_sqdist(p, jnp.asarray(target),
                                    None if act is None else jnp.asarray(act),
                                    "xla") * g)

    p = torch.from_numpy(pred).requires_grad_(True)
    dm = knn.adds_min_sqdist_minus_qsq(
        p, torch.from_numpy(target),
        None if act is None else torch.from_numpy(act))
    (dm * torch.from_numpy(g)).sum().backward()
    want = j_min_sqdist(jnp.asarray(pred), jnp.asarray(target),
                        None if act is None else jnp.asarray(act), "xla")
    np.testing.assert_allclose(to_np(dm), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(p.grad),
                               np.asarray(jax.grad(j_loss)(jnp.asarray(pred))),
                               rtol=1e-4, atol=1e-5)
    if act is not None:
        assert not to_np(dm)[1].any() and not to_np(p.grad)[1].any()


def test_cpu_nn_search_launches_nothing(rng, monkeypatch):
    for k in (knn.nn_kernel, knn.nn_batched_kernel):
        monkeypatch.setattr(k, "launches", 0)
    q = torch.from_numpy(rng.standard_normal((2, 10, 3)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 12, 3)).astype(np.float32))
    knn.nearest_neighbor(q, r)
    knn.nearest_neighbor(q[0], r[0])
    knn.knn(q, r, k=1)
    assert knn.nn_kernel.launches == 0 and knn.nn_batched_kernel.launches == 0


def test_bench_knn_cli_on_cpu(capsys):
    """``--what knn --device cpu`` at a reduced query count: the JAX
    ``bench_knn``'s keys, the plain backend, one JSON object printed."""
    import json

    out = benchmark.main(["--what", "knn", "--device", "cpu", "--queries",
                          "2000"])
    assert set(out) == {"knn_backend", "knn_us", "knn_pairs_per_s",
                        "device"}
    assert out["knn_backend"] == "plain" and out["device"] == "cpu"
    assert out["knn_us"] > 0
    assert out["knn_pairs_per_s"] == pytest.approx(
        2000 * benchmark.NUM_REF / (out["knn_us"] * 1e-6))
    assert json.loads(capsys.readouterr().out) == out


@pytest.fixture(scope="module")
def tiny_ycb_root(tmp_path_factory):
    from densefusion_tpu_torch.data import generate_ycb_style_dataset

    root = str(tmp_path_factory.mktemp("ycb_bench"))
    generate_ycb_style_dataset(root, n_classes=3, n_real=3, n_syn=3,
                               n_test=1, seed=2)
    return root


@pytest.mark.parametrize("what", ["loader", "train_e2e"])
def test_bench_data_cli_on_cpu(capsys, tiny_ycb_root, what):
    """``--what loader`` / ``train_e2e`` with ``--device cpu`` on a tiny
    synthetic YCB root: the JAX ``bench_loader`` / ``bench_train_e2e``
    keys (plus the device, and bfloat16 compute for training, as the JAX
    benchmark's), positive rates, one JSON object printed."""
    import json

    args = ["--what", what, "--device", "cpu", "--dataset_root",
            tiny_ycb_root, "--batch", "2", "--workers", "2",
            "--num_points", "64", "--crop_size", "32"]
    if what == "train_e2e":
        args += ["--steps", "2", "--device_steps", "1"]
    out = benchmark.main(args)
    keys = ({"loader_workers", "loader_cold_samples_per_s",
             "loader_warm_samples_per_s", "loader_cache_hit_rate",
             "loader_ring_samples_per_s"} if what == "loader" else
            {"train_e2e_batch", "train_e2e_steps_per_s",
             "train_e2e_frames_per_s", "train_device_only_steps_per_s",
             "train_e2e_input_bound_fraction", "dtype"})
    assert set(out) == keys | {"device"} and out["device"] == "cpu"
    assert all(out[k] > 0 for k in keys
               if k.endswith("_per_s") or k == "loader_workers")
    if what == "loader":
        assert 0 < out["loader_cache_hit_rate"] <= 1
    else:
        assert out["dtype"] == "bfloat16" and out["train_e2e_batch"] == 2
        assert 0 <= out["train_e2e_input_bound_fraction"] < 1
        assert out["train_e2e_frames_per_s"] == pytest.approx(
            2 * out["train_e2e_steps_per_s"])
    assert json.loads(capsys.readouterr().out) == out


def test_bench_scaling_on_two_cpu_ranks(monkeypatch):
    """``bench_scaling`` on 1 and 2 spawned gloo ranks at a tiny width:
    the JAX ``bench_scaling``'s keys, ``scaling_1dev_efficiency`` exactly
    1, positive rates. A group that hangs fails after 180 s."""
    monkeypatch.setattr(benchmark, "SCALING_TIMEOUT_S", 180.0)
    out = benchmark.bench_scaling(per_device_batch=2, repeats=1,
                                  n_devices=2, device="cpu", num_points=16,
                                  mesh_points=16, crop_size=32, num_obj=2)
    keys = {f"scaling_{n}dev_{k}" for n in (1, 2)
            for k in ("fps", "efficiency")}
    assert set(out) == keys | {"dtype", "device"}
    assert out["device"] == "cpu" and out["dtype"] == "float32"
    assert out["scaling_1dev_efficiency"] == 1.0
    assert all(out[k] > 0 for k in keys)


def test_what_all_runs_knn_inference_and_train(monkeypatch, capsys):
    """``--what all``, the default as in the JAX CLI, runs the knn,
    inference and train benchmarks (patched here: no full-width CPU run)
    and prints their keys as one JSON object; no other benchmark runs."""
    import json

    calls = []

    def fake(name):
        def bench(**kwargs):
            calls.append(name)
            return {f"{name}_ran": True, "device": kwargs["device"]}
        return bench

    names = ("knn", "inference", "latency", "train_step", "refine_step",
             "seg", "scaling", "loader", "train_e2e")
    for name in names:
        monkeypatch.setattr(benchmark, f"bench_{name}", fake(name))
    out = benchmark.main(["--device", "cpu"])
    assert calls == ["knn", "inference", "train_step"]
    assert out == {"knn_ran": True, "inference_ran": True,
                   "train_step_ran": True, "device": "cpu"}
    assert json.loads(capsys.readouterr().out) == out
    assert benchmark.main(["--what", "scaling", "--device", "cpu"]) == {
        "scaling_ran": True, "device": "cpu"}
