"""Port parity: data parallelism (ROADMAP §1 D) on spawned gloo ranks.

One group of 4 CPU ranks over a ``FileStore`` (``tests/torch_dist_worker.py``
``dp``), at the JAX DP test's width (2 objects, 16 points, 32 px, a global
batch of 8, weights from a numpy seed carried across by ``compat``):

* the data-parallel phase-1 and phase-2 steps, dropout on through one
  generator and the valid rows uneven (rows 0-2 valid: two ranks hold
  none), against the port's one-device step on the whole batch, run in
  each rank so only the errors travel: gradients within 1e-5 of each
  tensor's largest element, loss and ``dis`` rtol 1e-5, parameters atol
  1e-3 after two Adam steps (the JAX DP test's), the dropout generator in
  the same state, every rank's parameters byte-identical; also with
  ``grad_accum=2`` (two micro-steps, one update); a control in which each rank normalises its loss by
  its own valid count must fail the gradient check;
* the same steps against the JAX package's steps on the 8-device CPU mesh
  (dropout off, as ``tests/test_torch_train.py`` holds the one-device step):
  metrics rtol 1e-5, gradients 1e-4 of the largest, parameters atol 1e-6
  where the gradient is above 1e-4 of its parameter's largest;
* ``Trainer(shard_batch=)`` for one epoch of a generated LineMOD root
  against the one-process ``Trainer``; ``PoseEstimator(mesh=)`` on 5
  samples (padded to 8) against the meshless estimator and the JAX mesh
  estimator (``tests/test_serve.py``'s tolerance);
* in this process: ``Dropout2d(batch_rows=)`` and the sharded loader.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from densefusion_tpu.data import PoseSample as JPoseSample
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.models import pspnet as j_pspnet
from densefusion_tpu.parallel import make_mesh as j_make_mesh
from densefusion_tpu.parallel import make_shard_batch_fn as j_shard_batch_fn
from densefusion_tpu.serve import PoseEstimator as JPoseEstimator
from densefusion_tpu.train.state import TrainState as JTrainState
from densefusion_tpu.train.state import make_optimizer as j_make_optimizer
from densefusion_tpu.train.steps import (
    make_pose_train_step as j_make_pose_train_step,
    make_refine_train_step as j_make_refine_train_step,
)
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.data import (
    BatchLoader, LineModDataset, PoseSample, generate_linemod_style_dataset,
)
from densefusion_tpu_torch.models.layers import Dropout2d
from densefusion_tpu_torch.train import Trainer, load_state_dicts
from densefusion_tpu_torch.utils.config import RunConfig

from tests import torch_dist_worker
from tests.torch_port_util import EMB, init_params

WORLD, JOIN_S = 4, 300
NUM_OBJ, B, N, M, CROP, LR, W = 2, 8, 16, 16, 32, 1e-3, 0.015
STEP_CASES = {
    "phase1": {"phase": 1, "dropout": True, "grad_accum": 1,
               "order": [0, 0]},
    "phase2": {"phase": 2, "dropout": True, "grad_accum": 1,
               "order": [0, 0]},
    "phase1_grad_accum2": {"phase": 1, "dropout": True, "grad_accum": 2,
                           "order": [0, 1]},
    "phase1_per_rank_norm": {"phase": 1, "dropout": True, "grad_accum": 1,
                             "order": [0, 0], "control": True},
    "jax_phase1": {"phase": 1, "dropout": False, "grad_accum": 1,
                   "order": [0], "full": True},
    "jax_phase2": {"phase": 2, "dropout": False, "grad_accum": 1,
                   "order": [0], "full": True},
}


def _batch(rng, valid_rows) -> tuple:
    """A global batch of 8 at one scene scale; rows 0 and 5 symmetric."""
    model = rng.uniform(-0.05, 0.05, (B, M, 3))
    target = model + np.array([0.0, 0.0, 0.6]) \
        + 0.01 * rng.standard_normal((B, 1, 3))
    points = target[:, :N] + 0.005 * rng.standard_normal((B, N, 3))
    return tuple(PoseSample(
        points=points.astype(np.float32),
        choose=rng.integers(0, CROP * CROP, (B, N)).astype(np.int32),
        img=rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32),
        target=target.astype(np.float32),
        model_points=model.astype(np.float32),
        obj_idx=rng.integers(0, NUM_OBJ, (B,)).astype(np.int32),
        sym=np.isin(np.arange(B), (0, 5)),
        valid=np.isin(np.arange(B), valid_rows)))


def _samples(rng) -> list:
    """5 serving samples, the fourth a lost detection."""
    out = []
    for i in range(5):
        if i == 3:
            out.append(tuple(PoseSample.invalid(N, 8, CROP)))
            continue
        out.append(tuple(PoseSample(
            points=(0.03 * rng.standard_normal((N, 3))
                    + [0.0, 0.0, 0.6]).astype(np.float32),
            choose=rng.integers(0, CROP * CROP, (N,)).astype(np.int32),
            img=rng.standard_normal((CROP, CROP, 3)).astype(np.float32),
            target=np.zeros((8, 3), np.float32),
            model_points=np.zeros((8, 3), np.float32),
            obj_idx=np.asarray(i % NUM_OBJ, np.int32),
            sym=np.zeros((), bool), valid=np.ones((), bool))))
    return out


def _trainer_cfg(root, out) -> dict:
    return dict(
        dataset="linemod", dataset_root=root, num_objects=1, num_points=32,
        num_mesh_points=32, refine_mesh_points=32, crop_size=32,
        batch_size=4, num_workers=0, repeat_epoch=1, nepoch=1,
        refine_iters=2, out_dir=str(out / "out"), log_dir=str(out / "logs"),
        sym_list=(), seed=0, checkpoint_every_steps=10**9, objlist=(1,),
        lr=LR)


@pytest.fixture(scope="module")
def dp_case(tmp_path_factory):
    rng = np.random.default_rng(5)
    batches = [_batch(rng, (0, 1, 2)), _batch(rng, (1, 2, 6))]
    args = (jnp.zeros((1, CROP, CROP, 3)), jnp.zeros((1, N, 3)),
            jnp.zeros((1, N), jnp.int32), jnp.zeros((1,), jnp.int32))
    p_pose = init_params(JPoseNet(num_obj=NUM_OBJ), rng, *args,
                         conf_scale=8.0)
    p_ref = init_params(JRefiner(num_obj=NUM_OBJ), rng, args[1],
                        jnp.zeros((1, N, EMB)), args[3])
    tmp = tmp_path_factory.mktemp("dp")
    weights = str(tmp / "weights.pt")
    torch.save({"posenet": compat.posenet_state_dict_from_flax(p_pose),
                "refiner": compat.refiner_state_dict_from_flax(p_ref),
                "num_obj": NUM_OBJ}, weights)
    root = str(tmp / "lm")
    generate_linemod_style_dataset(root, objlist=(1,), n_train=8, n_test=60,
                                   seed=9)
    inputs = {
        "world": WORLD, "weights": weights, "batches": batches,
        "steps": {k: {**v, "lr": LR} for k, v in STEP_CASES.items()},
        "trainer": _trainer_cfg(root, tmp / "dp_run"),
        "serve": {"samples": _samples(rng), "num_points": N, "crop": CROP}}
    try:
        results = torch_dist_worker.spawn("dp", inputs,
                                          f"file://{tmp / 'store'}", WORLD,
                                          JOIN_S)
    except RuntimeError as e:
        pytest.fail(str(e))
    return {"inputs": inputs, "results": results, "tmp": tmp,
            "pose": p_pose, "ref": p_ref}


def _same_on_every_rank(values):
    for v in values[1:]:
        assert v == values[0]
    return values[0]


@pytest.mark.parametrize("case", ["phase1", "phase2", "phase1_grad_accum2"])
def test_dp_step_matches_one_device_step(dp_case, case):
    """Each rank's data-parallel step against the one-device step on the
    whole batch of 8, dropout on, rows 0-2 valid (ranks 2 and 3 hold no
    valid row): the gradient of every applied update, the loss and
    ``dis`` of every micro-step, the parameters after two Adam steps, the
    generator; the ranks' parameters byte-identical."""
    res = [r["steps"][case] for r in dp_case["results"]]
    _same_on_every_rank([r["digest"] for r in res])
    for rank, r in enumerate(res):
        assert r["grad_err"] <= 1e-5, (rank, r["grad_err"])
        np.testing.assert_allclose(r["metrics"], r["ref_metrics"],
                                   rtol=1e-5)
        assert r["param_err"] <= 1e-3, (rank, r["param_err"])
        assert r["generator_equal"]


def test_per_rank_normalisation_fails_the_gradient_check(dp_case):
    """The negative control: each rank divides its loss by its own valid
    count (2, 1, 0 and 0 here) instead of the batch's 3. The gradient is
    then not the one-device gradient, and the check above sees it."""
    for r in dp_case["results"]:
        assert r["steps"]["phase1_per_rank_norm"]["grad_err"] > 1e-2


class _NoDropout(nn.Module):
    rate: float

    @nn.compact
    def __call__(self, x, deterministic: bool):
        return x


@pytest.mark.parametrize("phase", [1, 2])
def test_dp_step_matches_jax_dp_step(dp_case, monkeypatch, phase):
    """The port's data-parallel step on 4 ranks against the JAX step with
    the batch sharded over the conftest's 8 CPU devices, dropout off in
    both (the JAX network's ``Dropout2d`` patched to the identity): metrics
    rtol 1e-5, the gradient (Adam's first moment / 0.1) within 1e-4 of
    each parameter's largest, the parameters after the step atol 1e-6
    where the gradient is above 1e-4 of its parameter's largest."""
    monkeypatch.setattr(j_pspnet, "Dropout2d", _NoDropout)
    p_pose, p_ref = dp_case["pose"], dp_case["ref"]
    mesh = j_make_mesh()
    tx = j_make_optimizer(LR)
    jpose, jref = JPoseNet(num_obj=NUM_OBJ), JRefiner(num_obj=NUM_OBJ)
    trained = p_pose if phase == 1 else p_ref
    state = jax.device_put(JTrainState(
        step=jnp.zeros((), jnp.int32), params_pose=p_pose,
        params_refine=p_ref, opt_state=tx.init(trained),
        rng=jax.random.key(0)), jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))
    step = (j_make_pose_train_step(jpose, tx, use_adds=True) if phase == 1
            else j_make_refine_train_step(jpose, jref, tx, refine_iters=2))
    batch = j_shard_batch_fn(mesh)(JPoseSample(
        *(jnp.asarray(x) for x in dp_case["inputs"]["batches"][0])))
    new, metrics = step(state, batch, jnp.float32(W))
    to_torch = (compat.posenet_state_dict_from_flax if phase == 1
                else compat.refiner_state_dict_from_flax)
    want_g = to_torch(jax.tree.map(lambda x: np.asarray(x) / 0.1,
                                   new.opt_state[0].mu))
    want_p = to_torch(jax.tree.map(np.array, new.params_pose if phase == 1
                                   else new.params_refine))
    got = dp_case["results"][0]["steps"][f"jax_phase{phase}"]
    np.testing.assert_allclose(got["metrics"][0],
                               [float(metrics["loss"]),
                                float(metrics["dis"])], rtol=1e-5)
    assert set(got["grads"][0]) == set(want_g)
    for k, w in want_g.items():
        w = w.numpy()
        err = np.abs(got["grads"][0][k] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err, np.abs(w).max())
        clear = np.abs(w) > 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(got["params"][k][clear],
                                   want_p[k].numpy()[clear], rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def one_process_trainer(dp_case):
    """The same epoch in one process (the trainer's own out dir)."""
    spec = dict(dp_case["inputs"]["trainer"])
    base = dp_case["tmp"] / "one_run"
    spec.update(out_dir=str(base / "out"), log_dir=str(base / "logs"))
    trainer = Trainer(RunConfig(**spec), device="cpu")
    tests = []
    test_epoch = trainer.test_epoch
    trainer.test_epoch = lambda: tests.append(test_epoch()) or tests[-1]
    trainer.setup()
    trainer.run()
    return trainer, tests


def test_trainer_ranks_agree_with_one_process(dp_case, one_process_trainer):
    """``Trainer(shard_batch=)`` over one epoch: every rank's parameters
    byte-identical, equal to the one-process trainer's within the step
    tolerance (atol 1e-3), and the same test ``avg_dis`` on every rank,
    equal to the one-process value within ``tests/test_serve.py``'s rtol
    1e-4 (two Adam updates at lr 1e-3 from gradients summed in another
    order move it by ~1.2e-5)."""
    trainer, tests = one_process_trainer
    ranks = [r["trainer"] for r in dp_case["results"]]
    _same_on_every_rank([r["digest"] for r in ranks])
    got_tests = _same_on_every_rank([r["tests"] for r in ranks])
    np.testing.assert_allclose(got_tests, tests, rtol=1e-4)
    out_dir = dp_case["inputs"]["trainer"]["out_dir"]
    pose, ref = load_state_dicts(f"{out_dir}/checkpoint_current")
    for got, module in ((pose, trainer.posenet), (ref, trainer.refiner)):
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-3, err_msg=k)


def test_trainer_only_rank0_writes(dp_case):
    """Rank 0 writes every checkpoint and metrics record; the others none.
    The one log file holds the run once."""
    ranks = [r["trainer"] for r in dp_case["results"]]
    assert ranks[0]["saves"] and ranks[0]["writes"] == ["train_epoch",
                                                        "test_epoch"]
    assert all(not r["saves"] and not r["writes"] for r in ranks[1:])
    log_dir = dp_case["inputs"]["trainer"]["log_dir"]
    with open(f"{log_dir}/metrics.jsonl") as f:
        assert len(f.readlines()) == 2
    with open(f"{log_dir}/train_log.txt") as f:
        assert sum("TEST avg_dis" in ln for ln in f) == 1


def test_trainer_stops_and_restarts_together(dp_case):
    """The STOP file and the RSS guard are collective decisions: a STOP
    file only rank 1 sees is seen by every rank, and an RSS limit only
    rank 2 crosses makes every rank's guard request the restart."""
    for r in dp_case["results"]:
        assert r["trainer"]["stop_seen"] and r["trainer"]["restart"]


def test_trainer_checkpoint_resumes_in_one_process(dp_case):
    """``checkpoint_current`` of the data-parallel run loads into a
    one-process ``Trainer``: the same parameters bit for bit."""
    spec = dict(dp_case["inputs"]["trainer"])
    base = dp_case["tmp"] / "resume"
    spec.update(out_dir=str(base / "out"), log_dir=str(base / "logs"))
    trainer = Trainer(RunConfig(**spec), device="cpu")
    trainer.setup(resume=f"{dp_case['inputs']['trainer']['out_dir']}"
                         "/checkpoint_current")
    assert trainer.param_digest() == dp_case["results"][0]["trainer"]["digest"]
    assert trainer.curriculum.epoch == 2


def test_trainer_loader_rows_are_the_one_process_rows(dp_case):
    """Each rank's training loader assembles its rows of each global batch
    only, and they are the one-process loader's rows bit for bit."""
    for rank, r in enumerate(dp_case["results"]):
        assert r["trainer"]["loader_shard"] == (rank, WORLD)
        assert r["trainer"]["loader_rows_equal"] \
            and all(r["trainer"]["loader_rows_equal"])


def test_mesh_estimator_matches_single_and_jax(dp_case):
    """``PoseEstimator(mesh=)`` on 4 ranks, 5 samples padded to 8 with
    invalid ones: every rank returns the 5 rows, equal to the meshless
    estimator's and to the JAX ``PoseEstimator(mesh=make_mesh())`` on the
    8 CPU devices (rtol 1e-4, atol 1e-5); the valid flags equal."""
    samples = dp_case["inputs"]["serve"]["samples"]
    jest = JPoseEstimator(JPoseNet(num_obj=NUM_OBJ), JRefiner(num_obj=NUM_OBJ),
                          dp_case["pose"], dp_case["ref"], num_points=N,
                          crop_size=CROP, refine_iters=2, mesh=j_make_mesh())
    want = jest.estimate_batch([JPoseSample(*s) for s in samples])
    for r in dp_case["results"]:
        got, single = r["serve"]["mesh"], r["serve"]["single"]
        assert got[0].shape == (5, 4)
        for g, s, w in zip(got[:3], single[:3], want[:3]):
            np.testing.assert_allclose(g, s, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
        np.testing.assert_array_equal(got[3], single[3])
        np.testing.assert_array_equal(got[3], np.asarray(want[3]))


@pytest.mark.parametrize("remat", [False, True])
def test_posenet_batch_rows(rng, remat):
    """``PoseNet(..., batch_rows=(2, 4, 4))`` in train mode on rows 2:4
    gives those rows of the whole batch's forward (the same masks), with
    and without ``remat_cnn``, whose backward replays the masks: the rows'
    gradients equal the plain network's."""
    from densefusion_tpu_torch.models import PoseNet
    from densefusion_tpu_torch.models.init import init_posenet_

    img = torch.from_numpy(rng.standard_normal((4, CROP, CROP, 3))
                           .astype(np.float32))
    pts = torch.from_numpy((0.05 * rng.standard_normal((4, N, 3)))
                           .astype(np.float32))
    choose = torch.from_numpy(rng.integers(0, CROP * CROP, (4, N)))
    obj = torch.tensor([0, 1, 1, 0])
    nets = []
    for flag in (False, remat):
        net = PoseNet(NUM_OBJ, remat_cnn=flag)
        init_posenet_(net, torch.Generator().manual_seed(0))
        nets.append(net.train())
    whole = nets[0](img, pts, choose, obj,
                    generator=torch.Generator().manual_seed(3))
    outs = []
    for net in nets:
        out = net(img[2:], pts[2:], choose[2:], obj[2:],
                  generator=torch.Generator().manual_seed(3),
                  batch_rows=(2, 4, 4))
        out["pred_t"].sum().backward()
        outs.append(out)
    for k in ("pred_r", "pred_t", "pred_c"):
        torch.testing.assert_close(outs[1][k], whole[k][2:], rtol=0, atol=0)
    for (name, p), q in zip(nets[0].named_parameters(),
                            nets[1].parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=0, atol=0,
                                   msg=name)


def test_dropout_batch_rows_draws_the_whole_batch(rng):
    """``Dropout2d(batch_rows=(2, 4, 8))`` on rows 2:4 keeps rows 2:4 of
    the whole batch's masks and leaves the generator where the whole
    batch's draw leaves it; without ``batch_rows`` nothing changes."""
    drop = Dropout2d(0.3).train()
    x = torch.from_numpy(rng.standard_normal((8, 6, 3, 3)).astype(np.float32))
    g_whole, g_rows = (torch.Generator().manual_seed(1) for _ in range(2))
    whole = drop(x, g_whole)
    rows = drop(x[2:4], g_rows, batch_rows=(2, 4, 8))
    assert torch.equal(rows, whole[2:4])
    assert torch.equal(g_rows.get_state(), g_whole.get_state())
    assert torch.equal(drop(x, torch.Generator().manual_seed(1),
                            batch_rows=(0, 8, 8)), whole)
    with pytest.raises(ValueError, match="batch_rows"):
        drop(x[2:4], g_rows, batch_rows=(2, 5, 8))


@pytest.mark.parametrize("workers,mode", [(0, "thread"), (2, "thread"),
                                          (2, "process")])
def test_sharded_loader_rows(dp_case, workers, mode):
    """``BatchLoader(shard=(rank, 4))`` in every worker mode: each rank's
    batch is its ceil(len / 4) rows of the one-process batch bit for bit;
    a last test batch of fewer than 4 samples pads the ranks past its end
    with invalid rows."""
    root = dp_case["inputs"]["trainer"]["dataset_root"]
    for mode_name, shuffle, drop_last in (("train", True, True),
                                          ("test", False, False)):
        ds = LineModDataset(root, mode_name, num_points=32, crop_size=32,
                            num_mesh_points=32, objlist=[1],
                            add_noise=mode_name == "train")
        whole = list(BatchLoader(ds, 4, shuffle=shuffle, drop_last=drop_last,
                                 num_workers=0, seed=3).epoch(1))
        for rank in range(WORLD):
            loader = BatchLoader(ds, 4, shuffle=shuffle, drop_last=drop_last,
                                 num_workers=workers, seed=3,
                                 worker_mode=mode, shard=(rank, WORLD))
            try:
                mine = list(loader.epoch(1))
            finally:
                loader.close()
            assert len(mine) == len(whole)
            for got, full in zip(mine, whole):
                per = -(-len(full.valid) // WORLD)
                rows = slice(rank * per, (rank + 1) * per)
                real = len(full.valid[rows])
                assert len(got.valid) == per
                for a, b in zip(got, full):
                    np.testing.assert_array_equal(a[:real], b[rows])
                assert not got.valid[real:].any()
