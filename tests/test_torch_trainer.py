"""The port's curriculum trainer (``densefusion_tpu_torch.train.Trainer``),
the counterparts of ``tests/test_curriculum.py``, ``tests/test_train.py``,
``tests/test_resume.py`` and ``tests/test_restart.py``, on a synthetic
one-object LineMOD root at the JAX fixture's sizes (N=64, mesh 64, 64 px
crops, B=2) on the CPU:

* the gates: the decay gate fires once with a fresh Adam at ``lr *
  lr_rate`` and ``w * w_rate``; the refine gate rebuilds the data at
  ``refine_mesh_points`` (old loaders closed) and moves Adam to the
  refiner; the best-checkpoint policy; an empty test split gives ``inf``
  and fires nothing;
* epochs of both phases, the STOP file, the RSS guard and a mid-epoch
  resume that replays the exact tail of the epoch's batches;
* the checkpoint sidecar guards against the JAX functions on the same
  files, warnings included; ``restart_env``;
* gradient accumulation: ``GradAccum`` against ``optax.MultiSteps(adam)``
  on the same gradients, and two micro-steps of one batch equal to one
  step.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from densefusion_tpu.train import checkpoint as jck
from densefusion_tpu.train.state import make_optimizer as j_make_optimizer
from densefusion_tpu_torch.data import (
    CADDataset, PoseSample, generate_cad_style_dataset,
    generate_linemod_style_dataset, to_device,
)
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
from densefusion_tpu_torch.train import (
    Curriculum, GradAccum, Trainer, checkpoint as ck, create_train_state,
    make_optimizer, make_refine_train_step,
)
from densefusion_tpu_torch.train import loop
from densefusion_tpu_torch.utils.config import RunConfig
from densefusion_tpu_torch.utils.restart import restart_env

from tests.torch_port_util import to_np


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_trainer"))
    generate_linemod_style_dataset(path, objlist=(1,), n_train=4, n_test=20,
                                   seed=9)
    return path


@pytest.fixture
def cfg(root, tmp_path):
    return RunConfig(
        dataset="linemod", dataset_root=root, num_objects=1, num_points=64,
        num_mesh_points=64, refine_mesh_points=64, crop_size=64,
        batch_size=2, num_workers=1, repeat_epoch=1, nepoch=1,
        refine_iters=2, out_dir=str(tmp_path / "out"),
        log_dir=str(tmp_path / "logs"), sym_list=(), seed=0,
        knn_backend="xla", checkpoint_every_steps=10**9, objlist=(1,))


class ScriptedTrainer(Trainer):
    """A real trainer (data, steps, optimizers) whose epochs are scripted:
    ``test_epoch`` returns the next distance, saves are recorded."""

    def __init__(self, cfg, script):
        super().__init__(cfg, device="cpu")
        self.script = list(script)
        self.saves, self.rebuilds = [], 0

    def train_epoch(self):
        return 0.0

    def test_epoch(self):
        return self.script.pop(0)

    def _save(self, tag):
        self.saves.append(tag)

    def _rebuild_steps(self):
        self.rebuilds += 1
        super()._rebuild_steps()


def test_decay_gate_fires_once_with_fresh_adam(cfg):
    tr = ScriptedTrainer(dataclasses.replace(cfg, nepoch=4),
                         [0.05, 0.025, 0.024, 0.026])
    tr.setup()
    first = tr.state.optimizer
    tr.run()
    cur = tr.curriculum
    assert cur.decay_started and not cur.refine_started
    assert cur.lr == pytest.approx(1e-5) and cur.w == pytest.approx(0.0015)
    assert tr.rebuilds == 2                      # setup + the gate, once
    opt = tr.state.optimizer
    assert opt is not first and not opt.state
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-5)
    assert {id(p) for p in opt.param_groups[0]["params"]} == \
        {id(p) for p in tr.posenet.parameters()}


def test_refine_gate_rebuilds_data_and_moves_adam(cfg):
    tr = ScriptedTrainer(dataclasses.replace(cfg, nepoch=4,
                                             refine_mesh_points=96),
                         [0.05, 0.019, 0.5, 0.4])
    tr.setup()
    old = tr.train_loader
    closed = []
    old.close = lambda: closed.append(True)
    assert tr.train_ds[0].model_points.shape == (64, 3)
    tr.run()
    cur = tr.curriculum
    assert cur.decay_started and cur.refine_started
    assert closed and tr.train_loader is not old
    assert tr.train_ds[0].model_points.shape == (96, 3)
    assert {id(p) for p in tr.state.optimizer.param_groups[0]["params"]} == \
        {id(p) for p in tr.refiner.parameters()}
    assert tr.state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)
    # best resets at the phase switch, so refiner checkpoints are saved
    assert tr.saves.count("best_pose") == 2 and "best_refine" in tr.saves


def test_best_checkpoint_policy(cfg):
    tr = ScriptedTrainer(dataclasses.replace(cfg, nepoch=4),
                         [0.5, 0.4, 0.45, 0.39])
    tr.setup()
    tr.run()
    assert tr.saves.count("best_pose") == 3      # epochs 1, 2 and 4
    assert tr.saves.count("current") == 4
    assert not tr.curriculum.decay_started


class _Empty:
    def __len__(self):
        return 0


def test_empty_test_split_gives_inf(cfg):
    def factory(c, mode, refine):
        return _Empty() if mode == "test" else loop.build_dataset(
            c, mode, refine)

    tr = Trainer(dataclasses.replace(cfg, decay_margin=10.0,
                                     refine_margin=10.0),
                 dataset_factory=factory, device="cpu")
    tr.setup()
    assert tr.test_epoch() == float("inf")
    tr.train_epoch = lambda: 0.0
    tr.run()
    cur = tr.curriculum
    assert cur.epoch == 2 and cur.best_test == float("inf")
    assert not (cur.decay_started or cur.refine_started)


def test_cad_dataset_refused(cfg, tmp_path):
    """The CAD branch is no longer refused: ``build_dataset`` gives the CAD
    reader with the phase's mesh size, the objlist and noise in train mode
    only. An unknown dataset is still refused."""
    root = str(tmp_path / "cad")
    generate_cad_style_dataset(root, n_train=2, n_test=10, seed=1)
    cad = dataclasses.replace(cfg, dataset="cad", dataset_root=root,
                              refine_mesh_points=96)
    for mode, refine, mesh, n in (("train", False, 64, 2),
                                  ("test", True, 96, 1)):
        ds = loop.build_dataset(cad, mode, refine)
        assert isinstance(ds, CADDataset) and len(ds) == n
        assert ds.num_mesh == mesh and ds.objlist == [1]
        assert ds.add_noise == (mode == "train")
    with pytest.raises(ValueError, match="unknown dataset"):
        loop.build_dataset(dataclasses.replace(cfg, dataset="fat"), "train",
                           False)


def test_epochs_of_both_phases(cfg):
    """A phase-1 epoch moves the PoseNet; after the switch a phase-2 epoch
    moves the refiner and leaves the PoseNet as it was."""
    tr = Trainer(cfg, device="cpu")
    tr.setup()
    assert np.isfinite(tr.train_epoch()) and tr.state.step == 2
    assert np.isfinite(tr.test_epoch())
    tr.curriculum.refine_started = True
    tr._build_data(refine=True)
    tr._rebuild_steps()
    pose = {k: v.clone() for k, v in tr.posenet.state_dict().items()}
    ref = {k: v.clone() for k, v in tr.refiner.state_dict().items()}
    assert np.isfinite(tr.train_epoch())
    assert tr.curriculum.refine_steps == 2
    for k, v in tr.posenet.state_dict().items():
        assert torch.equal(v, pose[k]), k
    assert any(not torch.equal(v, ref[k])
               for k, v in tr.refiner.state_dict().items())
    assert np.isfinite(tr.test_epoch())
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        kinds = [json.loads(ln)["kind"] for ln in f]
    assert kinds == ["train_epoch", "test_epoch"] * 2


def test_stop_file_ends_the_run(cfg):
    tr = Trainer(dataclasses.replace(cfg, nepoch=3), device="cpu")
    tr.setup()
    os.makedirs(cfg.out_dir, exist_ok=True)
    stop = os.path.join(cfg.out_dir, "STOP")
    open(stop, "w").close()
    tr.run()
    assert tr.curriculum.epoch == 2                # stopped after epoch 1
    assert not os.path.exists(stop)                # consumed
    assert os.path.isdir(os.path.join(cfg.out_dir, "checkpoint_current"))


def test_rss_guard_requests_restart(cfg, monkeypatch):
    monkeypatch.setattr(loop, "_rss_gb", lambda: 100.0)
    c = dataclasses.replace(cfg, nepoch=3, rss_restart_gb=1.0)
    tr = Trainer(c, device="cpu")
    tr.setup()
    tr.run()
    assert tr.restart_requested and tr.curriculum.epoch == 2
    current = os.path.join(c.out_dir, "checkpoint_current")
    tr2 = Trainer(dataclasses.replace(c, rss_restart_gb=0.0), device="cpu")
    tr2.setup(resume=current)
    assert tr2.curriculum.epoch == 2 and not tr2.restart_requested
    assert tr2.state.step == tr.state.step


class RecordingTrainer(Trainer):
    """Records every training batch's points."""

    seen: list

    def _rebuild_steps(self):
        super()._rebuild_steps()
        step = self.train_step

        def recorded(batch, w):
            self.seen.append(batch.points.clone())
            return step(batch, w)

        self.train_step = recorded


def test_mid_epoch_resume_replays_exact_tail(cfg, monkeypatch):
    """Two repetitions of two batches; the step-cadence save after the
    third step is followed by the RSS guard firing. The resumed trainer
    runs exactly the fourth batch. The uncut epoch only records its
    batches (the loader's order does not depend on the steps)."""
    c = dataclasses.replace(cfg, repeat_epoch=2)
    full = Trainer(c, device="cpu")
    full.setup()
    full_seen = []

    def record_only(batch, w):
        full_seen.append(batch.points.clone())
        return {"dis": torch.zeros(())}

    full.train_step = record_only
    full.train_epoch()
    assert len(full_seen) == 4

    monkeypatch.setattr(loop, "_rss_gb", lambda: 100.0)
    cut = RecordingTrainer(dataclasses.replace(
        c, checkpoint_every_steps=3, rss_restart_gb=1.0), device="cpu")
    cut.seen = []
    cut.setup()
    with pytest.raises(loop.RestartRequested):
        cut.train_epoch()
    saved = ck.peek_curriculum(os.path.join(c.out_dir, "checkpoint_current"))
    assert (saved.rep_in_epoch, saved.batch_in_epoch) == (1, 1)

    resumed = RecordingTrainer(c, device="cpu")
    resumed.seen = []
    resumed.setup(resume=os.path.join(c.out_dir, "checkpoint_current"))
    resumed.train_epoch()
    assert len(cut.seen) == 3 and len(resumed.seen) == 1
    for got, want in zip(cut.seen + resumed.seen, full_seen):
        assert torch.equal(got, want)
    assert resumed.state.step == 4


SIDECARS = {
    "phase1": Curriculum().to_dict(),
    "gate_flipped": Curriculum(refine_started=True).to_dict(),
    "trained_7": Curriculum(refine_started=True, refine_steps=7).to_dict(),
    "mature": Curriculum(refine_started=True,
                         refine_steps=ck.REFINE_MATURITY_STEPS).to_dict(),
    "no_counter": {k: v for k, v in Curriculum(
        refine_started=True).to_dict().items() if k != "refine_steps"},
    "future_key": {**Curriculum(refine_started=True,
                                refine_steps=3).to_dict(), "future": 1},
    "not_a_dict": [1, 2],
    "missing": None,
}


def _guards(module, path):
    out = {"trained": module.refiner_is_trained(path),
           "steps": module.refine_step_count(path)}
    for iters in (0, 4):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out[f"clamp_{iters}"] = module.clamp_refine_iters(path, iters)
        out[f"warn_{iters}"] = sorted(
            word for w in caught for word in ("UNTRAINED", "IMMATURE")
            if word in str(w.message))
    return out


@pytest.mark.parametrize("name", list(SIDECARS))
def test_sidecar_guards_match_jax(tmp_path, name):
    path = tmp_path / "ck"
    path.mkdir()
    if SIDECARS[name] is not None:
        (path / "curriculum.json").write_text(json.dumps(SIDECARS[name]))
    assert _guards(ck, str(path)) == _guards(jck, str(path))
    assert ck.REFINE_MATURITY_STEPS == jck.REFINE_MATURITY_STEPS


def test_restart_env_prepends_pkg_root():
    env = restart_env({"PYTHONPATH": "/some/other"})
    parts = env["PYTHONPATH"].split(os.pathsep)
    import densefusion_tpu_torch
    assert parts[0] == os.path.dirname(os.path.dirname(
        os.path.abspath(densefusion_tpu_torch.__file__)))
    assert "/some/other" in parts
    again = restart_env({"PYTHONPATH": env["PYTHONPATH"]})
    assert again["PYTHONPATH"] == env["PYTHONPATH"]


def test_reexeced_argv0_imports_package(tmp_path):
    """The restart runs the CLI module's file as a script from another
    directory under ``restart_env``: the import must succeed."""
    import densefusion_tpu_torch.cli.train as train_mod
    env = restart_env({k: v for k, v in os.environ.items()
                       if k != "PYTHONPATH"})
    proc = subprocess.run(
        [sys.executable, os.path.abspath(train_mod.__file__), "--help"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--rss_restart_gb" in proc.stdout


def test_grad_accum_matches_multisteps(rng):
    """``GradAccum(k=3)`` over torch Adam against ``optax.MultiSteps(adam,
    3)`` on the same six gradients: the running mean exactly (k=3, so a
    sum in its place shows before Adam's scale invariance hides it),
    parameters to rtol 1e-6 / atol 1e-9 after every micro-step, the
    counters."""
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32)
             for _ in range(6)]
    tx = optax.MultiSteps(j_make_optimizer(1e-3), every_k_schedule=3)
    jp = jnp.asarray(p0)
    jstate = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([tp], 1e-3)
    acc = GradAccum([tp], 3)
    for g in grads:
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        acc.step(opt)
        np.testing.assert_allclose(to_np(tp), np.asarray(jp), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_array_equal(to_np(acc.acc[0]),
                                      np.asarray(jstate.acc_grads))
        assert (acc.mini_step, acc.gradient_step) == (
            int(jstate.mini_step), int(jstate.gradient_step))


def _batch(rng, b=3, n=40, m=30, crop=32):
    model = rng.uniform(-0.05, 0.05, (b, m, 3))
    target = model + np.array([0.0, 0.0, 0.6])
    points = target[:, rng.integers(0, m, n)] \
        + 0.005 * rng.standard_normal((b, n, 3))
    return PoseSample(
        points=points.astype(np.float32),
        choose=rng.integers(0, crop * crop, (b, n)).astype(np.int32),
        img=rng.standard_normal((b, crop, crop, 3)).astype(np.float32),
        target=target.astype(np.float32), model_points=model.astype(
            np.float32), obj_idx=np.array([1, 0, 1], np.int32),
        sym=np.array([True, False, False]), valid=np.ones(b, bool))


def test_two_micro_steps_of_one_batch_are_one_step(rng):
    """Phase 2 is deterministic: two ``grad_accum=2`` micro-steps on the
    same batch apply the mean of two equal gradients, which is the
    gradient: bit for bit one plain step. The first micro-step moves
    nothing."""
    batch = to_device(_batch(rng), "cpu")
    states = [create_train_state(PoseNet(2), PoseRefineNet(2), 1e-3, 4,
                                 "cpu") for _ in range(2)]
    plain = make_refine_train_step(states[0], 2)
    accum = make_refine_train_step(states[1], 2, grad_accum=2)
    before = {k: v.clone() for k, v in states[1].refiner.state_dict().items()}
    accum(batch, 0.015)
    for k, v in states[1].refiner.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert states[1].accum.mini_step == 1
    accum(batch, 0.015)
    plain(batch, 0.015)
    assert (states[1].accum.mini_step, states[1].accum.gradient_step) == (0, 1)
    assert states[1].step == 2 and states[0].step == 1
    for (k, a), b in zip(states[1].refiner.state_dict().items(),
                         states[0].refiner.state_dict().values()):
        assert torch.equal(a, b), k
