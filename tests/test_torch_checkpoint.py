"""Port parity: checkpoints, the format both packages read.

A JAX ``Trainer`` on a synthetic one-object LineMOD root (the sizes of
``tests/test_train.py``: N=64, mesh 64, 64 px crops, B=2, ``knn_backend=
"xla"``; both packages' native libraries off, so their readers give the
numpy paths' samples) trains one phase-1 epoch and one phase-2 epoch and
saves a checkpoint after each; a third is a ``grad_accum=2`` (``optax.MultiSteps``)
checkpoint with random moments. Held here:

* the codec: a JAX ``state.msgpack`` re-encodes byte for byte; flax reads
  the port's bytes leaf for leaf; chunked arrays are refused;
* cross-loading, exact: every parameter, Adam moment and counter of a JAX
  checkpoint in the port after the layout transform, the curriculum and
  the config; the port's save read back by JAX's ``load_checkpoint(
  restore_opt=True)`` bit-identical, in each phase and with MultiSteps;
* the dropout generator's state and the JAX key through a save and load;
* resumed phase-2 training: the port's next epoch from the JAX phase-2
  checkpoint against the JAX trainer's (the refiner has no dropout and the
  loader gives JAX's order): refiner parameters and moments to the
  tolerance of ``tests/test_torch_train.py::test_phase2_step_matches_jax``,
  ``test_epoch`` to rel 1e-5; and again with both libraries on (each
  package's default), where the readers give exactly equal samples.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

import densefusion_tpu.native as jnative
import densefusion_tpu_torch.native as tnative
from densefusion_tpu.data import generate_linemod_style_dataset
from densefusion_tpu.train import Trainer as JTrainer
from densefusion_tpu.train import load_checkpoint as j_load_checkpoint
from densefusion_tpu.train import save_checkpoint as j_save_checkpoint
from densefusion_tpu.train.state import Curriculum as JCurriculum
from densefusion_tpu.train.state import TrainState as JTrainState
from densefusion_tpu.train.state import make_optimizer as j_make_optimizer
from densefusion_tpu.utils.config import RunConfig as JRunConfig
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.train import (
    Trainer, load_checkpoint, msgpack, peek_curriculum, save_checkpoint,
)
from densefusion_tpu_torch.utils.config import RunConfig

from tests.torch_port_util import to_np

LR = 1e-4


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _raw(path: str) -> dict:
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        return serialization.msgpack_restore(f.read())


def _assert_trees_equal(got: dict, want: dict, where: str):
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert set(got_l) == set(want_l), where
    for p, w in want_l.items():
        g = np.asarray(got_l[p])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, p)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {p}")


def _jax_run(tmp_path_factory, library: bool):
    """The JAX trainer's checkpoints (phase 1, phase 2, MultiSteps) and its
    next phase-2 epoch from the phase-2 one, with its native library on or
    (``library`` False) off."""
    with pytest.MonkeyPatch.context() as mp:
        if not library:
            mp.setattr(jnative, "_load", lambda: None)
        elif not jnative.available():
            pytest.skip("the JAX package's native library is not built here")
        root = str(tmp_path_factory.mktemp("lm_ck"))
        generate_linemod_style_dataset(root, objlist=(1,), n_train=4,
                                       n_test=20, seed=9)
        out = str(tmp_path_factory.mktemp("ck"))
        jcfg = JRunConfig(
            dataset="linemod", dataset_root=root, num_objects=1,
            num_points=64, num_mesh_points=64, refine_mesh_points=64,
            crop_size=64, batch_size=2, num_workers=1, repeat_epoch=1,
            nepoch=1, refine_iters=2, out_dir=os.path.join(out, "jax"),
            log_dir=os.path.join(out, "jax_logs"), sym_list=(), seed=0,
            knn_backend="xla", checkpoint_every_steps=10**9, objlist=(1,))
        jt = JTrainer(jcfg)
        jt.setup()
        jt.train_epoch()
        paths = {k: os.path.join(out, k)
                 for k in ("phase1", "phase2", "accum2")}
        j_save_checkpoint(paths["phase1"], jt.state, jt.curriculum, jcfg)

        # a MultiSteps(k=2) checkpoint: phase-1 params, random moments and
        # accumulated gradients, mid-accumulation counters
        rng = np.random.default_rng(3)
        raw1 = _raw(paths["phase1"])
        tx = optax.MultiSteps(j_make_optimizer(LR), every_k_schedule=2)
        ms = tx.init(raw1["params_pose"])
        ms = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
            if x.dtype == jnp.float32 else np.asarray(x), ms)
        ms = ms._replace(mini_step=np.int32(1), gradient_step=np.int32(5),
                         inner_opt_state=(ms.inner_opt_state[0]._replace(
                             count=np.int32(5)), ms.inner_opt_state[1]))
        j_save_checkpoint(paths["accum2"], JTrainState(
            step=np.int32(11), params_pose=raw1["params_pose"],
            params_refine=raw1["params_refine"], opt_state=ms,
            rng=jax.random.key(7)),
            JCurriculum(epoch=2, batch_in_epoch=1),
            dataclasses.replace(jcfg, grad_accum=2))

        jt.curriculum.refine_started = True
        jt._build_data(refine=True)
        jt._rebuild_steps(reset_opt=True)
        jt.train_epoch()
        j_save_checkpoint(paths["phase2"], jt.state, jt.curriculum, jcfg)
        test_before = jt.test_epoch()
        jt.train_epoch()
        after = {"params_refine": jax.tree.map(np.array,
                                               jt.state.params_refine),
                 "mu": jax.tree.map(np.array, jt.state.opt_state[0].mu),
                 "nu": jax.tree.map(np.array, jt.state.opt_state[0].nu)}
        test_after = jt.test_epoch()
        jt.close()
        return {"jcfg": jcfg, "paths": paths, "out": out,
                "jax_next": after, "jax_test_before": test_before,
                "jax_test_after": test_after}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX run with its native library off."""
    return _jax_run(tmp_path_factory, library=False)


@pytest.fixture(scope="module")
def run_with_library(tmp_path_factory):
    """The JAX run with its native library on."""
    return _jax_run(tmp_path_factory, library=True)


def _port_cfg(run, **kw) -> RunConfig:
    cfg = RunConfig.from_json(run["jcfg"].to_json())
    return dataclasses.replace(
        cfg, out_dir=os.path.join(run["out"], "port"),
        log_dir=os.path.join(run["out"], "port_logs"), **kw)


def _port_trainer(run, ck: str, **kw) -> Trainer:
    tr = Trainer(_port_cfg(run, **kw), device="cpu")
    tr.setup(resume=ck)
    return tr


def _j_template(raw: dict, kind: str, accum: int = 1) -> JTrainState:
    """A JAX template for ``load_checkpoint``: the structures of a phase
    (and of MultiSteps), leaves from ``raw``."""
    tx = j_make_optimizer(LR)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    return JTrainState(step=jnp.zeros((), jnp.int32),
                       params_pose=raw["params_pose"],
                       params_refine=raw["params_refine"],
                       opt_state=tx.init(raw[f"params_{kind}"]),
                       rng=jax.random.key(0))


@pytest.mark.parametrize("name", ["phase1", "phase2", "accum2"])
def test_codec_reencodes_jax_bytes(run, name):
    with open(os.path.join(run["paths"][name], "state.msgpack"), "rb") as f:
        data = f.read()
    tree = msgpack.unpack(data)
    assert msgpack.pack(tree) == data
    assert list(tree) == ["step", "params_pose", "params_refine",
                          "opt_state", "rng"]


def test_flax_reads_port_bytes(run, tmp_path):
    tr = _port_trainer(run, run["paths"]["phase2"])
    path = str(tmp_path / "ck")
    save_checkpoint(path, tr.state, tr.curriculum, tr.cfg)
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        data = f.read()
    port_tree = msgpack.unpack(data)
    flax_tree = serialization.msgpack_restore(data)
    jax_raw = _raw(run["paths"]["phase2"])
    for key in ("params_pose", "params_refine", "opt_state"):
        assert [p for p, _ in _leaves(port_tree[key])] == \
            [p for p, _ in _leaves(jax_raw[key])], key
    assert [p for p, _ in _leaves(flax_tree)] == \
        [p for p, _ in _leaves(port_tree)]
    _assert_trees_equal(flax_tree, port_tree, "flax vs port decode")
    # the port writes flax's key order: the bytes of a JAX save of the same
    # tree, but for the extra torch_generator key
    jax_tree = {k: v for k, v in port_tree.items() if k != "torch_generator"}
    assert serialization.msgpack_serialize(jax_tree, in_place=True) == \
        msgpack.pack(jax_tree)


def test_chunked_arrays_refused(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(
        {"a": np.arange(100, dtype=np.float32)})
    with pytest.raises(msgpack.MsgpackError, match="chunked"):
        msgpack.unpack(data)
    monkeypatch.setattr(msgpack, "MAX_ARRAY_BYTES", 64)
    with pytest.raises(msgpack.MsgpackError, match="chunked"):
        msgpack.pack({"a": np.arange(100, dtype=np.float32)})


@pytest.mark.parametrize("name,kind,accum", [("phase1", "pose", 1),
                                              ("phase2", "refine", 1),
                                              ("accum2", "pose", 2)])
def test_cross_load_exact(run, tmp_path, name, kind, accum):
    """JAX -> port: every leaf exact after the layout transform; port ->
    JAX: ``load_checkpoint(restore_opt=True)`` gives every leaf back."""
    ck = run["paths"][name]
    raw = _raw(ck)
    tr = _port_trainer(run, ck, grad_accum=accum)
    state = tr.state
    for key, module, to_torch in (
            ("params_pose", state.posenet,
             compat.posenet_state_dict_from_flax),
            ("params_refine", state.refiner,
             compat.refiner_state_dict_from_flax)):
        want = to_torch(raw[key])
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(to_np(v), want[k].numpy(), k)
    module = state.posenet if kind == "pose" else state.refiner
    opt = raw["opt_state"]["inner_opt_state"] if accum > 1 \
        else raw["opt_state"]
    to_torch = (compat.posenet_state_dict_from_flax if kind == "pose"
                else compat.refiner_state_dict_from_flax)
    mu, nu = to_torch(opt["0"]["mu"]), to_torch(opt["0"]["nu"])
    for k, p in module.named_parameters():
        st = state.optimizer.state[p]
        np.testing.assert_array_equal(to_np(st["exp_avg"]), mu[k].numpy())
        np.testing.assert_array_equal(to_np(st["exp_avg_sq"]), nu[k].numpy())
        assert float(st["step"]) == int(opt["0"]["count"])
    if accum > 1:
        acc = to_torch(raw["opt_state"]["acc_grads"])
        for a, (k, _) in zip(state.accum.acc, module.named_parameters()):
            np.testing.assert_array_equal(to_np(a), acc[k].numpy())
        assert (state.accum.mini_step, state.accum.gradient_step) == (1, 5)
    assert state.step == int(raw["step"])
    with open(os.path.join(ck, "curriculum.json")) as f:
        assert tr.curriculum.to_dict() == json.load(f)
    with open(os.path.join(ck, "config.json")) as f:
        want_cfg = json.load(f)
    assert dataclasses.asdict(RunConfig.from_json(json.dumps(want_cfg))) == \
        {**want_cfg, "sym_list": tuple(want_cfg["sym_list"]),
         "objlist": tuple(want_cfg["objlist"])}

    path = str(tmp_path / "port")
    save_checkpoint(path, state, tr.curriculum, tr.cfg)
    loaded, cur, cfg_json = j_load_checkpoint(
        path, _j_template(raw, kind, accum), restore_opt=True)
    loaded = loaded.replace(rng=jax.random.key_data(loaded.rng))
    got = serialization.to_state_dict(jax.device_get(loaded))
    _assert_trees_equal(got, raw, f"{name}: port save -> JAX load")
    assert cur.to_dict() == tr.curriculum.to_dict()
    assert json.loads(cfg_json) == json.loads(tr.cfg.to_json())


def test_phase_mismatch_raises(run):
    tr = Trainer(_port_cfg(run), device="cpu")
    tr.setup()                                   # a phase-1 optimizer
    with pytest.raises(ValueError, match="peek_curriculum"):
        load_checkpoint(run["paths"]["phase2"], tr.state, restore_opt=True)
    state, cur, _ = load_checkpoint(run["paths"]["phase2"], tr.state,
                                    restore_opt=False)
    assert cur.refine_started and peek_curriculum(
        run["paths"]["phase2"]).refine_steps == 2
    want = compat.refiner_state_dict_from_flax(
        _raw(run["paths"]["phase2"])["params_refine"])
    for k, v in state.refiner.state_dict().items():
        np.testing.assert_array_equal(to_np(v), want[k].numpy())


def test_generator_and_key_round_trip(run, tmp_path):
    """A JAX checkpoint has no generator state: the port seeds it from the
    key; a port save keeps the generator's state and the key exactly."""
    ck = run["paths"]["phase1"]
    hi, lo = (int(x) for x in _raw(ck)["rng"])
    tr = _port_trainer(run, ck)
    assert torch.equal(tr.state.generator.get_state(),
                       torch.Generator().manual_seed(
                           (hi << 32 | lo) + 1).get_state())
    torch.rand(5, generator=tr.state.generator)   # move it on
    path = str(tmp_path / "gen")
    save_checkpoint(path, tr.state, tr.curriculum, tr.cfg)
    tr2 = _port_trainer(run, path)
    assert torch.equal(tr2.state.generator.get_state(),
                       tr.state.generator.get_state())
    np.testing.assert_array_equal(tr2.state.rng_key, [hi, lo])
    assert "torch_generator" in msgpack.unpack(
        open(os.path.join(path, "state.msgpack"), "rb").read())


def _resumed_phase2_epoch_matches_jax(run):
    """From the JAX phase-2 checkpoint both trainers run their next epoch
    on the same batches. Refiner gradients read from Adam's moments to
    1e-4 of each tensor's largest; parameters to atol 1e-6 where the first
    moment is above 1e-4 of its largest, elsewhere within the two steps'
    reach (2 lr: Adam's update of a rounding-noise gradient is any value
    in [-lr, lr]); ``test_epoch`` to rel 1e-5 before and after."""
    tr = _port_trainer(run, run["paths"]["phase2"])
    assert tr.state.optimizer.param_groups[0]["lr"] == pytest.approx(LR)
    np.testing.assert_allclose(tr.test_epoch(), run["jax_test_before"],
                               rtol=1e-5)
    before = {k: to_np(v).copy() for k, v in
              tr.state.refiner.state_dict().items()}
    tr.train_epoch()
    nxt = run["jax_next"]
    want_p = compat.refiner_state_dict_from_flax(nxt["params_refine"])
    want_mu = compat.refiner_state_dict_from_flax(nxt["mu"])
    want_nu = compat.refiner_state_dict_from_flax(nxt["nu"])
    for k, p in tr.state.refiner.named_parameters():
        st = tr.state.optimizer.state[p]
        for got, want in ((st["exp_avg"], want_mu[k]),
                          (st["exp_avg_sq"], want_nu[k])):
            w = want.numpy()
            assert np.abs(to_np(got) - w).max() <= 1e-4 * np.abs(w).max(), k
        mu = want_mu[k].numpy()
        clear = np.abs(mu) > 1e-4 * np.abs(mu).max()
        got, want = to_np(p), want_p[k].numpy()
        np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert np.abs(got - before[k]).max() <= 2 * LR + 1e-6, k
        assert float(st["step"]) == 4
    assert tr.state.step == 6 and tr.curriculum.refine_steps == 4
    np.testing.assert_allclose(tr.test_epoch(), run["jax_test_after"],
                               rtol=1e-5)


def test_resumed_phase2_epoch_matches_jax(run, monkeypatch):
    """Both libraries off: the numpy paths' batches."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    _resumed_phase2_epoch_matches_jax(run)


def test_resumed_phase2_epoch_matches_jax_with_library(run_with_library):
    """Both libraries on: the readers' samples exactly equal."""
    _resumed_phase2_epoch_matches_jax(run_with_library)
