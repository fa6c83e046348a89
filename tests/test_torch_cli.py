"""The port's CLIs against the JAX package's, on the CPU:

* ``cli.train``'s parser has the JAX parser's options and defaults (plus
  ``--device``); the option the port lacks raises ``NotImplementedError``
  naming its ROADMAP.md section, ``--bf16`` / ``--remat_cnn`` train, and
  ``--data_parallel`` trains on 2 spawned gloo ranks;
  one epoch writes a checkpoint that the JAX package's
  ``load_checkpoint(restore_opt=True)`` restores into the structures its
  own ``PoseNet`` / ``PoseRefineNet`` / Adam have;
* ``cli.eval_linemod`` on a JAX-written checkpoint (weights from a numpy
  seed, a synthetic two-object LineMOD root with the symmetric eggbox):
  per-frame refined distances and per-object per-pixel means equal to the
  JAX ``InferencePipeline`` + ``pose_distances`` on the same samples within
  1e-5, with and without native crops;
* ``PoseEstimator.from_checkpoint`` against the JAX one on that checkpoint
  (atol 1e-4), and its clamp to 0 iterations on a phase-1 checkpoint.
"""

import json
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from densefusion_tpu.cli import eval_linemod as j_eval_cli
from densefusion_tpu.cli import train as j_train_cli
from densefusion_tpu.data import PoseSample as JPoseSample
from densefusion_tpu.data import collate as j_collate
from densefusion_tpu.eval import InferencePipeline as JPipeline
from densefusion_tpu.eval import pose_distances as j_pose_distances
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.serve import PoseEstimator as JPoseEstimator
from densefusion_tpu.train import load_checkpoint as j_load_checkpoint
from densefusion_tpu.train import save_checkpoint as j_save_checkpoint
from densefusion_tpu.train.state import Curriculum as JCurriculum
from densefusion_tpu.train.state import TrainState as JTrainState
from densefusion_tpu.train.state import make_optimizer as j_make_optimizer
from densefusion_tpu.utils.config import RunConfig as JRunConfig
from densefusion_tpu_torch.cli import eval_linemod, train
from densefusion_tpu_torch.data import (
    LineModDataset, generate_linemod_style_dataset,
)
from densefusion_tpu_torch.serve import PoseEstimator

from tests.torch_port_util import EMB, init_params

OBJLIST = (1, 10)          # 10 = eggbox, symmetric: the ADD-S branch
N, CROP = 64, 64


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_cli"))
    generate_linemod_style_dataset(path, objlist=OBJLIST, n_train=4,
                                   n_test=20, seed=9)
    return path


@pytest.fixture(scope="module")
def jax_ck(tmp_path_factory):
    """A JAX-written phase-2 checkpoint (mature refiner counter, refine
    depth 2) with weights from a numpy seed: JAX's parameter structures
    from ``jax.eval_shape``, every leaf drawn, confidences widened so the
    argmax hypothesis is clear."""
    rng = np.random.default_rng(11)
    nobj = len(OBJLIST)
    img = jnp.zeros((1, CROP, CROP, 3))
    pts = jnp.zeros((1, N, 3))
    obj = jnp.zeros((1,), jnp.int32)
    pose = init_params(JPoseNet(num_obj=nobj), rng, img, pts,
                       jnp.zeros((1, N), jnp.int32), obj, conf_scale=8.0)
    ref = init_params(JRefiner(num_obj=nobj), rng, pts,
                      jnp.zeros((1, N, EMB)), obj)
    path = str(tmp_path_factory.mktemp("jax_ck") / "checkpoint_best_refine")
    cfg = JRunConfig.preset("linemod", num_objects=nobj, objlist=OBJLIST,
                            refine_iters=2)
    j_save_checkpoint(path, JTrainState(
        step=jnp.int32(30000), params_pose=pose, params_refine=ref,
        opt_state=j_make_optimizer(1e-4).init(ref), rng=jax.random.key(0)),
        JCurriculum(refine_started=True, refine_steps=20000), cfg)
    return {"path": path, "pose": pose, "ref": ref}


def _parser_spec(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["train", "eval_linemod"])
def test_parsers_match_jax(name):
    port, jax_cli = {"train": (train, j_train_cli),
                     "eval_linemod": (eval_linemod, j_eval_cli)}[name]
    got = _parser_spec(port.build_parser())
    want = _parser_spec(jax_cli.build_parser())
    assert got.pop("device")[1] is None
    assert got == want


@pytest.mark.parametrize("flags,section", [
    pytest.param(["--trace_dir", "x"], "§1 G", id="flags1-§1 G")])
def test_unported_options_raise(root, tmp_path, flags, section):
    with pytest.raises(NotImplementedError, match=section):
        train.main(["--dataset_root", root, "--out_dir", str(tmp_path),
                    "--device", "cpu", *flags])


def test_data_parallel_runs(root, tmp_path):
    """``--data_parallel --device cpu`` (ROADMAP.md §1 D, refused until it
    was ported) on 2 spawned ranks whose gloo group comes from a launcher's
    environment alone (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets): one epoch of the global batch
    of 4, 2 rows a rank; both ranks end with the same parameters, rank 0
    alone writes, and its checkpoint loads into the port's networks."""
    from densefusion_tpu_torch.models import PoseNet
    from densefusion_tpu_torch.train import load_state_dicts

    from tests import torch_dist_worker

    out = str(tmp_path / "out")
    argv = ["--dataset", "linemod", "--dataset_root", root, "--objlist", "1",
            "10", "--nepoch", "1", "--repeat_epoch", "1", "--batch_size", "4",
            "--workers", "1", "--crop_size", "32", "--num_points", "32",
            "--out_dir", out, "--log_dir", str(tmp_path / "logs"),
            "--device", "cpu", "--data_parallel"]
    ranks = torch_dist_worker.spawn("cli", {"argv": argv},
                                    torch_dist_worker.launcher_env(2), 2, 180)
    assert [r["epoch"] for r in ranks] == [2, 2]
    assert [r["writer"] for r in ranks] == [True, False]
    assert [r["batch_rows"] for r in ranks] == [2, 2]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    pose, _ = load_state_dicts(os.path.join(out, "linemod",
                                            "checkpoint_current"))
    PoseNet(num_obj=2).load_state_dict(pose, strict=True)


def test_data_parallel_batch_must_split(root, tmp_path):
    """A global batch that the ranks do not divide is refused before any
    work."""
    from densefusion_tpu_torch.parallel.sharding import BatchSharding
    from densefusion_tpu_torch.train import Trainer
    from densefusion_tpu_torch.utils.config import RunConfig

    def shard(batch):
        return batch

    shard.sharding = BatchSharding(group=None, size=3, index=0)
    cfg = RunConfig.preset("linemod", dataset_root=root, batch_size=4,
                           log_dir=str(tmp_path))
    with pytest.raises(ValueError, match="does not split over 3"):
        Trainer(cfg, device="cpu", shard_batch=shard)


@pytest.mark.parametrize("flags,section", [
    (["--bf16"], "§1 E"), (["--remat_cnn"], "§1 E")])
def test_precision_options_run(root, tmp_path, flags, section):
    """``--bf16`` and ``--remat_cnn`` (ROADMAP.md ``section``, refused
    until it was ported) train one epoch: the config records them, the
    networks run them, and the checkpoint holds float32 parameters that
    the port loads back."""
    import torch

    from densefusion_tpu_torch.train import load_state_dicts

    out = str(tmp_path / "out")
    tr = train.main([
        "--dataset", "linemod", "--dataset_root", root, "--objlist", "1",
        "10", "--nepoch", "1", "--repeat_epoch", "1", "--batch_size", "2",
        "--workers", "1", "--crop_size", "32", "--num_points", "32",
        "--out_dir", out, "--log_dir", str(tmp_path / "logs"),
        "--device", "cpu", *flags])
    assert tr.curriculum.epoch == 2
    assert tr.cfg.bf16_compute == ("--bf16" in flags)
    assert tr.cfg.remat_cnn == ("--remat_cnn" in flags)
    assert tr.posenet.feat.dtype == (torch.bfloat16 if "--bf16" in flags
                                     else None)
    assert tr.posenet.remat_cnn == ("--remat_cnn" in flags)
    pose, ref = load_state_dicts(os.path.join(out, "linemod",
                                              "checkpoint_current"))
    assert all(v.dtype == torch.float32 for v in {**pose, **ref}.values())
    tr.posenet.load_state_dict(pose, strict=True)


def test_train_cli_checkpoint_loads_in_jax(root, tmp_path):
    out = str(tmp_path / "out")
    tr = train.main([
        "--dataset", "linemod", "--dataset_root", root, "--objlist", "1",
        "10", "--nepoch", "1", "--repeat_epoch", "1", "--batch_size", "2",
        "--workers", "1", "--crop_size", str(CROP), "--num_points", str(N),
        "--out_dir", out, "--log_dir", str(tmp_path / "logs"),
        "--device", "cpu"])
    assert tr.cfg.sym_list == (1,) and tr.curriculum.epoch == 2
    path = os.path.join(out, "linemod", "checkpoint_current")
    assert os.path.isdir(os.path.join(out, "linemod", "checkpoint_best_pose"))
    nobj = len(OBJLIST)
    img, pts = jnp.zeros((1, CROP, CROP, 3)), jnp.zeros((1, N, 3))
    obj = jnp.zeros((1,), jnp.int32)
    shapes_pose = jax.eval_shape(JPoseNet(num_obj=nobj).init,
                                 jax.random.key(0), img, pts,
                                 jnp.zeros((1, N), jnp.int32), obj)
    shapes_ref = jax.eval_shape(JRefiner(num_obj=nobj).init,
                                jax.random.key(0), pts,
                                jnp.zeros((1, N, EMB)), obj)
    template = JTrainState(
        step=jnp.zeros((), jnp.int32), params_pose=shapes_pose,
        params_refine=shapes_ref,
        opt_state=jax.eval_shape(j_make_optimizer(1e-4).init, shapes_pose),
        rng=jax.random.key(0))
    state, cur, cfg_json = j_load_checkpoint(path, template,
                                             restore_opt=True)
    assert jax.tree.structure(state.opt_state) == \
        jax.tree.structure(template.opt_state)
    for got, want in ((state.params_pose, shapes_pose),
                      (state.params_refine, shapes_ref),
                      (state.opt_state, template.opt_state)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert (g.shape, g.dtype) == (w.shape, w.dtype)
    assert int(state.step) == 4 and cur.epoch == 2   # 8 samples, B=2
    assert json.loads(cfg_json)["objlist"] == list(OBJLIST)


def _jax_distances(jax_ck, samples):
    """The JAX pipeline (K=2, unrefined too) and ``pose_distances`` on
    ``samples``, one batch per crop shape -> [(dis0, dis)]."""
    pipe = JPipeline(JPoseNet(num_obj=len(OBJLIST)),
                     JRefiner(num_obj=len(OBJLIST)), refine_iters=2,
                     return_unrefined=True)
    out = [None] * len(samples)
    shapes = {}
    for i, s in enumerate(samples):
        shapes.setdefault(s.img.shape, []).append(i)
    for idx in shapes.values():
        b = j_collate([JPoseSample(*samples[i]) for i in idx])
        q0, t0, q, t, _ = pipe(jax_ck["pose"], jax_ck["ref"], b.img,
                               b.points, b.choose, b.obj_idx)
        d0 = j_pose_distances(b.model_points, q0, t0, b.target, b.sym)
        d = j_pose_distances(b.model_points, q, t, b.target, b.sym)
        for k, i in enumerate(idx):
            out[i] = (float(d0[k]), float(d[k]))
    return out


@pytest.mark.parametrize("native", ["off", "on"])
def test_eval_linemod_matches_jax(root, jax_ck, tmp_path, native):
    out = str(tmp_path / "eval")
    eval_linemod.main([
        "--dataset_root", root, "--checkpoint", jax_ck["path"],
        "--objlist", *map(str, OBJLIST), "--num_points", str(N),
        "--crop_size", str(CROP), "--mode", "test", "--output_dir", out,
        "--native_crops", native, "--device", "cpu"])
    ds = LineModDataset(root, mode="test", num_points=N, crop_size=CROP,
                        objlist=list(OBJLIST), native_crop=native == "on")
    samples = [ds[i] for i in range(len(ds))]
    assert all(s.valid for s in samples) and any(s.sym for s in samples)
    if native == "on":
        assert len({s.img.shape for s in samples}) > 1
    want = _jax_distances(jax_ck, samples)
    with open(os.path.join(out, "eval_result_logs.txt")) as f:
        got = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
            r"No\.(\d+) (?:NOT )?Pass! Distance: ([0-9.]+)", f.read())}
    assert sorted(got) == list(range(len(samples)))
    for i, (_, d) in enumerate(want):
        assert abs(got[i] - d) <= 1e-5, (i, got[i], d)
    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    assert set(result) == {"rate_per_pixel", "rate_refined",
                           "lost_detections", "iterations", "native_crops",
                           "per_object"}
    assert result["iterations"] == 2 and result["native_crops"] == (
        native == "on")
    for k, entry in enumerate(result["per_object"]):
        rows = [w for s, w in zip(samples, want) if int(s.obj_idx) == k]
        assert entry["count"] == len(rows) > 0
        assert abs(entry["mean_dist_per_pixel"]
                   - np.mean([r[0] for r in rows])) <= 1e-5
        assert 0.0 <= entry["rate_refined"] <= 1.0


def test_from_checkpoint_matches_jax(root, jax_ck):
    ds = LineModDataset(root, mode="test", num_points=N, crop_size=CROP,
                        objlist=list(OBJLIST))
    samples = [ds[i] for i in range(len(ds))]
    est = PoseEstimator.from_checkpoint(jax_ck["path"], len(OBJLIST),
                                        num_points=N, crop_size=CROP,
                                        device="cpu")
    jest = JPoseEstimator.from_checkpoint(jax_ck["path"], len(OBJLIST),
                                          num_points=N, crop_size=CROP)
    assert est.pipeline.refine_iters == jest.pipeline.refine_iters == 2
    got = est.estimate_batch(samples)
    want = jest.estimate_batch([JPoseSample(*s) for s in samples])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)


def test_from_checkpoint_bf16(root, jax_ck):
    """``from_checkpoint(bf16=True)`` serves with bf16 compute on the
    checkpoint's float32 weights: float32 poses, near the float32
    estimator's by the JAX package's bf16 criterion (``tests/test_bf16.py``:
    max difference below 0.5)."""
    import torch

    ds = LineModDataset(root, mode="test", num_points=N, crop_size=CROP,
                        objlist=list(OBJLIST))
    samples = [ds[i] for i in range(4)]
    kw = dict(num_points=N, crop_size=CROP, device="cpu")
    est = PoseEstimator.from_checkpoint(jax_ck["path"], len(OBJLIST),
                                        bf16=True, **kw)
    est32 = PoseEstimator.from_checkpoint(jax_ck["path"], len(OBJLIST), **kw)
    pipe = est.pipeline
    assert pipe.posenet.feat.dtype == pipe.refiner.feat.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pipe.posenet.parameters())
    got, want = est.estimate_batch(samples), est32.estimate_batch(samples)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        assert np.abs(g - w).max() < 0.5
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=1), 1.0,
                               atol=1e-5)


def test_from_checkpoint_clamps_a_phase1_checkpoint(jax_ck, tmp_path):
    path = tmp_path / "phase1"
    path.mkdir()
    os.symlink(os.path.join(jax_ck["path"], "state.msgpack"),
               path / "state.msgpack")
    (path / "curriculum.json").write_text(
        json.dumps(JCurriculum().to_dict()))
    with pytest.warns(UserWarning, match="UNTRAINED"):
        est = PoseEstimator.from_checkpoint(str(path), len(OBJLIST),
                                            num_points=N, crop_size=CROP,
                                            device="cpu")
    assert est.pipeline.refine_iters == 0


def test_entry_points_need_cuda_or_cpu(root, jax_ck, tmp_path):
    """Without a card every new entry point raises unless given the CPU;
    ``knn_backend="xla"`` is refused on CUDA before anything runs."""
    import torch

    from densefusion_tpu_torch.cli.benchmark import (
        bench_refine_step, bench_train_step,
    )
    from densefusion_tpu_torch.train import Trainer
    from densefusion_tpu_torch.utils.config import RunConfig

    cfg = RunConfig.preset("linemod", dataset_root=root, objlist=(1,),
                           num_objects=1, out_dir=str(tmp_path / "o"),
                           log_dir=str(tmp_path / "l"))
    with pytest.raises(NotImplementedError, match="Rules of the port"):
        Trainer(RunConfig(knn_backend="xla"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: Trainer(cfg), bench_train_step, bench_refine_step,
                 lambda: PoseEstimator.from_checkpoint(jax_ck["path"], 2),
                 lambda: train.main(["--dataset_root", root, "--objlist",
                                     "1", "--out_dir", str(tmp_path)]),
                 lambda: eval_linemod.main(["--dataset_root", root,
                                            "--checkpoint", jax_ck["path"],
                                            "--output_dir",
                                            str(tmp_path / "e")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("what", ["train", "refine"])
def test_bench_steps_on_cpu(what):
    """The train-step benchmarks run on the CPU at a small batch and give
    the JAX benchmark's keys, plus the device and dtype."""
    from densefusion_tpu_torch.cli.benchmark import (
        bench_refine_step, bench_train_step,
    )
    fn = {"train": bench_train_step, "refine": bench_refine_step}[what]
    out = fn(batch=1, repeats=1, device="cpu")
    keys = {"train": {"train_batch", "train_ms_per_step",
                      "train_frames_per_s"},
            "refine": {"refine_batch", "refine_mesh_points",
                       "refine_ms_per_step", "refine_frames_per_s"}}[what]
    assert set(out) == keys | {"dtype", "device"}
    assert out["device"] == "cpu" and np.isfinite(out[f"{what}_ms_per_step"])
