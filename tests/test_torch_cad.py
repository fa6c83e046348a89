"""Port parity: the customCAD path (``densefusion_tpu_torch.data.cad``, the
CAD generator, ``cli.cad_prep``, ``cli.inspect_sample``, ``cli.train
--dataset cad`` and ``cli.eval_cad``) against ``densefusion_tpu``, on the
CPU at the Unity frame size (520x1109):

* the generators write the same files for one seed (PNG pixels and the
  text files equal), with and without the hole augmentation;
* ``CADDataset`` in train and test mode gives the JAX reader's samples,
  every field exact, with both native libraries on (each package's
  default) and with both off; the ray map, the depth linearization and the
  quaternion conventions equal;
* ``cad_prep`` writes the JAX masks and split; ``inspect_sample`` writes
  the JAX PLY files for ``cad``, ``ycb`` and ``linemod``;
* one ``cli.train --dataset cad`` epoch writes a checkpoint that the JAX
  ``load_checkpoint(restore_opt=True)`` restores;
* ``cli.eval_cad`` has the JAX parser's options plus ``--device``, and on a
  JAX-written checkpoint gives the JAX CLI's success rate, per-frame
  distances within 1e-4 and the same PLY dumps.
"""

import filecmp
import os
import re
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import densefusion_tpu.native as jnative
import densefusion_tpu_torch.native as tnative
from densefusion_tpu.cli import cad_prep as j_cad_prep
from densefusion_tpu.cli import eval_cad as j_eval_cad
from densefusion_tpu.cli import inspect_sample as j_inspect
from densefusion_tpu.data import cad as jcad
from densefusion_tpu.data import synthetic as jsynthetic
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.train import load_checkpoint as j_load_checkpoint
from densefusion_tpu.train.state import TrainState as JTrainState
from densefusion_tpu.train.state import make_optimizer as j_make_optimizer
from densefusion_tpu.utils.config import RunConfig as JRunConfig
from densefusion_tpu_torch.cli import (
    cad_prep, eval_cad, inspect_sample, train,
)
from densefusion_tpu_torch.data import LINEMOD_OBJLIST, cad, synthetic

from tests.test_torch_data import assert_samples_equal
from tests.torch_port_util import EMB, save_jax_checkpoint

N, CROP = 64, 64
KW = dict(num_points=N, crop_size=CROP, num_mesh_points=N)


@pytest.fixture
def no_library(monkeypatch):
    """Both packages' numpy paths: neither native library is found."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)


@pytest.fixture
def with_library():
    """Both packages' default paths, through their native libraries."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built here")
    assert tnative.available()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root): one seed through both generators, 4 training
    and 50 test frames (the test split keeps 5)."""
    out = []
    for gen in (jsynthetic, synthetic):
        root = str(tmp_path_factory.mktemp("cad"))
        gen.generate_cad_style_dataset(root, n_train=4, n_test=50,
                                       img_h=520, img_w=1109, seed=3)
        out.append(root)
    return tuple(out)


def _assert_trees_equal(jroot, troot):
    from PIL import Image
    n = 0
    for dirpath, dirnames, files in os.walk(jroot):
        rel = os.path.relpath(dirpath, jroot)
        assert sorted(os.listdir(os.path.join(troot, rel))) == \
            sorted(files + dirnames), rel
        for f in files:
            a, b = os.path.join(dirpath, f), os.path.join(troot, rel, f)
            if f.endswith(".png"):
                x, y = np.array(Image.open(a)), np.array(Image.open(b))
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=a)
            else:
                assert filecmp.cmp(a, b, shallow=False), a
            n += 1
    return n


@pytest.mark.parametrize("holes", [False, True])
def test_generators_write_the_same_files(roots, tmp_path, holes):
    if holes:
        jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
        for gen, root in ((jsynthetic, jroot), (synthetic, troot)):
            gen.generate_cad_style_dataset(root, n_train=3, n_test=1,
                                           seed=2, hole_augment=True)
    else:
        jroot, troot = roots
    n_frames = 4 if holes else 54
    # rgb, depth, mask per frame; PLY, proj_mat, transforms, two lists
    assert _assert_trees_equal(jroot, troot) == 3 * n_frames + 5


def _readers_match_jax(roots, mode, **tol):
    root = roots[1]
    for refine in (False, True):
        ours = cad.CADDataset(root, mode, refine=refine, **KW)
        theirs = jcad.CADDataset(root, mode, refine=refine, **KW)
        assert len(ours) == len(theirs) == (4 if mode == "train" else 5)
        assert ours.items == theirs.items and ours.sym_list == []
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            for i in range(len(ours)):
                got = ours[i]
                assert got.valid and got.points.shape == (N, 3)
                assert_samples_equal(got, theirs[i], **tol)
    # the cloud lands on the gt-posed model: the Unity decode is consistent
    s = cad.CADDataset(root, "test", add_noise=False, num_points=N,
                       crop_size=CROP, num_mesh_points=2000)[0]
    d = np.linalg.norm(s.points[:, None] - s.target[None], axis=-1).min(1)
    assert d.mean() < 0.01


@pytest.mark.parametrize("mode", ["train", "test"])
def test_reader_matches_jax(roots, mode, no_library):
    """The same root, seed, epoch and index give the same sample: train
    mode with translation noise and color jitter, test mode's every tenth
    frame, the refine phase's mesh."""
    _readers_match_jax(roots, mode)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_reader_matches_jax_with_library(roots, mode, with_library):
    """The same with both libraries on (the jitter's fused pass, the fused
    normalize + resize and ``choose`` remap): every field exactly equal."""
    _readers_match_jax(roots, mode, img_atol=0.0)


def test_unity_conventions_match_jax(roots, rng):
    proj = os.path.join(roots[1], "data", "01", "meta", "proj_mat.txt")
    ours = cad.UnityDepthRayMap.from_file(proj, (520, 1109))
    theirs = jcad.UnityDepthRayMap.from_file(proj, (520, 1109))
    np.testing.assert_array_equal(ours.ray_map, theirs.ray_map)
    png = rng.integers(0, 65535, (40, 50)).astype(np.uint16)
    np.testing.assert_array_equal(ours.linearize(png), theirs.linearize(png))
    rows, cols = rng.integers(0, 40, 30), rng.integers(0, 50, 30)
    np.testing.assert_array_equal(ours.unproject(png, rows, cols),
                                  theirs.unproject(png, rows, cols))
    q = rng.standard_normal(4)
    np.testing.assert_array_equal(cad.convert_left_handed_quat(q),
                                  jcad.convert_left_handed_quat(q))
    np.testing.assert_array_equal(cad._quat_xyzw_to_matrix(q),
                                  jcad._quat_xyzw_to_matrix(q))
    np.testing.assert_array_equal(cad._Y_180, jcad._Y_180)


@pytest.mark.parametrize("cmd", ["masks", "split", "all"])
def test_cad_prep_matches_jax(roots, tmp_path, cmd):
    """On two copies of a root with its masks and lists removed, the port's
    and the JAX tool write the same masks and split and return the same."""
    copies = []
    for name in ("j", "t"):
        root = str(tmp_path / name)
        shutil.copytree(roots[1], root)
        base = os.path.join(root, "data", "01")
        shutil.rmtree(os.path.join(base, "mask"))
        for f in ("train.txt", "test.txt"):
            os.remove(os.path.join(base, f))
        copies.append(root)
    extra = [] if cmd == "masks" else ["--train_percent", "60", "--seed",
                                       "3"]
    want = j_cad_prep.main([cmd, "--root", copies[0], *extra])
    got = cad_prep.main([cmd, "--root", copies[1], *extra])
    assert got == want
    assert _assert_trees_equal(*copies) > 0
    if cmd != "split":
        assert len(os.listdir(os.path.join(copies[1], "data", "01",
                                           "mask"))) == 54


@pytest.fixture(scope="module")
def small_roots(tmp_path_factory):
    """A YCB and a LineMOD root for ``inspect_sample``'s other readers."""
    tmp = tmp_path_factory.mktemp("inspect")
    synthetic.generate_ycb_style_dataset(str(tmp / "ycb"), n_classes=3,
                                         n_real=1, n_syn=1, n_test=1, seed=4)
    synthetic.generate_linemod_style_dataset(
        str(tmp / "linemod"), objlist=tuple(LINEMOD_OBJLIST), n_train=2,
        n_test=1, seed=4)
    return {"ycb": str(tmp / "ycb"), "linemod": str(tmp / "linemod")}


def _inspect_matches_jax(roots, small_roots, tmp_path, dataset):
    root = roots[1] if dataset == "cad" else small_roots[dataset]
    args = ["--dataset", dataset, "--dataset_root", root, "--index", "1"]
    got = inspect_sample.main([*args, "--out_dir", str(tmp_path / "o")])
    want = j_inspect.main([*args, "--out_dir", str(tmp_path / "j")])
    assert got == want and got < 0.01
    names = ["depth_projected.ply", "model.ply", "target.ply"]
    assert sorted(os.listdir(tmp_path / "o")) == names
    for f in names:
        assert filecmp.cmp(tmp_path / "o" / f, tmp_path / "j" / f,
                           shallow=False), f


@pytest.mark.parametrize("dataset", ["cad", "ycb", "linemod"])
def test_inspect_sample_matches_jax(roots, small_roots, tmp_path, dataset,
                                    no_library):
    _inspect_matches_jax(roots, small_roots, tmp_path, dataset)


@pytest.mark.parametrize("dataset", ["cad", "ycb", "linemod"])
def test_inspect_sample_matches_jax_with_library(roots, small_roots,
                                                 tmp_path, dataset,
                                                 with_library):
    """Both libraries on: the same PLY bytes."""
    _inspect_matches_jax(roots, small_roots, tmp_path, dataset)


def test_train_cad_checkpoint_loads_in_jax(roots, tmp_path):
    out = str(tmp_path / "out")
    tr = train.main([
        "--dataset", "cad", "--dataset_root", roots[1], "--objlist", "1",
        "--nepoch", "1", "--batch_size", "2", "--workers", "1",
        "--crop_size", str(CROP), "--num_points", str(N), "--out_dir", out,
        "--log_dir", str(tmp_path / "logs"), "--device", "cpu"])
    assert tr.cfg.num_objects == 1 and tr.cfg.sym_list == ()
    assert tr.curriculum.epoch == 2 and tr.state.step == 2
    path = os.path.join(out, "cad", "checkpoint_current")
    img, pts = jnp.zeros((1, CROP, CROP, 3)), jnp.zeros((1, N, 3))
    obj = jnp.zeros((1,), jnp.int32)
    shapes_pose = jax.eval_shape(JPoseNet(num_obj=1).init,
                                 jax.random.key(0), img, pts,
                                 jnp.zeros((1, N), jnp.int32), obj)
    shapes_ref = jax.eval_shape(JRefiner(num_obj=1).init, jax.random.key(0),
                                pts, jnp.zeros((1, N, EMB)), obj)
    template = JTrainState(
        step=jnp.zeros((), jnp.int32), params_pose=shapes_pose,
        params_refine=shapes_ref,
        opt_state=jax.eval_shape(j_make_optimizer(1e-4).init, shapes_pose),
        rng=jax.random.key(0))
    state, cur, cfg_json = j_load_checkpoint(path, template,
                                             restore_opt=True)
    assert int(state.step) == 2 and cur.epoch == 2
    assert JRunConfig.from_json(cfg_json).dataset == "cad"
    for g, w in zip(jax.tree.leaves(state.params_pose),
                    jax.tree.leaves(shapes_pose)):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)


def test_eval_cad_parser_matches_jax():
    def spec(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.choices, a.nargs, a.required)
                for a in parser._actions if a.dest != "help"}
    got = spec(eval_cad.build_parser())
    assert got.pop("device")[1] is None
    assert got == spec(j_eval_cad.build_parser())


def _distances(out: str) -> dict:
    with open(os.path.join(out, "eval_log.txt")) as f:
        return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
            r"No\.(\d+) (?:Pass|FAIL) dis ([0-9.]+)", f.read())}


def test_eval_cad_matches_jax(roots, tmp_path):
    ck = str(tmp_path / "checkpoint_best_refine")
    save_jax_checkpoint(ck, np.random.default_rng(19), 1, N, CROP,
                        JRunConfig.preset("cad", num_objects=1,
                                          refine_iters=2))
    args = ["--dataset_root", roots[1], "--checkpoint", ck, "--iterations",
            "2", "--num_points", str(N), "--crop_size", str(CROP),
            "--dump_ply_frames", "2", "--success_threshold_m", "0.36"]
    rate = eval_cad.main([*args, "--output_dir", str(tmp_path / "o"),
                          "--device", "cpu"])
    want = j_eval_cad.main([*args, "--output_dir", str(tmp_path / "j")])
    got_d, want_d = _distances(str(tmp_path / "o")), \
        _distances(str(tmp_path / "j"))
    assert sorted(got_d) == sorted(want_d) == list(range(5))
    for i, d in want_d.items():
        assert abs(got_d[i] - d) <= 1e-4, (i, got_d[i], d)
    # the threshold splits the frames, and no distance is near it
    assert 0 < rate < 1 and rate == want
    assert min(abs(d - 0.36) for d in want_d.values()) > 1e-3
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "o")) == names
    assert names == ["eval_log.txt", "pred_pcld_0.ply", "pred_pcld_1.ply",
                     "target_pcld_0.ply", "target_pcld_1.ply"]
    for f in ("target_pcld_0.ply", "target_pcld_1.ply"):
        assert filecmp.cmp(tmp_path / "o" / f, tmp_path / "j" / f,
                           shallow=False)


def test_entry_points_need_cuda_or_cpu(roots, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_cad.main(["--dataset_root", roots[1], "--checkpoint",
                       str(tmp_path), "--output_dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--dataset", "cad", "--dataset_root", roots[1],
                    "--objlist", "1", "--out_dir", str(tmp_path)])
