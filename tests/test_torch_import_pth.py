"""Port parity: reference ``.pth`` import and export
(``densefusion_tpu_torch/compat.py``, ``cli/import_torch.py``,
``cli/export_torch.py``) against the JAX package's
(``densefusion_tpu/compat.py``, its two CLIs).

The ``.pth`` files are seeded state_dicts shaped as the reference's
(``tests/test_torch_import.py``'s ``make_*_state_dict``: a 3-object
resnet18 ``PoseNet`` with the aux classifier, a ``PoseRefineNet``; a
5-class ``SegNet`` under the reference's names with
``num_batches_tracked``, at the narrow widths of
``tests/test_torch_segnet.py``, both packages' ``SegNet`` patched to
them); no published weights are in the repository. A pose checkpoint is
~0.4 GB on disk, so each case frees what it wrote.

* ``import_torch_checkpoint``: the CNN under each of the reference's three
  prefixes, with and without the aux classifier, gives the JAX import's
  parameters exactly (atol 0), its fresh optimizer, curriculum (refiner
  given or not) and config; the port's directory loads in JAX's
  ``load_checkpoint`` and in ``PoseEstimator.from_checkpoint``; a missing,
  extra or misshapen key raises the JAX importer's error; the JAX PRNG key
  is each package's own fresh one (as ``create_train_state``'s);
* ``export_torch_checkpoint`` of a JAX-written checkpoint equals JAX's
  export tensor for tensor, and its re-import gives the checkpoint's
  parameters back exactly;
* SegNet: the imported ``.msgpack`` holds JAX's tree exactly, and the
  exported ``.pth`` equals JAX's;
* the two CLIs' parsers and messages are JAX's.
"""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
from flax import serialization

import densefusion_tpu.models as jmodels
import densefusion_tpu_torch.models as tmodels

from densefusion_tpu import compat as jcompat
from densefusion_tpu.cli import export_torch as j_export_cli
from densefusion_tpu.cli import import_torch as j_import_cli
from densefusion_tpu.data import PoseSample as JPoseSample
from densefusion_tpu.data import collate as j_collate
from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.train import create_train_state as j_create_state
from densefusion_tpu.train import load_checkpoint as j_load_checkpoint
from densefusion_tpu.train.state import Curriculum as JCurriculum
from densefusion_tpu.utils.config import RunConfig as JRunConfig
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.cli import export_torch, import_torch
from densefusion_tpu_torch.models import SegNet
from densefusion_tpu_torch.serve import PoseEstimator
from densefusion_tpu_torch.train import msgpack

from tests.test_torch_import import (
    make_posenet_state_dict, make_refiner_state_dict,
)
from tests.test_torch_segnet import DEC, ENC
from tests.torch_port_util import NUM_OBJ, save_jax_checkpoint

N, CROP = 40, 48
PREFIXES = ("cnn.model.module.", "cnn.model.", "cnn.")
SEG_CLASSES = 5


def _parser_spec(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, a.required)
            for a in parser._actions if a.dest != "help"}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))


def _read(ck):
    with open(os.path.join(ck, "state.msgpack"), "rb") as f:
        state = msgpack.unpack(f.read())
    with open(os.path.join(ck, "curriculum.json")) as f:
        cur = json.load(f)
    with open(os.path.join(ck, "config.json")) as f:
        cfg = json.load(f)
    return state, cur, cfg


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' ``SegNet`` at the narrow widths."""
    monkeypatch.setattr(jmodels, "SegNet", functools.partial(
        jmodels.SegNet, enc_stages=ENC, dec_stages=DEC))
    monkeypatch.setattr(tmodels, "SegNet", functools.partial(
        SegNet, enc_stages=ENC, dec_stages=DEC))


def _segnet_pth(path, seed):
    """A seeded SegNet state_dict under the reference's names (the narrow
    widths), with the ``num_batches_tracked`` a modern-torch save has."""
    gen = np.random.default_rng(seed)
    sd = {}
    for k, v in SegNet(SEG_CLASSES, ENC, DEC).state_dict().items():
        w = gen.standard_normal(tuple(v.shape)).astype(np.float32)
        if k.endswith("running_var"):
            w = np.abs(w) + 0.5
        sd[k] = torch.from_numpy(w)
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    torch.save(sd, path)


def _reprefixed(sd, prefix, classifier=True):
    out = {}
    for k, v in sd.items():
        if k.startswith("cnn.model.module."):
            if "classifier." in k and not classifier:
                continue
            k = prefix + k[len("cnn.model.module."):]
        out[k] = v
    return out


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """The seeded reference files and the JAX import of them."""
    d = tmp_path_factory.mktemp("pth")
    gen = np.random.default_rng(0)
    pose_sd, ref_sd = make_posenet_state_dict(gen), make_refiner_state_dict(
        gen)
    files = {"pose": str(d / "pose_model.pth"),
             "refine": str(d / "pose_refine_model.pth")}
    torch.save(pose_sd, files["pose"])
    torch.save(ref_sd, files["refine"])
    jax_ck = str(d / "jax_imported")
    jcompat.import_torch_checkpoint(files["pose"], jax_ck, num_obj=NUM_OBJ,
                                    refine_pth=files["refine"], num_points=N,
                                    crop_size=CROP)
    return {"dir": d, "pose_sd": pose_sd, **files, "jax": jax_ck}


@pytest.mark.parametrize("classifier", [True, False], ids=["aux", "no_aux"])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_import_matches_jax(pth, prefix, classifier, tmp_path):
    src = str(tmp_path / "pose.pth")
    torch.save(_reprefixed(pth["pose_sd"], prefix, classifier), src)
    ck = str(tmp_path / "imported")
    compat.import_torch_checkpoint(src, ck, num_obj=NUM_OBJ,
                                   refine_pth=pth["refine"], num_points=N,
                                   crop_size=CROP)
    got, got_cur, got_cfg = _read(ck)
    want, want_cur, want_cfg = _read(pth["jax"])
    for key in ("params_pose", "params_refine", "opt_state", "step"):
        assert_trees_equal({key: got[key]}, {key: want[key]})
    assert got_cur == want_cur and got_cur["refine_started"] \
        and got_cur["decay_started"] and got_cur["refine_steps"] == 1
    assert got_cfg == want_cfg and got_cfg["decoder"] == "torch"
    shutil.rmtree(tmp_path)


def test_import_without_refiner_matches_jax(pth, tmp_path):
    """No refiner: a fresh one (each package's own initializer, so not
    compared by value) and the curriculum at its start, as the JAX
    importer's ``Curriculum()``; the pose half as JAX's import. The
    directory loads in JAX's ``load_checkpoint`` (optimizer included) and
    serves in ``PoseEstimator.from_checkpoint``, which clamps refinement
    to 0 iterations for the untrained refiner."""
    ck = str(tmp_path / "imported")
    compat.import_torch_checkpoint(pth["pose"], ck, num_obj=NUM_OBJ,
                                   num_points=N, crop_size=CROP)
    got, got_cur, got_cfg = _read(ck)
    want, _, want_cfg = _read(pth["jax"])
    for key in ("params_pose", "opt_state", "step"):
        assert_trees_equal({key: got[key]}, {key: want[key]})
    shapes = {p: v.shape for p, v in _leaves(want["params_refine"])}
    assert {p: v.shape for p, v in _leaves(got["params_refine"])} == shapes
    assert got_cur == json.loads(json.dumps(
        dataclasses.asdict(JCurriculum())))
    assert got_cfg == want_cfg

    cfg = JRunConfig(**{**want_cfg, "sym_list": tuple(want_cfg["sym_list"]),
                        "objlist": tuple(want_cfg["objlist"])})
    posenet = JPoseNet(num_obj=NUM_OBJ, **cfg.decoder_flags())
    template = j_create_state(posenet, JRefiner(num_obj=NUM_OBJ), cfg,
                              jax.random.key(1), j_collate(
                                  [JPoseSample.invalid(N, 500, CROP)]))
    state, cur, _ = j_load_checkpoint(ck, template, restore_opt=True)
    assert_trees_equal(jax.device_get(state.params_pose),
                       want["params_pose"])
    assert cur.refine_started is False
    with pytest.warns(UserWarning, match="UNTRAINED"):
        est = PoseEstimator.from_checkpoint(ck, num_obj=NUM_OBJ,
                                            num_points=N, crop_size=CROP,
                                            device="cpu")
    assert est.pipeline.refine_iters == 0
    shutil.rmtree(tmp_path)
    assert est.pipeline.posenet.cnn.model.module is not None


@pytest.mark.parametrize("fault,error,message", [
    ("missing", KeyError, "torch state_dict missing conv4_r.bias"),
    ("extra", ValueError, "unconsumed torch keys"),
    ("shape", ValueError, "shape mismatch for conv4_r.bias")])
def test_import_refuses_a_bad_file(pth, fault, error, message, tmp_path):
    """A missing, extra or misshapen key raises the JAX importer's error
    (``densefusion_tpu/compat.py:248-258,266-268``), and nothing is
    written."""
    sd = dict(pth["pose_sd"])
    if fault == "missing":
        del sd["conv4_r.bias"]
    elif fault == "extra":
        sd["cnn.model.module.feats.bn1.weight"] = torch.ones(64)
    else:
        sd["conv4_r.bias"] = torch.ones(7)
    src = str(tmp_path / "bad.pth")
    torch.save(sd, src)
    with pytest.raises(error, match=message):
        compat.import_torch_checkpoint(src, str(tmp_path / "out"),
                                       num_obj=NUM_OBJ, num_points=N,
                                       crop_size=CROP)
    assert not os.path.exists(tmp_path / "out")
    shutil.rmtree(tmp_path)


@pytest.fixture(scope="module")
def jax_ck(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("export") / "checkpoint_best_refine")
    save_jax_checkpoint(ck, np.random.default_rng(21), NUM_OBJ, N, CROP,
                        JRunConfig.preset("ycb", num_objects=NUM_OBJ,
                                          num_points=N, crop_size=CROP))
    return ck


def test_export_matches_jax_and_reimports(jax_ck, tmp_path):
    paths = {k: (str(tmp_path / f"{k}_pose.pth"),
                 str(tmp_path / f"{k}_refine.pth")) for k in ("jax", "port")}
    want_cfg = jcompat.export_torch_checkpoint(jax_ck, *paths["jax"])
    got_cfg = compat.export_torch_checkpoint(jax_ck, *paths["port"])
    assert got_cfg == want_cfg
    for got_path, want_path in zip(paths["port"], paths["jax"]):
        got = torch.load(got_path, weights_only=True)
        want = torch.load(want_path, weights_only=True)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32 and got[k].is_contiguous()
            assert torch.equal(got[k], want[k]), k
    ck = str(tmp_path / "reimported")
    compat.import_torch_checkpoint(*paths["port"][:1], ck, num_obj=NUM_OBJ,
                                   refine_pth=paths["port"][1],
                                   num_points=N, crop_size=CROP)
    got, _, _ = _read(ck)
    want, _, _ = _read(jax_ck)
    for key in ("params_pose", "params_refine"):
        assert_trees_equal({key: got[key]}, {key: want[key]})
    shutil.rmtree(tmp_path)


def test_segnet_both_ways(narrow, tmp_path):
    src = str(tmp_path / "segnet.pth")
    _segnet_pth(src, 3)
    out = {k: str(tmp_path / f"{k}" / "segnet_best.msgpack")
           for k in ("jax", "port")}
    jcompat.import_segnet_checkpoint(src, out["jax"], SEG_CLASSES)
    compat.import_segnet_checkpoint(src, out["port"], SEG_CLASSES)
    trees = {}
    for k, path in out.items():
        with open(path, "rb") as f:
            trees[k] = serialization.msgpack_restore(f.read())
    assert sorted(trees["port"]) == ["batch_stats", "params"]
    assert_trees_equal(trees["port"], trees["jax"])

    pths = {k: str(tmp_path / f"{k}.pth") for k in ("jax", "port")}
    jcompat.export_segnet_checkpoint(out["jax"], pths["jax"], SEG_CLASSES)
    compat.export_segnet_checkpoint(out["jax"], pths["port"], SEG_CLASSES)
    got = torch.load(pths["port"], weights_only=True)
    want = torch.load(pths["jax"], weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["import_torch", "export_torch"])
def test_cli_parsers_match_jax(name):
    port, jax_cli = {"import_torch": (import_torch, j_import_cli),
                     "export_torch": (export_torch, j_export_cli)}[name]
    assert _parser_spec(port.build_parser()) == \
        _parser_spec(jax_cli.build_parser())


def test_clis_print_what_jax_prints(pth, jax_ck, narrow, tmp_path, capsys):
    """The CLIs print the JAX CLIs' lines (``densefusion_tpu/cli/
    import_torch.py:52-67``, ``export_torch.py:51-66``) and stop on the same
    usage errors; what they write is what the library calls write."""
    out = str(tmp_path / "imported")
    import_torch.main(["--pose_model", pth["pose"], "--refine_model",
                       pth["refine"], "--dataset", "linemod", "--num_obj",
                       str(NUM_OBJ), "--out", out])
    assert capsys.readouterr().out == \
        f"imported -> {out} (num_obj={NUM_OBJ}, refiner=yes)\n"
    assert json.load(open(os.path.join(out, "config.json")))[
        "dataset"] == "linemod"
    seg = str(tmp_path / "seg.pth")
    _segnet_pth(seg, 4)
    import_torch.main(["--segnet_model", seg, "--num_classes",
                       str(SEG_CLASSES), "--out", out + ".msgpack"])
    assert capsys.readouterr().out == \
        f"imported -> {out}.msgpack (segnet, num_classes={SEG_CLASSES})\n"
    pose = str(tmp_path / "pose.pth")
    export_torch.main(["--checkpoint", jax_ck, "--pose_out", pose])
    assert capsys.readouterr().out == \
        f"exported -> {pose} (dataset=ycb, num_obj={NUM_OBJ})\n"
    export_torch.main(["--segnet_ckpt", out + ".msgpack", "--segnet_out",
                       seg, "--num_classes", str(SEG_CLASSES)])
    assert capsys.readouterr().out == \
        f"exported -> {seg} (segnet, num_classes={SEG_CLASSES})\n"
    for cli in (j_import_cli, import_torch):
        with pytest.raises(SystemExit, match="exactly one of"):
            cli.main(["--out", str(tmp_path / "x")])
    for cli in (j_export_cli, export_torch):
        with pytest.raises(SystemExit, match="are required"):
            cli.main([])
        with pytest.raises(SystemExit, match="requires --segnet_out"):
            cli.main(["--segnet_ckpt", out + ".msgpack"])
    shutil.rmtree(tmp_path)
