"""Port parity: the end-to-end deployment demos of the PyTorch port
(``examples/gpu_ycb_e2e_synthetic.py``, ``gpu_linemod_two_stage.py``,
``gpu_serve_soak.py``, ``gpu_ab_bf16_convergence.sh``), the port's
highest-level user entry points, against the JAX package's.

* each Python demo runs ``--cpu --smoke`` to its end and returns the JAX
  example's keys (the assertions of ``tests/test_examples_e2e.py``); one
  smoke run of each pipeline feeds the soak in its mode. The two-stage
  smoke runs with the port's ``SegNet`` patched to the narrow widths of
  ``tests/test_torch_segnet.py`` (a full-width SegNet takes ~70 s an epoch
  at 480x640 on the CPU; the card runs it at full width in
  ``chip_smoke.py`` [4p]);
* the CLIs chained in one process leak nothing: the YCB smoke's training
  repeated after every other CLI call writes the same checkpoint bytes;
* without a card and without ``--cpu`` every demo raises before it
  writes anything;
* no demo imports ``jax`` or the JAX package;
* the demos' generated roots equal, file for file, what the JAX generators
  write for the same ``--smoke`` flags and seed;
* the port's smoke checkpoints, evaluated by the JAX CLIs: ``eval_ycb``
  (``adds_auc``, ``add_auc``, ``adds_under_2cm`` within 1e-6 of their
  value: they are percentages, and the two packages' float32 forwards put
  them 1.6e-6 apart at 76, a distance ~6e-9 m apart; the scored distances
  themselves within 1e-7 m) and, marked ``slow`` (JAX's CPU compile of
  the evaluation takes ~30 s, past this file's budget), LineMOD
  ``eval_linemod --mode eval`` on the port's predicted masks (success
  rates equal, per-object mean distances within 1e-5).
"""

import ast
import filecmp
import functools
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import densefusion_tpu_torch.models as tmodels
from densefusion_tpu_torch.models import SegNet

from tests.test_torch_segnet import DEC, ENC

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
DEMOS = ("gpu_ycb_e2e_synthetic", "gpu_linemod_two_stage",
           "gpu_serve_soak")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ycb_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ycb_e2e"))
    out = os.path.join(work, "summary.json")
    result = _load("gpu_ycb_e2e_synthetic").main(
        ["--cpu", "--smoke", "--root", work, "--out", out])
    return work, out, result


@pytest.fixture(scope="module")
def two_stage_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("two_stage"))
    out = os.path.join(work, "summary.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodels, "SegNet", functools.partial(
            SegNet, enc_stages=ENC, dec_stages=DEC))
        result = _load("gpu_linemod_two_stage").main(
            ["--cpu", "--smoke", "--root", work, "--out", out])
    return work, out, result


def test_ycb_e2e_smoke(ycb_run):
    work, out, result = ycb_run
    # generator -> train -> toolbox scoring ran on the CPU
    assert result["checkpoint"].startswith("checkpoint_")
    for key in ("adds_auc", "add_auc", "adds_under_2cm"):
        assert 0.0 <= result[key] <= 100.0
    assert set(result["methods"]) == {"per-pixel", "iterative"}
    assert result["device"] == "cpu" and result["card"] is None
    assert result["dtype"] == "float32"
    with open(out) as f:
        assert json.load(f)["work_dir"] == work
    n_mat = os.listdir(os.path.join(work, "eval_out",
                                    "Densefusion_iterative_result"))
    assert len(n_mat) == 2


def test_linemod_two_stage_smoke(two_stage_run):
    work, out, result = two_stage_run
    # the full chain ran: masks predicted (class-vs-bg default), pose
    # trained, eval consumed ONLY predictions
    assert result["predicted_masks"] > 0
    assert 0.0 <= result["success_rate_0.1d"] <= 1.0
    assert result["checkpoint"].startswith("checkpoint_")
    assert result["seg_best_epoch"] is not None
    per_object = result["eval"]["per_object"]
    assert {row["obj"] for row in per_object} == {1, 10}
    assert result["device"] == "cpu" and result["card"] is None
    with open(out) as f:
        assert json.load(f)["work_dir"] == work
    # gt segnet_results were deleted before mask prediction; what's on disk
    # is the smoke's own predictions for the eval frames only, 0/255 PNGs
    sr = os.path.join(work, "dataset", "segnet_results")
    assert sorted(os.listdir(sr)) == ["01_label", "10_label"]
    from PIL import Image
    for obj in ("01", "10"):
        for f in os.listdir(os.path.join(sr, f"{obj}_label")):
            mask = np.array(Image.open(os.path.join(sr, f"{obj}_label", f)))
            assert set(np.unique(mask)) <= {0, 255}


@pytest.mark.parametrize("fmt", ["ycb", "linemod"])
def test_serve_soak_smoke(fmt, ycb_run, two_stage_run):
    if fmt == "linemod":
        work, _, result = two_stage_run
        ckpt = os.path.join(work, "trained", "linemod", result["checkpoint"])
        extra = ["--format", "linemod", "--objlist", "1,10"]
    else:
        work, _, result = ycb_run
        ckpt = os.path.join(work, "trained", "ycb", result["checkpoint"])
        extra = ["--num_obj", "2"]
    out = os.path.join(work, "soak.json")
    summary = _load("gpu_serve_soak").main([
        "--dataset_root", os.path.join(work, "dataset"),
        "--checkpoint", ckpt, "--passes", "3",
        "--num_points", "64", "--crop_size", "64", "--iterations", "1",
        "--out", out, "--cpu", *extra,
    ])
    frames = summary["eval_frames"] if fmt == "linemod" \
        else summary["keyframes"]
    assert summary["frames"] == 3 * frames
    assert summary["sustained_frames_per_s"] > 0
    assert summary["rss_peak_mb"] > 0
    assert len(summary["rss_per_pass_mb"]) == 3
    assert summary["rss_growth_last3_mb"] is not None
    # no card: no allocator readings
    assert summary["card_allocated_bytes_per_pass"] is None
    assert summary["device"] == "cpu"
    with open(out) as f:
        assert json.load(f).get("format", "ycb") == fmt


def test_chained_clis_leak_nothing(ycb_run, two_stage_run, tmp_path):
    """The YCB smoke's training once more, in this process after both
    demos and the YCB soak ran their CLIs (``train``, ``eval_ycb``,
    ``train_seg``, ``segment``, ``eval_linemod``): the same checkpoint
    bytes (parameters, Adam state, step, dropout generator, key), so no
    CLI carries state into the next."""
    from densefusion_tpu_torch.cli import train as train_cli

    work = ycb_run[0]
    out = str(tmp_path / "again")
    train_cli.main([
        "--dataset", "ycb", "--dataset_root", os.path.join(work, "dataset"),
        "--batch_size", "2", "--workers", "1", "--nepoch", "1",
        "--repeat_epoch", "1", "--crop_size", "64", "--seed", "1",
        "--num_objects", "2", "--num_points", "64", "--out_dir", out,
        "--log_dir", os.path.join(out, "logs"), "--device", "cpu"])
    for tag in ("checkpoint_best_pose", "checkpoint_current"):
        a, b = (Path(d, "ycb", tag, "state.msgpack").read_bytes()
                for d in (os.path.join(work, "trained"), out))
        assert a == b, tag


@pytest.mark.parametrize("name", DEMOS)
def test_demo_raises_without_a_card(name, tmp_path, monkeypatch):
    """Without ``--cpu`` a demo asks for the card and raises when there is
    none, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = tmp_path / "work"
    argv = {"gpu_serve_soak": ["--dataset_root", str(work / "dataset"),
                               "--checkpoint", str(work / "ckpt")]
            }.get(name, ["--smoke", "--root", str(work)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)
    assert not work.exists()


@pytest.mark.parametrize("name", [*(f"{d}.py" for d in DEMOS),
                                  "gpu_ab_bf16_convergence.sh"])
def test_demo_imports_no_jax(name):
    """No demo imports ``jax`` or the JAX package: every import statement
    of the Python demos (and of the shell script's Python), and every
    module the shell script runs, names the port or a library."""
    text = (EXAMPLES / name).read_text()
    if name.endswith(".sh"):
        assert "-m densefusion_tpu_torch.cli.train" in text
        modules = [ln.split("-m", 1)[1].split()[0] for ln in text.splitlines()
                   if "python" in ln and " -m " in ln]
        blocks = text.split("<<'EOF'")[1:]
        assert blocks, "the script's Python blocks"
        trees = [ast.parse(b.split("\nEOF", 1)[0]) for b in blocks]
    else:
        modules, trees = [], [ast.parse(text)]
    for tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                modules += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                modules.append(node.module)
    assert any(m.startswith("densefusion_tpu_torch") for m in modules)
    bad = [m for m in modules if m.split(".")[0] in ("jax", "densefusion_tpu")]
    assert bad == []


def _assert_same_tree(a, b):
    """Every directory holds the same names; PNG pixels, ``.mat`` arrays and
    every other file equal."""
    from PIL import Image
    import scipy.io as scio

    n = 0
    for dirpath, dirnames, files in os.walk(a):
        rel = os.path.relpath(dirpath, a)
        assert sorted(os.listdir(os.path.join(b, rel))) == \
            sorted(files + dirnames), rel
        for f in files:
            x, y = os.path.join(dirpath, f), os.path.join(b, rel, f)
            ext = os.path.splitext(f)[1]
            if ext == ".png":
                px, py = np.array(Image.open(x)), np.array(Image.open(y))
                assert px.dtype == py.dtype
                np.testing.assert_array_equal(px, py, err_msg=x)
            elif ext == ".mat":
                mx, my = scio.loadmat(x), scio.loadmat(y)
                keys = {k for k in mx if not k.startswith("__")}
                assert keys == {k for k in my if not k.startswith("__")}
                for k in keys:
                    np.testing.assert_array_equal(mx[k], my[k], err_msg=x)
            else:
                assert filecmp.cmp(x, y, shallow=False), x
            n += 1
    return n


@pytest.mark.parametrize("which", ["ycb", "linemod"])
def test_demo_roots_equal_jax_generators(which, tmp_path):
    """The roots the demos generate at ``--smoke`` (their own flags and
    seed) against the JAX generators' roots for the same arguments: the
    YCB root with its fake PoseCNN results, the LineMOD root with
    ``realism=True``."""
    from densefusion_tpu.data import synthetic as jsyn
    from densefusion_tpu_torch.data import synthetic as tsyn

    if which == "ycb":
        def gen(mod, work):
            mod.generate_ycb_style_dataset(
                os.path.join(work, "dataset"), n_classes=2, n_real=3,
                n_syn=1, n_test=2, seed=1,
                posecnn_dir=os.path.join(work, "posecnn"),
                objs_per_frame=2)
    else:
        def gen(mod, work):
            mod.generate_linemod_style_dataset(
                os.path.join(work, "dataset"), objlist=(1, 10), n_train=3,
                n_test=2, seed=1, realism=True)
    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "port")
    gen(jsyn, jwork)
    gen(tsyn, twork)
    assert _assert_same_tree(jwork, twork) > 10
    assert _assert_same_tree(twork, jwork) > 10


@pytest.mark.slow
def test_linemod_smoke_checkpoint_evaluates_as_in_jax(two_stage_run):
    """The port's smoke checkpoint through the JAX ``eval_linemod --mode
    eval`` on the port's predicted masks, against the port's evaluation in
    the demo: the same success rates and lost detections, per-object mean
    distances within 1e-5."""
    from densefusion_tpu.cli import eval_linemod as j_eval_linemod

    work, _, result = two_stage_run
    out = os.path.join(work, "jax_eval")
    j_eval_linemod.main([
        "--dataset_root", os.path.join(work, "dataset"),
        "--checkpoint", os.path.join(work, "trained", "linemod",
                                     result["checkpoint"]),
        "--mode", "eval", "--objlist", "1", "10", "--iterations", "4",
        "--num_points", "64", "--crop_size", "64", "--output_dir", out])
    with open(os.path.join(out, "result.json")) as f:
        want = json.load(f)
    got = result["eval"]
    for key in ("rate_per_pixel", "rate_refined", "lost_detections",
                "iterations"):
        assert got[key] == want[key], key
    assert result["success_rate_0.1d"] == want["rate_refined"]
    assert len(got["per_object"]) == len(want["per_object"]) == 2
    for g, w in zip(got["per_object"], want["per_object"]):
        assert (g["obj"], g["count"]) == (w["obj"], w["count"])
        assert g["rate_per_pixel"] == w["rate_per_pixel"]
        assert g["rate_refined"] == w["rate_refined"]
        for key in ("mean_dist_per_pixel", "mean_dist_refined"):
            assert abs(g[key] - w[key]) <= 1e-5, (g, w)


def test_ycb_smoke_checkpoint_scores_as_in_jax(ycb_run):
    """The port's YCB smoke checkpoint through the JAX ``eval_ycb`` at the
    demo's flags: ADD-S / ADD AUC and <2 cm within 1e-6 of their value, the
    scored distances within 1e-7 m."""
    import scipy.io as scio

    from densefusion_tpu.cli import eval_ycb as j_eval_ycb

    work, _, result = ycb_run
    jax_out = os.path.join(work, "jax_eval")
    want = j_eval_ycb.main([
        "--dataset_root", os.path.join(work, "dataset"),
        "--posecnn_results", os.path.join(work, "posecnn"),
        "--checkpoint", os.path.join(work, "trained", "ycb",
                                     result["checkpoint"]),
        "--iterations", "2", "--num_points", "64", "--crop_size", "64",
        "--num_keyframes", "2", "--output_dir", jax_out])
    for key in ("adds_auc", "add_auc", "adds_under_2cm"):
        assert abs(result[key] - want[key]) <= 1e-6 * abs(want[key]), key
    assert result["adds_auc"] > 0.0
    got_t, want_t = (scio.loadmat(os.path.join(d, "results_keyframe.mat"))
                     for d in (os.path.join(work, "eval_out"), jax_out))
    for k in ("distances_sys", "distances_non"):
        np.testing.assert_allclose(got_t[k], want_t[k], rtol=0, atol=1e-7)
