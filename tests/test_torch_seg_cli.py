"""Port parity: the SegNet CLIs (``cli.segment``, ``cli.train_seg``) and the
SegNet checkpoint files.

Both packages' CLIs build ``SegNet(num_classes=...)`` at full width; here
each package's ``SegNet`` is patched to the narrow one of
``tests/test_torch_segnet.py`` (widths up to 16), so the CLIs run in
seconds on the CPU. Frames are 64x96 (``segment``) and 32x64 (a
hand-written YCB-format root for ``train_seg``); SegNet needs multiples
of 32.

* ``segment``: from one JAX ``segnet_best.msgpack``, the port's PNGs equal
  the JAX CLI's in all four modes (label map, ``--binary_class``,
  ``--class_vs_bg``, ``--list``);
* the checkpoint files: a JAX ``segnet_latest.msgpack`` loaded into the
  port and written back is the same bytes; the port's ``segnet_best`` /
  ``segnet_latest`` have the JAX trees' keys, shapes and dtypes;
* ``train_seg``: a JAX epoch resumes in the port and a port epoch in JAX
  (``metrics.jsonl`` epochs 1, 2); from one JAX epoch-1 checkpoint both
  CLIs' epoch 2 agree (losses rtol 1e-4, accuracy and IoU to 1e-3, at lr
  1e-4: Adam moves parameters whose gradient is at rounding size by up to
  lr either way, so the gap grows with lr; at lr 1e-3 the test loss read
  1.3e-4 apart);
  recipe defaults as JAX's; the RSS guard exec-restarts with
  ``--resume``.
"""

import functools
import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from flax import serialization

import densefusion_tpu.models as jmodels
import densefusion_tpu_torch.models as tmodels
from densefusion_tpu.cli import segment as j_segment
from densefusion_tpu.cli import train_seg as j_train_seg
from densefusion_tpu_torch.cli import segment, train_seg
from densefusion_tpu_torch.models import SegNet
from densefusion_tpu_torch.train.seg import (
    create_seg_train_state, load_seg_latest, load_segnet, save_seg_latest,
    save_segnet,
)

from tests.test_torch_segnet import DEC, ENC, seg_variables

NUM_CLASSES = 4


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' ``SegNet`` at the narrow widths."""
    monkeypatch.setattr(jmodels, "SegNet", functools.partial(
        jmodels.SegNet, enc_stages=ENC, dec_stages=DEC))
    monkeypatch.setattr(tmodels, "SegNet", functools.partial(
        SegNet, enc_stages=ENC, dec_stages=DEC))


def _leaf_specs(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_specs(v, path + (k,)))
        else:
            a = np.asarray(v)
            out[path + (k,)] = (a.shape, a.dtype.str, type(v).__name__)
    return out


def _read(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


# -- segment ----------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_inputs(tmp_path_factory):
    """Three 64x96 frames and a JAX ``segnet_best.msgpack``."""
    d = tmp_path_factory.mktemp("segment")
    rng = np.random.default_rng(0)
    (d / "rgb").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3)).astype(np.uint8)
                        ).save(d / "rgb" / f"{i:04d}.png")
    jnet = jmodels.SegNet(num_classes=NUM_CLASSES, enc_stages=ENC,
                          dec_stages=DEC)
    variables = seg_variables(jnet, rng, 64, 96)
    ckpt = d / "segnet_best.msgpack"
    ckpt.write_bytes(serialization.to_bytes(variables))
    (d / "test.txt").write_text("1\n0002\n")
    return d, ckpt


@pytest.mark.parametrize("mode", ["labels", "binary", "class_vs_bg", "list"])
def test_segment_writes_the_jax_pngs(seg_inputs, narrow, tmp_path, mode):
    d, ckpt = seg_inputs
    flags = {"labels": [], "binary": ["--binary_class", "1"],
             "class_vs_bg": ["--binary_class", "1", "--class_vs_bg"],
             "list": ["--binary_class", "2", "--list", str(d / "test.txt")]
             }[mode]
    outs = {}
    for name, main, extra in (("jax", j_segment.main, []),
                              ("port", segment.main, ["--device", "cpu"])):
        out = tmp_path / name
        main(["--checkpoint", str(ckpt), "--images", str(d / "rgb" / "*.png"),
              "--out_dir", str(out), "--num_classes", str(NUM_CLASSES),
              "--batch_size", "2"] + flags + extra)
        outs[name] = {os.path.basename(p): np.array(Image.open(p))
                      for p in sorted(glob.glob(str(out / "*")))}
    want = (["0001_label.png", "0002_label.png"] if mode == "list"
            else ["0000_label.png", "0001_label.png", "0002_label.png"])
    assert list(outs["port"]) == list(outs["jax"]) == want
    for k, v in outs["jax"].items():
        assert outs["port"][k].dtype == v.dtype == np.uint8
        assert outs["port"][k].shape == (64, 96)
        np.testing.assert_array_equal(outs["port"][k], v, err_msg=k)
    values = set(np.unique(np.stack(list(outs["port"].values()))))
    if mode == "labels":
        assert values <= set(range(NUM_CLASSES)) and len(values) > 1
    else:
        assert values == {0, 255}


def test_segment_refuses_class_vs_bg_alone(seg_inputs, tmp_path):
    d, ckpt = seg_inputs
    with pytest.raises(SystemExit):
        segment.main(["--checkpoint", str(ckpt), "--images",
                      str(d / "rgb" / "*.png"), "--out_dir", str(tmp_path),
                      "--class_vs_bg", "--device", "cpu"])


# -- checkpoint files -------------------------------------------------------

def _ycb_seg_root(root: str, rng, n_train=4, n_test=2, h=32, w=64):
    """A YCB-format segmentation root: real frames under ``data/`` and
    synthetic ones under ``data_syn/``, -color / -label PNGs, the
    dataset_config lists."""
    frames = {"train": [], "test": []}
    for split, n in (("train", n_train), ("test", n_test)):
        for i in range(n):
            base = ("data_syn" if split == "train" and i % 2 else "data")
            name = f"{base}/{split}{i:04d}"
            os.makedirs(os.path.join(root, base), exist_ok=True)
            rgb = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
            label = np.zeros((h, w), np.uint8)
            label[rng.integers(0, h // 2):, rng.integers(0, w // 2):] = \
                rng.integers(1, NUM_CLASSES)
            Image.fromarray(rgb).save(os.path.join(root, name + "-color.png"))
            Image.fromarray(label).save(
                os.path.join(root, name + "-label.png"))
            frames[split].append(name)
    os.makedirs(os.path.join(root, "dataset_config"), exist_ok=True)
    for split, fname in (("train", "train_data_list.txt"),
                         ("test", "test_data_list.txt")):
        with open(os.path.join(root, "dataset_config", fname), "w") as f:
            f.write("\n".join(frames[split]) + "\n")


def _common(root, out, log, device=()):
    return ["--dataset_root", root, "--batch_size", "2", "--workers", "2",
            "--num_classes", str(NUM_CLASSES), "--lr", "1e-4",
            "--fg_weight", "3", "--seed", "1", "--out_dir", out,
            "--log_dir", log] + list(device)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One epoch of the JAX CLI on a YCB-format root: (root, out dir)."""
    d = tmp_path_factory.mktemp("train_seg")
    root = str(d / "root")
    _ycb_seg_root(root, np.random.default_rng(3))
    out = str(d / "jax")
    mp = pytest.MonkeyPatch()
    mp.setattr(jmodels, "SegNet", functools.partial(
        jmodels.SegNet, enc_stages=ENC, dec_stages=DEC))
    try:
        j_train_seg.main(_common(root, out, str(d / "jax_logs"))
                         + ["--n_epochs", "1"])
    finally:
        mp.undo()
    return root, out


def test_latest_round_trips_byte_for_byte(jax_run, tmp_path):
    """JAX's ``segnet_latest.msgpack`` loaded into a port state and written
    back (same epoch and best) is the same bytes; its best file too."""
    _, out = jax_run
    path = os.path.join(out, "segnet_latest.msgpack")
    state = create_seg_train_state(SegNet(NUM_CLASSES, ENC, DEC),
                                   device="cpu")
    epoch, best = load_seg_latest(path, state)
    assert epoch == 1 and np.isfinite(best)
    assert state.step == int(np.asarray(_read(path)["opt_state"]["0"]
                                        ["count"]))
    again = str(tmp_path / "latest.msgpack")
    save_seg_latest(again, state, epoch, best)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    best_path = os.path.join(out, "segnet_best.msgpack")
    net = load_segnet(best_path, SegNet(NUM_CLASSES, ENC, DEC))
    save_segnet(str(tmp_path / "best.msgpack"), net)
    with open(best_path, "rb") as a, \
            open(tmp_path / "best.msgpack", "rb") as b:
        assert a.read() == b.read()


def test_port_files_have_the_jax_trees(jax_run, narrow, tmp_path):
    root, out = jax_run
    port = str(tmp_path / "port")
    train_seg.main(_common(root, port, str(tmp_path / "logs"), ["--device",
                                                               "cpu"])
                   + ["--n_epochs", "1"])
    for name in ("segnet_best.msgpack", "segnet_latest.msgpack"):
        got, want = (_leaf_specs(_read(os.path.join(d, name)))
                     for d in (port, out))
        assert got == want, name
        assert list(_read(os.path.join(port, name))) == \
            list(_read(os.path.join(out, name)))


def _epochs(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_resume_across_packages(jax_run, narrow, tmp_path):
    """JAX epoch 1 -> port epoch 2, and port epoch 1 -> JAX epoch 2; from the
    same JAX epoch-1 checkpoint both CLIs' epoch 2 agree."""
    import shutil

    root, out = jax_run
    runs = {}
    for name, main, device in (("port", train_seg.main, ["--device", "cpu"]),
                               ("jax", j_train_seg.main, [])):
        d = str(tmp_path / name)
        shutil.copytree(out, d)
        log = str(tmp_path / f"{name}_logs")
        main(_common(root, d, log, device) + ["--n_epochs", "2",
                                              "--resume"])
        runs[name] = _epochs(log)
    assert [r["epoch"] for r in runs["port"]] == [2]
    assert [r["epoch"] for r in runs["jax"]] == [2]
    got, want = runs["port"][0], runs["jax"][0]
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("pixel_acc", "fg_iou"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    assert set(want) <= set(got)

    # the other way: a port epoch 1 resumes in JAX
    d = str(tmp_path / "port_first")
    log = str(tmp_path / "port_first_logs")
    train_seg.main(_common(root, d, log, ["--device", "cpu"])
                   + ["--n_epochs", "1"])
    j_train_seg.main(_common(root, d, log) + ["--n_epochs", "2",
                                              "--resume"])
    assert [r["epoch"] for r in _epochs(log)] == [1, 2]


def test_recipe_defaults_match_jax():
    for argv in (["--dataset_root", "/x", "--format", "linemod"],
                 ["--dataset_root", "/x"],
                 ["--dataset_root", "/x", "--format", "linemod", "--lr",
                  "1e-3", "--fg_weight", "2", "--batch_size", "4"]):
        got = vars(train_seg.resolve_recipe_defaults(
            train_seg.build_parser().parse_args(argv)))
        want = vars(j_train_seg.resolve_recipe_defaults(
            j_train_seg.build_parser().parse_args(argv)))
        assert got.pop("device") is None
        assert got == want


def test_rss_guard_restarts_with_resume(jax_run, narrow, tmp_path,
                                        monkeypatch):
    """Run from the command line (argv None), an epoch that ends above
    ``--rss_restart_gb`` has written ``segnet_latest.msgpack`` and then
    exec-restarts the same command with ``--resume``."""
    import sys

    from densefusion_tpu_torch.utils import restart

    root, _ = jax_run
    out = str(tmp_path / "out")
    argv = ["train_seg.py"] + _common(root, out, str(tmp_path / "logs"),
                                      ["--device", "cpu"]) + [
        "--n_epochs", "3", "--rss_restart_gb", "1"]
    calls = []

    class Restarted(Exception):
        pass

    def fake_reexec(cmd):
        calls.append(cmd)
        raise Restarted

    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.setattr(train_seg, "_rss_gb", lambda: 2.0)
    monkeypatch.setattr(restart, "reexec_self", fake_reexec)
    with pytest.raises(Restarted):
        train_seg.main()
    assert calls == [argv + ["--resume"]]
    latest = _read(os.path.join(out, "segnet_latest.msgpack"))
    assert int(latest["epoch"]) == 1


def test_seg_entry_points_need_cuda_or_cpu(seg_inputs, jax_run, tmp_path):
    """Without a card and without ``--device cpu`` / ``device="cpu"``,
    ``segment``, ``train_seg`` and ``bench_seg`` raise before writing
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from densefusion_tpu_torch.cli.benchmark import bench_seg

    d, ckpt = seg_inputs
    root, _ = jax_run
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA"):
        segment.main(["--checkpoint", str(ckpt), "--images",
                      str(d / "rgb" / "*.png"), "--out_dir", str(out)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_seg.main(_common(root, str(out), str(tmp_path / "logs"))
                       + ["--n_epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_seg()
    assert not out.exists()
