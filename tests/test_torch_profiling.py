"""The profiling hooks (``densefusion_tpu_torch/utils/profiling.py``) and
``--trace_dir`` in ``cli.train`` and ``cli.benchmark``, on the CPU.

* ``trace_context(None)`` runs its region with no profiler on;
* ``cli.train --trace_dir`` (one epoch on a synthetic two-object LineMOD
  root at 32 px, N=32) and ``cli.benchmark --what knn --trace_dir`` (2,000
  queries) each write a ``torch.profiler`` trace that holds the region's
  operators, and the training trace holds the port's step spans.
"""

import glob
import json

import torch

from densefusion_tpu_torch.cli import benchmark, train
from densefusion_tpu_torch.data import generate_linemod_style_dataset
from densefusion_tpu_torch.utils import trace_context


def test_trace_context_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace_context(None):
        assert not torch.autograd.profiler._is_profiler_enabled
        x = torch.ones(3) + 1
    assert x.sum() == 6 and list(tmp_path.iterdir()) == []


def _trace(trace_dir) -> dict:
    files = glob.glob(f"{trace_dir}/*.pt.trace.json")
    assert len(files) == 1, files
    with open(files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    return trace


def test_train_trace_dir(tmp_path):
    root = str(tmp_path / "lm")
    generate_linemod_style_dataset(root, objlist=(1, 10), n_train=4,
                                   n_test=20, seed=9)
    trace_dir = str(tmp_path / "trace")
    tr = train.main([
        "--dataset", "linemod", "--dataset_root", root, "--objlist", "1",
        "10", "--nepoch", "1", "--repeat_epoch", "1", "--batch_size", "2",
        "--workers", "1", "--crop_size", "32", "--num_points", "32",
        "--out_dir", str(tmp_path / "out"), "--log_dir",
        str(tmp_path / "logs"), "--trace_dir", trace_dir, "--device", "cpu"])
    assert tr.curriculum.epoch == 2
    names = {e.get("name") for e in _trace(trace_dir)["traceEvents"]}
    assert "aten::convolution" in names and "Optimizer.step#Adam.step" \
        in names
    assert {"train.step", "train.backward"} <= names


def test_benchmark_trace_dir(tmp_path):
    trace_dir = str(tmp_path / "trace")
    res = benchmark.main(["--what", "knn", "--device", "cpu", "--queries",
                          "2000", "--trace_dir", trace_dir])
    assert res["knn_backend"] == "plain"
    names = {e.get("name") for e in _trace(trace_dir)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
