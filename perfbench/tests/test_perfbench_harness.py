"""The harness on the CPU: the manifest keeps to the benchmark's contract,
cells, configurations, traffic and metrics are found by name, a run's
result line has exactly its keys, a run without a card exits without a
result, and nothing a run loads is JAX or the JAX package."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench.harness import Bench, forbidden_modules, run_cell
from perfbench.tests import tiny

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(bench, workload, traced=False, **kw):
    w = bench.workload(workload)
    return run_cell(bench, workload, 4_000_000_007, 3.0, traced,
                    time.perf_counter(), device="cpu",
                    config=tiny.config(w["config"]),
                    traffic=tiny.traffic(w["traffic"]),
                    limits=tiny.limits(), **kw)


def test_manifest_keeps_to_the_contract():
    bench = Bench()
    m = bench.manifest
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["perfbench"] and 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert bench.config(c["name"])["reduced"] == c["reduced"]
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        bench.config(w["config"]), bench.traffic(w["traffic"])
        assert bench.limits(w["name"]), w["name"]
        others = [x for x in e2e.values() if x["name"] != "setup_s"
                  and w["name"] in x.get("workloads", [w["name"]])]
        assert others
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert (PERFBENCH / "metrics" / f"{x['name']}.py").is_file()
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        moved = e2e[x["moves"]]
        for w in x["workloads"]:
            assert w in moved.get("workloads", [w])
    assert len(json.dumps(m)) <= 64 * 1024


@pytest.mark.parametrize("workload", ["ycb-serve-b64", "linemod-eval-k4-b32",
                                      "ycb-train-p1-b32",
                                      "linemod-train-p1-b32"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contracts_keys(workload, traced):
    bench = Bench()
    r = tiny_run(bench, workload, traced)
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(r) == want
    assert r["correct"] is True and r["failed"] == 0
    json.dumps(r)
    reported = set(r["metrics"])
    expected = {m["name"] for m in bench.metrics_of(workload, traced)}
    # on the CPU there is no device time, so only the device metrics and
    # the kernels' shares may be missing
    assert reported <= expected
    if not traced:
        assert reported == expected
    else:
        assert len(r["breakdown"]["device_ops"]) <= 10
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


# a driver of a new kind, as a later PR would add it: a bf16 matmul judged
# against float64, counting its own FLOPs
MATMUL_DRIVER = """
import torch
from perfbench.harness import Window, require_precision


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        require_precision(cfg, {("bfloat16", False)})
        self.n, self.device = traffic["n"], torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)

    def setup(self):
        self.a = torch.randn(self.n, self.n, generator=self.gen).to(
            self.device, torch.bfloat16)

    def _one(self):
        self.out = (self.a @ self.a).double()

    def window(self, seconds):
        for _ in range(5):
            self._one()
        return Window(seconds, units=5, attempted=5)

    def traced(self):
        self._one()
        return 1

    def flops_per_unit(self):
        return 2.0 * self.n ** 3

    def release(self):
        pass

    def check(self):
        want = self.a.double() @ self.a.double()
        return {"matmul_gap": float((self.out - want).abs().max()
                                    / want.abs().max())}

    def control(self):
        return self.check()
"""


def test_a_cell_added_by_files_and_entries_is_found(tmp_path):
    """Configurations, traffic mixes, a driver of a new kind, metrics and
    cells, added as new files and new manifest entries, with no existing
    file edited: a float32 serving cell at a small size, and a bfloat16
    cell of the new kind whose model FLOPs come from its driver and whose
    share of the peak is read against its configuration's peak."""
    copy = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}

    cfg = tiny.config("densefusion-ycb")
    (copy / "configs" / "tiny-ycb.json").write_text(json.dumps(cfg))
    trf = tiny.traffic("serve-b64")
    (copy / "traffic" / "serve-b4.json").write_text(json.dumps(trf))
    (copy / "metrics" / "requests_per_s.serve.py").write_text(
        "def read(run):\n"
        "    return run.window.units / run.traffic['batch'] "
        "/ run.window.seconds\n")
    (copy / "limits" / "tiny-serve-b4.json").write_text(json.dumps(
        {"checks": {k: {"limit": v} for k, v in tiny.LIMITS.items()}}))
    manifest["configs"].append({"name": "tiny-ycb", "source": "x",
                                "file": "perfbench/configs/tiny-ycb.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "tiny-serve-b4",
                                  "config": "tiny-ycb",
                                  "traffic": "serve-b4", "chips": 1,
                                  "why": "a test"})
    manifest["end_to_end"].append({
        "name": "requests_per_s.serve", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["tiny-serve-b4"]})

    (copy / "drivers" / "matmul.py").write_text(MATMUL_DRIVER)
    (copy / "configs" / "tiny-bf16.json").write_text(json.dumps(
        {"name": "tiny-bf16", "dtype": "bfloat16", "tf32": False,
         "peak_flops": 989e12, "reduced": []}))
    (copy / "traffic" / "matmul-64.json").write_text(json.dumps(
        {"kind": "matmul", "n": 64}))
    (copy / "metrics" / "matmuls_per_s.py").write_text(
        "def read(run):\n"
        "    return run.window.units / run.window.seconds\n")
    (copy / "metrics" / "mfu_pct.matmul.py").write_text(
        "from perfbench.metrics_common import mfu_pct\n\n\n"
        "def read(run):\n"
        "    return mfu_pct(run)\n")
    (copy / "limits" / "tiny-matmul.json").write_text(json.dumps(
        {"checks": {"matmul_gap": {"limit": 0.02}}}))
    manifest["configs"].append({"name": "tiny-bf16", "source": "x",
                                "file": "perfbench/configs/tiny-bf16.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "tiny-matmul",
                                  "config": "tiny-bf16",
                                  "traffic": "matmul-64", "chips": 1,
                                  "why": "a test"})
    manifest["end_to_end"].append({
        "name": "matmuls_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["tiny-matmul"]})
    manifest["per_layer"].append({
        "name": "mfu_pct.matmul", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "model step",
        "moves": "matmuls_per_s", "workloads": ["tiny-matmul"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    for p, data in before.items():
        assert p.read_bytes() == data
    bench = Bench(copy)
    r = run_cell(bench, "tiny-serve-b4", 11, 2.0, False,
                 time.perf_counter(), device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["requests_per_s.serve"]["value"] > 0
    assert {"setup_s", "requests_per_s.serve"} <= set(r["metrics"])

    for traced in (False, True):
        r = run_cell(bench, "tiny-matmul", 12, 2.0, traced,
                     time.perf_counter(), device="cpu")
        assert r["correct"] is True, r["checks"]
        assert set(r["metrics"]) == (
            {"mfu_pct.matmul"} if traced else {"setup_s", "matmuls_per_s"})
    mfu = r["metrics"]["mfu_pct.matmul"]["value"]
    assert mfu == pytest.approx(100 * 2 * 64 ** 3 * 5 / 2.0 / 989e12)


@pytest.mark.parametrize("workload", ["ycb-serve-b64", "linemod-eval-k4-b32",
                                      "ycb-train-p1-b32"])
@pytest.mark.parametrize("precision", [("bfloat16", False),
                                       ("float32", True)])
def test_a_driver_refuses_a_precision_it_does_not_run(workload, precision):
    """A configuration in another precision than the cell's driver runs
    raises before anything is set up, rather than running float32 and
    reading its share against the other precision's peak."""
    bench = Bench()
    w = bench.workload(workload)
    cfg = tiny.config(w["config"])
    cfg["dtype"], cfg["tf32"] = precision
    with pytest.raises(ValueError, match="not run by this driver"):
        run_cell(bench, workload, 5, 0.1, False, time.perf_counter(),
                 device="cpu", config=cfg,
                 traffic=tiny.traffic(w["traffic"]), limits=tiny.limits())


def _run_py(args, cwd, env_extra=None):
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_a_run_without_a_card_prints_no_result():
    p = _run_py(["--workload", "ycb-serve-b64", "--seed", "3",
                 "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_a_checkout_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    script = ("import sys, time; sys.path.insert(0, '.');"
              "from perfbench.harness import Bench, run_cell;"
              "from perfbench.tests import tiny;"
              "run_cell(Bench(), 'ycb-serve-b64', 1, 0.5, False,"
              " time.perf_counter(), device='cpu',"
              " config=tiny.config(), traffic=tiny.traffic('serve-b64'),"
              " limits=tiny.limits())")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "densefusion_tpu_torch" in p.stderr
    p = _run_py(["--workload", "ycb-serve-b64", "--seed", "3",
                 "--seconds", "1"], tmp_path)
    assert p.returncode != 0 and "{" not in p.stdout


def test_no_run_loads_jax_or_the_jax_package():
    script = ("import sys, time; sys.path.insert(0, '.');"
              "from perfbench.harness import Bench, run_cell,"
              " forbidden_modules;"
              "from perfbench.tests import tiny;"
              "b = Bench();"
              "[run_cell(b, w, 1, 0.3, t, time.perf_counter(), device='cpu',"
              " config=tiny.config(b.workload(w)['config']),"
              " traffic=tiny.traffic(b.workload(w)['traffic']),"
              " limits=tiny.limits())"
              " for w in ('ycb-serve-b64', 'linemod-eval-k4-b32',"
              " 'ycb-train-p1-b32') for t in (False, True)];"
              "mods = {m.split('.')[0] for m in sys.modules};"
              "print(sorted(forbidden_modules()),"
              " 'densefusion_tpu_torch' in mods)")
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "densefusion_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "densefusion_tpu.ops", object())
    assert forbidden_modules() == ["densefusion_tpu"]


def test_reference_imports_nothing_of_either_package():
    for path in (PERFBENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(densefusion_tpu|jax)",
                             text, re.M), path
