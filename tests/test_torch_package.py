"""Rules every slice of the port keeps: the package imports no JAX and
nothing of the JAX package (checked in a fresh interpreter, since this test
process has both loaded), and nothing falls back to the CPU or to a plain
version when CUDA is absent."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.eval import InferencePipeline
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
from densefusion_tpu_torch.cli.benchmark import bench_knn
from densefusion_tpu_torch.ops import add_dist, knn, phase_conv
from densefusion_tpu_torch.parallel import initialize_distributed, make_mesh
from densefusion_tpu_torch.serve import PoseEstimator
from densefusion_tpu_torch.train import create_train_state

ROOT = Path(__file__).resolve().parent.parent

# Lists the JAX-side modules present in sys.modules after the given imports.
_PROBE = """
import importlib, json, pkgutil, sys
import densefusion_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
{extra}
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "densefusion_tpu" or n.startswith("densefusion_tpu."))
print(json.dumps(bad))
"""


def _probe(extra: str = "") -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(extra=extra)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [
    "",
    # the decoder's kernel route and the decoders that reach it
    "from densefusion_tpu_torch.ops.phase_conv import conv3x3_valid\n"
    "from densefusion_tpu_torch.models import PoseNet\n"
    "PoseNet(2, fused_decoder=False); PoseNet(2, align_corners=True)",
    # chip_smoke.py's imports, without running it
    "import importlib.util as u\n"
    "spec = u.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
    "spec.loader.exec_module(u.module_from_spec(spec))",
])
def test_port_imports_no_jax(extra):
    assert _probe(extra) == []


# Reads a YCB training sample through the port (the host library on every
# path it has) and lists the mapped dfnative libraries.
_MAPS_PROBE = """
import json, sys, tempfile
from densefusion_tpu_torch import native
from densefusion_tpu_torch.data import YCBDataset, generate_ycb_style_dataset
root = tempfile.mkdtemp(dir=sys.argv[1])
generate_ycb_style_dataset(root, n_classes=2, n_real=2, n_syn=2, n_test=1,
                           seed=0)
ds = YCBDataset(root, "train", num_points=32, crop_size=32)
assert all(ds[i].valid for i in range(len(ds)))
with open("/proc/self/maps") as f:
    maps = sorted({ln.split()[-1] for ln in f if "dfnative" in ln})
print(json.dumps({"maps": maps, "lib": native._load()._name,
                  "modules": sorted(n for n in sys.modules
                                    if n.split(".")[0] in
                                    ("jax", "densefusion_tpu"))}))
"""


def test_port_maps_only_its_own_host_library(tmp_path):
    """The port's readers load the port's build of ``csrc/dfnative.cpp``
    from its ``build/``, never ``runtime/libdfnative.so``, and never import
    ``densefusion_tpu.native`` (or anything of the JAX package)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _MAPS_PROBE, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    lib = Path(got["lib"])
    assert lib.parent == ROOT / "densefusion_tpu_torch" / "build"
    assert lib.name.startswith("libdfnative-")
    assert [Path(m) for m in got["maps"]] == [lib]
    assert got["modules"] == []


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A copy of ``chip_smoke.py`` in a directory that holds nothing else of
    the repository exits 1 with no result: it cannot import the port from
    its own checkout. (This is the exit 1 of a run of the script alone; the
    script in its checkout exits 0 on the card when every check passes.)"""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert '"ok"' not in out.stdout
    assert "checkout" in out.stderr


def test_no_device_means_cuda_or_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferencePipeline(PoseNet(2), PoseRefineNet(2), refine_iters=2)
    pose, ref = PoseNet(2), PoseRefineNet(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseEstimator(pose, ref, pose.state_dict(), ref.state_dict())
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(pose, ref, 1e-4, 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_remap_kernel_has_no_cpu_fallback():
    """The kernel wrapper refuses CPU tensors instead of computing the plain
    version, and a failed launch leaves the launch count unchanged."""
    before = knn.adds_remap_kernel.launches
    x = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError):
        knn.adds_remap_kernel(x, x)
    assert knn.adds_remap_kernel.launches == before


@pytest.mark.parametrize("kernel", [add_dist.paired_kernel,
                                    add_dist.min_kernel],
                         ids=["paired", "min"])
def test_add_dist_kernels_have_no_cpu_fallback(kernel):
    """The ADD / ADD-S kernel wrappers refuse CPU tensors instead of
    computing the plain version; the launch count stays unchanged."""
    before = kernel.launches
    R = torch.eye(3).expand(1, 2, 3, 3).contiguous()
    t, pts = torch.zeros((1, 2, 3)), torch.zeros((1, 4, 3))
    with pytest.raises(ValueError):
        kernel(R, t, pts, pts, torch.ones(1, dtype=torch.int32))
    assert kernel.launches == before


@pytest.mark.parametrize("kernel", [knn.nn_kernel, knn.nn_batched_kernel],
                         ids=["nn", "nn_batched"])
def test_nn_kernels_have_no_cpu_fallback(kernel):
    """The 1-NN kernel wrappers refuse CPU tensors instead of computing the
    plain version; the launch count stays unchanged."""
    before = kernel.launches
    x = torch.zeros((1, 4, 3) if kernel.batched else (4, 3))
    with pytest.raises(ValueError):
        kernel(x, x)
    assert kernel.launches == before


def test_phase_conv_kernel_has_no_cpu_fallback():
    """The kernel route reaches the kernel wrapper only for CUDA tensors;
    the wrapper itself refuses CPU tensors instead of computing the plain
    version, and the launch count stays unchanged."""
    kernel = phase_conv.phase_conv_kernel
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(torch.zeros((1, 2, 5, 5)), torch.zeros((3, 3, 2, 4)))
    assert kernel.launches == before


def test_mesh_and_benchmark_need_cuda_or_cpu():
    """Without a card, the mesh (NCCL by default) and the KNN benchmark
    raise unless given ``device="cpu"``; no process group is started."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (make_mesh, initialize_distributed, bench_knn):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not torch.distributed.is_initialized()


def test_build_digest_covers_headers(tmp_path, monkeypatch):
    """A kernel's library path changes when its source, or any shared
    ``csrc/*.cuh`` header it may include, changes; an unrelated file does
    not move it. So an edited header is never served from a stale build."""
    from densefusion_tpu_torch.ops import build

    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "scan.cuh"\n')
    (tmp_path / "scan.cuh").write_text("// v1\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "notes.txt").write_text("not a header")
    assert build.library_path("k") == first
    (tmp_path / "scan.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first and second.parent == build.BUILD
    (tmp_path / "extra.cuh").write_text("// new header\n")
    assert build.library_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "scan.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)


def test_data_benchmarks_need_cuda_or_cpu():
    """Without a card, the loader and loader-fed training benchmarks raise
    before they generate or read any data, unless given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from densefusion_tpu_torch.cli.benchmark import (
        bench_loader, bench_train_e2e,
    )
    for call in (bench_loader, bench_train_e2e):
        with pytest.raises(RuntimeError, match="CUDA"):
            call(dataset_root="/nonexistent")
