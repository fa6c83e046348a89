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
from densefusion_tpu_torch.ops import knn
from densefusion_tpu_torch.serve import PoseEstimator

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
    # chip_smoke.py's imports, without running it
    "import importlib.util as u\n"
    "spec = u.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
    "spec.loader.exec_module(u.module_from_spec(spec))",
])
def test_port_imports_no_jax(extra):
    assert _probe(extra) == []


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


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
    assert resolve_device("cpu") == torch.device("cpu")


def test_remap_kernel_has_no_cpu_fallback():
    """The kernel wrapper refuses CPU tensors instead of computing the plain
    version, and a failed launch leaves the launch count unchanged."""
    before = knn.adds_remap_kernel.launches
    x = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError):
        knn.adds_remap_kernel(x, x)
    assert knn.adds_remap_kernel.launches == before
