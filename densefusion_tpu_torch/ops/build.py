"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<digest>.so`` inside
the package, at first use, and loaded with ``ctypes``; :class:`Kernel`
wraps one entry point. The digest covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt.
Nothing here runs at import time: the CPU tests import every module on
machines with no ``nvcc``.

The host data plane, ``csrc/dfnative.cpp``, takes its own route
(:func:`build_host`): ``g++`` with the JAX package's flags for its copy of
the same source, so the two libraries compute the same bytes, into
``build/libdfnative-<digest>.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
SOURCES = ("adds_remap", "add_dist", "nn", "phase_conv", "phase_conv_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCE = "dfnative"
# densefusion_tpu/native.py's command line, source and output aside
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
GXX_LIBS = ("-lz",)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, csrc: Path | None = None,
                 build: Path | None = None) -> Path:
    """Where ``<csrc>/<name>.cu`` builds to, in ``build`` (by default the
    package's ``csrc/`` and ``build/``). The digest covers the source, every
    header in ``csrc`` (any source may include any of them) and the
    flags."""
    csrc, build = csrc or CSRC, build or BUILD
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES, csrc: Path | None = None,
              build: Path | None = None) -> dict[str, dict]:
    """Compile every listed kernel of ``csrc`` that is not built yet into
    ``build`` (as :func:`library_path`), one ``nvcc`` per source, all
    started together. Returns ``{name: {"seconds", "log"}}`` (``log`` holds
    ``-Xptxas -v``'s register and shared-memory report). Raises with the
    compiler's output if any build fails."""
    csrc, build = csrc or CSRC, build or BUILD
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name, csrc, build)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def host_library_path(csrc: Path | None = None,
                      build: Path | None = None) -> Path:
    """Where ``<csrc>/dfnative.cpp`` builds to: ``build/libdfnative-
    <digest>.so``, the digest over the source and the flags."""
    csrc, build = csrc or CSRC, build or BUILD
    h = hashlib.sha256((csrc / f"{HOST_SOURCE}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return build / f"lib{HOST_SOURCE}-{h.hexdigest()[:16]}.so"


def build_host(csrc: Path | None = None,
               build: Path | None = None) -> dict:
    """Compile the host library with ``g++`` into :func:`host_library_path`
    (written under a per-process name, then renamed into place, so builds
    started together by several processes never expose half a file).
    Returns ``{"seconds", "log"}``; raises with the compiler's output if
    the build fails."""
    csrc, build = csrc or CSRC, build or BUILD
    build.mkdir(parents=True, exist_ok=True)
    out = host_library_path(csrc, build)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp),
           str(csrc / f"{HOST_SOURCE}.cpp"), *GXX_LIBS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not be run for {HOST_SOURCE}.cpp: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {HOST_SOURCE}.cpp:\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def cuda_device(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raises otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel} kernel: inputs must lie on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    return dev


class Kernel:
    """ctypes wrapper of one ``extern "C"`` entry point of
    ``csrc/<source>.cu``, whose arguments are ``argtypes`` then the CUDA
    stream and which returns a CUDA error code. Subclasses check their
    inputs, allocate the outputs and call :meth:`launch`. ``launches``
    counts the launches; nothing else changes it."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def launch(self, dev: torch.device, *args) -> None:
        """Run the entry point with ``args`` on ``dev``'s current stream
        (building the source first if needed); raises on a CUDA error."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
