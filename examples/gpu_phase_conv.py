#!/usr/bin/env python3
"""Kernel 6 (``csrc/phase_conv.cu``) against the library convolution at the
decoder's three half-res phase-conv shapes (B=64, float32, TF32 off), and
the whole ``phase_upsample_conv3x3`` stages under both conv backends: the
counterpart of ``examples/tpu_up1_pallas.py``.

    python3 examples/gpu_phase_conv.py [out.json] [--parent DIR]

Shapes (``chip_smoke.DECODER_CONVS``, 192 px crops):

    up1:  24x24 x1024 -> 1024 (4 phases x 256)
    up2:  48x48 x 256 ->  256 (4 phases x 64)
    up3:  96x96 x  64 ->  256 (4 phases x 64)

Each pair is timed in turns (library, kernel, kernel, library) with CUDA
events over back-to-back calls after a warm-up, on one card, so the two are
compared within one process. Beside each: the kernel's two bounds
(``chip_smoke.conv_bound_ms``: its own 3xTF32 arithmetic on the tensor
cores, and the FFMA bound of a float32 kernel on the CUDA cores) and the
largest difference between the two outputs, relative to the largest
output. The whole ``phase_upsample_conv3x3`` stage is timed the same way
under ``conv_backend="library"`` and ``"kernel"``; ``"auto"`` is the
kernel on the card. Last, the serving pipeline at B=64, K=2 (``chip_smoke``'s
estimator and batch) in turns with ``"auto"`` resolved to the library and
to the kernel, so the end-to-end gain is read on one card and one host.
The bf16 route (``csrc/phase_conv_bf16.cu``) is timed the same way against
``F.conv2d`` in bf16 on the same channels-last map, beside its bound at
the dense bf16 peak.

``--parent DIR``: another checkout's ``csrc/phase_conv.cu`` and
``csrc/phase_conv_bf16.cu`` (``git archive`` it into a gitignored
``_work/``), built into a directory of their own and timed in turns with
this checkout's kernels (parent, change, change, parent) on the same
inputs: the float32 route with the largest difference between the two
outputs (whether it moved), the bf16 route with the largest difference in
bf16 ulps (``chip_smoke.bf16_ulps``). Each bf16 kernel gets the layout its
checkout's wrapper takes (``PhaseConvKernel.layout``; a checkout without
one took contiguous NCHW), from the same values. The whole
``phase_upsample_conv3x3`` stage in bf16 (``conv_backend="kernel"``, the
pad included) is timed the same way against the parent's package, run in
a subprocess of its own, at the same shapes and seed.
Prints one JSON object and, given a path, writes it there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from densefusion_tpu_torch.models.layers import (  # noqa: E402
    phase_upsample_conv3x3,
)
from densefusion_tpu_torch.ops import build, phase_conv  # noqa: E402


def in_turns(first, second, iters: int) -> dict:
    """Mean ms of ``first`` and ``second`` over ``iters`` calls each, timed
    first, second, second, first; each reading and the two means."""
    runs = [cs.cuda_ms(fn, iters=iters, warmup=2)
            for fn in (first, second, second, first)]
    return {"readings_ms": runs, "first_ms": (runs[0] + runs[3]) / 2,
            "second_ms": (runs[1] + runs[2]) / 2}


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


def pipeline_in_turns() -> dict:
    """The fused-decoder pipeline at B=64, K=2 with inputs on the card,
    ``"auto"`` resolved to "library" and to "kernel" in turns."""
    from densefusion_tpu_torch.data import collate

    rng = np.random.default_rng(cs.SEED)
    est, _ = cs.seeded_estimator(rng)
    frames = [cs.make_frame(rng) for _ in range(20)]
    b = collate(cs.batch_samples(est, frames, cs.BATCH))
    args = (torch.as_tensor(b.img, device="cuda"),
            torch.as_tensor(b.points, device="cuda"),
            torch.as_tensor(b.choose, device="cuda").long(),
            torch.as_tensor(b.obj_idx, device="cuda").long())
    resolve = phase_conv.auto_backend

    def run(route):
        def call():
            phase_conv.auto_backend = lambda device: route
            try:
                est.pipeline(*args)
            finally:
                phase_conv.auto_backend = resolve
        return call

    t = in_turns(run("library"), run("kernel"), iters=20)
    return {"shape": f"B={cs.BATCH}, K={cs.REFINE_ITERS}, fused decoder",
            "library_ms": t["first_ms"], "kernel_ms": t["second_ms"],
            "readings_ms": t["readings_ms"],
            "frames_per_s": {"library": cs.BATCH * 1e3 / t["first_ms"],
                             "kernel": cs.BATCH * 1e3 / t["second_ms"]}}


def parent_kernel(parent: Path, source: str = "phase_conv"):
    """Kernel 6's entry point ``source`` (``phase_conv`` or
    ``phase_conv_bf16``) of another checkout, built from its ``csrc/`` into
    a temporary directory: ``fn(xp, pk) -> out`` of xp's type."""
    out = Path(tempfile.mkdtemp(prefix=f"{source}_parent_"))
    csrc = parent / "densefusion_tpu_torch" / "csrc"
    build.build_all((source,), csrc=csrc, build=out)
    lib = ctypes.CDLL(str(build.library_path(source, csrc, out)))
    fn = getattr(lib, f"{source}_launch")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(xp, pk):
        b, cin, hp, wp = xp.shape
        o = torch.empty((b, pk.shape[-1], hp - 2, wp - 2), device=xp.device,
                        dtype=xp.dtype)
        err = fn(xp.data_ptr(), pk.data_ptr(), o.data_ptr(), b, cin,
                 pk.shape[-1], hp - 2, wp - 2,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent {source} launch failed: {err}")
        return o
    return call


def parent_bf16_layout(parent: Path) -> torch.memory_format:
    """The map layout the parent's bf16 kernel takes: channels-last where
    its wrapper says so (``layout``), contiguous NCHW before that."""
    text = (parent / "densefusion_tpu_torch" / "ops"
            / "phase_conv.py").read_text()
    return torch.channels_last if "torch.channels_last" in text \
        else torch.contiguous_format


STAGE_SCRIPT = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from densefusion_tpu_torch.models.layers import phase_upsample_conv3x3
gen = torch.Generator("cuda").manual_seed(cs.SEED)
out = {}
for name, hw, cin, cout in cs.DECODER_CONVS:
    x = torch.randn((cs.BATCH, cin, hw, hw), device="cuda",
                    generator=gen).to(torch.bfloat16)
    k = (torch.randn((cout // 4, cin, 3, 3), device="cuda", generator=gen)
         / np.sqrt(9 * cin)).to(torch.bfloat16)
    bias = (0.1 * torch.randn((cout // 4,), device="cuda",
                              generator=gen)).to(torch.bfloat16)
    out[name] = [cs.cuda_ms(lambda: phase_upsample_conv3x3(
        x, k, bias, border="replicate", conv_backend="kernel"), iters=10,
        warmup=2) for _ in range(int(sys.argv[2]))]
print(json.dumps(out))
"""


def stage_bf16_ms(root: Path, readings: int) -> dict:
    """``readings`` timings of the whole bf16 ``phase_upsample_conv3x3``
    stage (kernel route) at each decoder shape, by ``root``'s package in a
    process of its own."""
    import subprocess

    done = subprocess.run([sys.executable, "-c", STAGE_SCRIPT, str(root),
                           str(readings)], capture_output=True, text=True,
                          check=True, timeout=600)
    return json.loads(done.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from densefusion_tpu_torch.device import precision_policy, resolve_device
    dev = resolve_device("cuda")
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    b = cs.BATCH
    result = {"card": cs.card_line(), "precision": precision_policy(),
              "batch": b, "conv": {}, "stage": {}, "bf16": {}, "parent": {}}
    parent = parent_kernel(args.parent) if args.parent else None
    parent_bf16 = parent_kernel(args.parent, "phase_conv_bf16") \
        if args.parent else None
    bf16_layout = phase_conv.phase_conv_bf16_kernel.layout
    for name, hw, cin, cout in cs.DECODER_CONVS:
        xp = torch.randn((b, cin, hw + 2, hw + 2), device=dev, generator=gen)
        pk = torch.randn((3, 3, cin, cout), device=dev,
                         generator=gen) / np.sqrt(9 * cin)
        w_oihw = pk.permute(3, 2, 0, 1).contiguous()
        t = in_turns(lambda: F.conv2d(xp, w_oihw),
                     lambda: phase_conv.phase_conv_kernel(xp, pk), iters=10)
        bound, by = cs.conv_bound_ms(b, hw, hw, cin, cout)
        ffma, _ = cs.conv_bound_ms(b, hw, hw, cin, cout, "ffma")
        result["conv"][name] = {
            "shape": f"B={b}, {hw}x{hw}, {cin} -> {cout}",
            "library_ms": t["first_ms"], "kernel_ms": t["second_ms"],
            "readings_ms": t["readings_ms"], "bound_ms": bound,
            "bound_by": by, "bound_ffma_ms": ffma,
            "kernel_over_bound": t["second_ms"] / bound,
            "kernel_over_library": t["second_ms"] / t["first_ms"],
            "rel_diff": rel_diff(phase_conv.phase_conv_kernel(xp, pk),
                                 F.conv2d(xp, w_oihw))}
        if parent is not None:
            runs = [cs.graph_ms(lambda: fn(xp, pk), replays=20)
                    for fn in (parent, phase_conv.phase_conv_kernel,
                               phase_conv.phase_conv_kernel, parent)]
            result["parent"][name] = {
                "parent_ms": (runs[0] + runs[3]) / 2,
                "change_ms": (runs[1] + runs[2]) / 2, "readings_ms": runs,
                "max_abs_diff": float((parent(xp, pk) - phase_conv
                                       .phase_conv_kernel(xp, pk))
                                      .abs().max())}
        xb = xp.to(torch.bfloat16).contiguous(memory_format=bf16_layout)
        pb = pk.to(torch.bfloat16)
        # the OIHW weight in the map's layout, so cuDNN converts neither
        wb = pb.permute(3, 2, 0, 1).contiguous(memory_format=bf16_layout)
        t = in_turns(lambda: F.conv2d(xb, wb),
                     lambda: phase_conv.phase_conv_bf16_kernel(xb, pb),
                     iters=10)
        bound, by = cs.conv_bound_ms(b, hw, hw, cin, cout, "bf16")
        result["bf16"][name] = {
            "library_ms": t["first_ms"], "kernel_ms": t["second_ms"],
            "readings_ms": t["readings_ms"], "bound_ms": bound,
            "bound_by": by, "kernel_over_bound": t["second_ms"] / bound,
            "kernel_over_library": t["second_ms"] / t["first_ms"]}
        if parent_bf16 is not None:
            for bsz in (b, cs.TRAIN_BATCH, 1):
                xs = xb[:bsz]
                xq = xs.contiguous(memory_format=parent_bf16_layout(
                    args.parent))
                runs = [cs.graph_ms(lambda: fn(x_, pb), replays=20)
                        for fn, x_ in ((parent_bf16, xq),
                                       (phase_conv.phase_conv_bf16_kernel,
                                        xs),
                                       (phase_conv.phase_conv_bf16_kernel,
                                        xs),
                                       (parent_bf16, xq))]
                result["parent"][f"bf16 {name} B={bsz}"] = {
                    "parent_ms": (runs[0] + runs[3]) / 2,
                    "change_ms": (runs[1] + runs[2]) / 2,
                    "readings_ms": runs,
                    "speedup": (runs[0] + runs[3]) / (runs[1] + runs[2]),
                    "max_ulps": cs.bf16_ulps(
                        phase_conv.phase_conv_bf16_kernel(xs, pb),
                        parent_bf16(xq, pb))}

        # the whole stage (replicate border), one quarter the phase channels
        x = torch.randn((b, cin, hw, hw), device=dev, generator=gen)
        k = torch.randn((cout // 4, cin, 3, 3), device=dev,
                        generator=gen) / np.sqrt(9 * cin)
        bias = 0.1 * torch.randn((cout // 4,), device=dev, generator=gen)

        def stage(backend):
            return phase_upsample_conv3x3(x, k, bias, border="replicate",
                                          conv_backend=backend)

        t = in_turns(lambda: stage("library"), lambda: stage("kernel"),
                     iters=10)
        result["stage"][name] = {
            "shape": f"B={b}, {hw}x{hw}, {cin} -> {cout // 4} at "
                     f"{2 * hw}x{2 * hw}",
            "library_ms": t["first_ms"], "kernel_ms": t["second_ms"],
            "readings_ms": t["readings_ms"],
            "rel_diff": rel_diff(stage("kernel"), stage("library"))}
    if args.parent is not None:   # the whole bf16 stage, pad included
        runs = [stage_bf16_ms(root, 2)
                for root in (args.parent, ROOT, ROOT, args.parent)]
        for name, *_ in cs.DECODER_CONVS:
            par = runs[0][name] + runs[3][name]
            chg = runs[1][name] + runs[2][name]
            result["parent"][f"bf16 stage {name}"] = {
                "parent_ms": sum(par) / len(par),
                "change_ms": sum(chg) / len(chg),
                "readings_ms": [r[name] for r in runs]}
    result["pipeline"] = pipeline_in_turns()
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
