#!/usr/bin/env python3
"""Where kernel 6's bf16 route (``csrc/phase_conv_bf16.cu``) spends its
time: the kernel against copies of itself with parts of the work taken
out, at the decoder's three phase-conv shapes (B=64), on one card.

    python3 examples/gpu_phase_conv_bf16_probe.py [out.json]

The copies are built from this checkout's source with early-outs inserted
at three marked points (the source itself has none), each its own
``nvcc`` build into a temporary directory:

* ``loads_stores``: the consumers release every stage as soon as it has
  landed and issue no wgmma (the copies and the stores of zeros);
* ``mma_stores``: the producer arrives on each stage without copying
  anything (the wgmmas on whatever the ring holds, and the stores);
* ``loads_mma``: the epilogue stores nothing;
* ``mma``: neither copies nor stores: the wgmmas and the barriers alone.

Each is timed by CUDA-graph replay in turns with the whole kernel (kernel,
copy, copy, kernel) on the same channels-last inputs; the outputs of the
copies are not results. Where the whole kernel takes about as long as
``loads_stores``, the copies bound it; where about ``mma``, the tensor
cores. Prints one JSON object and, given a path, writes it there.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from densefusion_tpu_torch.ops import build, phase_conv  # noqa: E402

# (anchor in the source, text inserted after it)
HOOKS = {
    # the tile's last stage is released after the loop, as in the kernel
    "NO_MMA": ("      mbar_wait(&full[slot], (it / NSTAGE) & 1);\n",
               "#ifdef NO_MMA\n      if (lane == 0 && s + 1 < nstages) "
               "mbar_arrive(&empty[slot]);\n      continue;\n#endif\n"),
    "NO_LOAD": ("        __syncwarp();\n",
                "#ifdef NO_LOAD\n        if (lane == 0) mbar_expect("
                "&full[slot], 0);\n        continue;\n#endif\n"),
    # a runtime test, so the compiler keeps the epilogue and the wgmmas
    "NO_STORE": ("    wg_wait<0>();\n",
                 "#ifdef NO_STORE\n    if (lane == 0) mbar_arrive("
                 "&empty[(it - 1) % NSTAGE]);\n    if (Cout != -12345) "
                 "continue;\n#endif\n"),
}
VARIANTS = {"loads_stores": ["-DNO_MMA"], "mma_stores": ["-DNO_LOAD"],
            "loads_mma": ["-DNO_STORE"], "mma": ["-DNO_LOAD", "-DNO_STORE"]}


def hooked_source() -> str:
    """The kernel's source with the three early-outs, each under a macro."""
    src = (build.CSRC / "phase_conv_bf16.cu").read_text()
    for name, (anchor, text) in HOOKS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe hook {name}: anchor not found once")
        src = src.replace(anchor, anchor + text)
    return src


def build_variants(out: Path) -> dict:
    """``{variant: fn(xp, pk) -> out}``, all built at once."""
    src = out / "probe.cu"
    src.write_text(hooked_source())
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *flags, "-o",
         str(out / f"lib{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).phase_conv_bf16_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(xp, pk, fn=fn, name=name):
            b, cin, hp, wp = xp.shape
            o = torch.empty((b, pk.shape[-1], hp - 2, wp - 2),
                            device=xp.device, dtype=xp.dtype)
            err = fn(xp.data_ptr(), pk.data_ptr(), o.data_ptr(), b, cin,
                     pk.shape[-1], hp - 2, wp - 2,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} launch failed: {err}")
            return o
        fns[name] = call
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    fns = build_variants(Path(tempfile.mkdtemp(prefix="bf16_probe_")))
    kernel = phase_conv.phase_conv_bf16_kernel
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    result = {"card": cs.card_line(), "batch": cs.BATCH, "by_shape": {}}
    for name, hw, cin, cout in cs.DECODER_CONVS:
        xp = torch.randn((cs.BATCH, cin, hw + 2, hw + 2), device="cuda",
                         generator=gen).to(torch.bfloat16).contiguous(
                             memory_format=torch.channels_last)
        pk = (torch.randn((3, 3, cin, cout), device="cuda", generator=gen)
              / np.sqrt(9 * cin)).to(torch.bfloat16)
        bound, by = cs.conv_bound_ms(cs.BATCH, hw, hw, cin, cout, "bf16")
        entry = {"shape": f"B={cs.BATCH}, {hw}x{hw}, {cin} -> {cout}",
                 "bound_ms": bound, "bound_by": by}
        kernel_runs = []
        for variant, fn in fns.items():
            runs = [cs.graph_ms(lambda f=f: f(xp, pk), replays=20)
                    for f in (kernel, fn, fn, kernel)]
            kernel_runs += [runs[0], runs[3]]
            entry[f"{variant}_ms"] = (runs[1] + runs[2]) / 2
        entry["kernel_ms"] = sum(kernel_runs) / len(kernel_runs)
        entry["kernel_readings_ms"] = kernel_runs
        result["by_shape"][name] = entry
        print(f"{name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in entry.items()
            if k.endswith("_ms") and isinstance(v, float)), flush=True)
    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(text)


if __name__ == "__main__":
    main()
