"""Where SegNet's time goes on the card: the ``bench_seg`` shapes (B=4,
480x640, 22 classes, float32, TF32 off, seeded weights and inputs).

With cuDNN's heuristic algorithm choice and with its autotuner
(``torch.backends.cudnn.benchmark``), in turns in one process: times the
train step, the inference pass and the train-mode forward with CUDA
events, traces a few of each with ``torch.profiler``, and prints, as JSON,
the device time by kernel (top 15 each), the device busy time over the
wall time, and the card's name and power limit; then each convolution
alone at its shape and at B=8 and 1, through cuDNN (NCHW, channels_last,
channel counts padded with zeros to multiples of 8) and through ATen's own
convolution.

    python examples/gpu_segnet_profile.py [out.json]
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _events_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _trace(fn, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue    # host-side ops and the profiler's own records
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / iters / 1e3, e.count // iters, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms,
            "top": [{"ms": ms, "calls": n, "name": k[:120]}
                    for ms, n, k in rows[:15]]}


def _conv_table(net, rgb, batches=(4, 8, 1)) -> list:
    """Each conv of the forward alone at its input shape, at each batch in
    ``batches`` (no gradients): F.conv2d's ms through cuDNN in NCHW and in
    channels_last, and (where a channel count is not a multiple of 8) NCHW
    with zero channels padding both to one; and ATen's own convolution
    with cuDNN off (im2col and a cuBLAS GEMM); heuristic algorithm."""
    import torch.nn.functional as F

    inputs = {}

    def keep(name):
        def hook(_mod, args, _out):
            inputs.setdefault(name, args[0].detach())
        return hook

    hooks = [m.register_forward_hook(keep(name))
             for name, m in net.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net.eval()(rgb)
    for h in hooks:
        h.remove()
    rows = []
    for bsz in batches:
        for name, x4 in inputs.items():
            x = x4.repeat(-(-bsz // x4.shape[0]), 1, 1, 1)[:bsz].contiguous()
            conv = net.get_submodule(name)
            row = {"conv": name, "input": list(x.shape),
                   "cout": conv.out_channels}
            variants = {
                "nchw": (x, conv.weight, conv.bias, None),
                "channels_last": (
                    x.contiguous(memory_format=torch.channels_last),
                    conv.weight.contiguous(memory_format=torch.channels_last),
                    conv.bias, None)}
            cin, cout = x.shape[1], conv.out_channels
            pin, pout = -cin % 8, -cout % 8
            if pin or pout:
                variants["padded8"] = (
                    F.pad(x, (0, 0, 0, 0, 0, pin)),
                    F.pad(conv.weight, (0, 0, 0, 0, 0, pin, 0, pout)),
                    F.pad(conv.bias, (0, pout)), cout)
            for key, (xv, wv, bv, keep_c) in variants.items():
                with torch.no_grad():
                    row[f"{key}_ms"] = _events_ms(
                        lambda: F.conv2d(xv, wv, bv, padding=1)[:, :keep_c],
                        3)
            with torch.no_grad(), torch.backends.cudnn.flags(enabled=False):
                row["aten_ms"] = _events_ms(
                    lambda: F.conv2d(x, conv.weight, conv.bias, padding=1), 3)
            rows.append(row)
    return rows


def main(out_path: str | None = None) -> dict:
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import (
        create_seg_train_state, make_seg_train_step,
    )

    b, h, w, classes = 4, 480, 640, 22
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(
        np.float32)).cuda()
    label = torch.from_numpy(rng.integers(0, classes, (b, h, w))).cuda()
    state = create_seg_train_state(SegNet(classes), seed=0)
    step = make_seg_train_step(state)
    net = state.segnet

    def train():
        step(rgb, label)

    @torch.no_grad()
    def infer():
        net.eval()
        net(rgb).argmax(1)

    @torch.no_grad()
    def forward_train_mode():
        net.train()
        net(rgb)

    out = {"card": _card(), "shape": [b, h, w, classes]}
    for autotune in (False, True, False, True):
        torch.backends.cudnn.benchmark = autotune
        key = "autotuned" if autotune else "heuristic"
        for name, fn in (("train_step", train), ("inference", infer),
                         ("forward_train_mode_no_grad", forward_train_mode)):
            fn()
            fn()
            row = out.setdefault(key, {}).setdefault(name, {"events_ms": []})
            row["events_ms"].append(_events_ms(fn, 5))
            if "top" not in row:
                row.update(_trace(fn, 3))
    torch.backends.cudnn.benchmark = False
    out["convs"] = _conv_table(net, rgb)
    text = json.dumps(out, indent=1)
    print(text)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
