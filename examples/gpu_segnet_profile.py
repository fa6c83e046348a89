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

With ``--backward``, the train step's backward at the benchmark cell's
shapes (B=3, 480x640): for each convolution, autograd's whole backward
(cuDNN's heuristic, TF32 off) and its kernels, the routes
``models.segnet.backward_route`` picks and their kernels, and dgrad and
wgrad by every candidate route (cuDNN on NCHW and on channels-last, the
forward of the flipped weights through cuDNN and through ATen's im2col +
GEMM, ATen's own backward, batched GEMMs with col2im / im2col) in turns;
then the whole train step with autograd's backward and with the rule's,
in turns.

    python examples/gpu_segnet_profile.py [out.json]
    python examples/gpu_segnet_profile.py --backward [out.json]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


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


def _conv_inputs(net, rgb) -> dict:
    """name -> the input of each conv in one train-mode forward of ``rgb``
    (no gradients)."""
    inputs = {}

    def keep(name):
        def hook(_mod, args, _out):
            inputs.setdefault(name, args[0].detach())
        return hook

    hooks = [m.register_forward_hook(keep(name))
             for name, m in net.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net.train()(rgb)
    for h in hooks:
        h.remove()
    return inputs


def _candidates():
    """(dgrad routes, wgrad routes): name -> fn(gy, x, w), all float32
    with TF32 off. The routes ``models.segnet.backward_route`` can pick
    are the module's own code; the others are written here."""
    import torch.nn.functional as F

    from densefusion_tpu_torch.models import segnet as sg

    def module(fn, route):
        return lambda gy, x, w: fn(route, gy, x, w)

    def d_cudnn_nhwc(gy, x, w):
        with sg._cudnn(True):
            return sg._conv_backward(sg._nhwc(gy), sg._nhwc(x), sg._nhwc(w),
                                     True, False)[0].contiguous()

    def d_cudnn_fwd_nhwc(gy, x, w):
        with sg._cudnn(True):
            return F.conv2d(sg._nhwc(gy),
                            sg._nhwc(w.flip((2, 3)).transpose(0, 1)),
                            padding=1).contiguous()

    def d_aten(gy, x, w):
        with sg._cudnn(False):
            return sg._conv_backward(gy, x, w, True, False)[0]

    def d_bmm_col2im(gy, x, w):
        b, cout, h, wd = gy.shape
        cols = torch.matmul(w.reshape(cout, -1).t(), gy.reshape(b, cout, -1))
        return F.fold(cols, (h, wd), 3, padding=1)

    def w_aten(gy, x, w):
        with sg._cudnn(False):
            return sg._conv_backward(gy, x, w, False, True)[1]

    def w_im2col_bmm(gy, x, w):
        b, cout = gy.shape[:2]
        cols = F.unfold(x, 3, padding=1)
        return torch.bmm(gy.reshape(b, cout, -1),
                         cols.transpose(1, 2)).sum(0).view_as(w)

    def w_im2col_mm(gy, x, w):
        b, cout = gy.shape[:2]
        cols = F.unfold(x, 3, padding=1)
        k = cols.shape[1]
        return torch.mm(gy.transpose(0, 1).reshape(cout, -1),
                        cols.transpose(0, 1).reshape(k, -1).t()).view_as(w)

    dgrads = {r: module(sg._dgrad, r) for r in ("cudnn", "cudnn_fwd",
                                                "aten_fwd")}
    dgrads.update(cudnn_nhwc=d_cudnn_nhwc, cudnn_fwd_nhwc=d_cudnn_fwd_nhwc,
                  aten=d_aten, bmm_col2im=d_bmm_col2im)
    wgrads = {r: module(sg._wgrad, r) for r in ("cudnn", "cudnn_nhwc")}
    wgrads.update(aten=w_aten, im2col_bmm=w_im2col_bmm,
                  im2col_mm=w_im2col_mm)
    return dgrads, wgrads


def _kernels(fn, iters: int = 2) -> list:
    """Device kernels of ``fn`` (ms a call, name), largest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append([us / iters / 1e3, e.key[:90]])
    rows.sort(reverse=True)
    return rows[:6]


def _backward_table(net, rgb, iters: int = 3, rounds: int = 3) -> list:
    """Each conv's backward at its shape in the train step: today's whole
    backward (autograd's ``convolution_backward``, cuDNN's heuristic) and
    its kernels, then dgrad and wgrad by every candidate route in turns
    (``rounds`` rounds of ``iters`` calls, CUDA events; min over rounds),
    each route's largest difference from today's result over its largest
    element, and the extra peak memory it allocates."""
    from densefusion_tpu_torch.models import segnet as sg

    inputs = _conv_inputs(net, rgb)
    dgrads, wgrads = _candidates()
    gen = torch.Generator(device=rgb.device).manual_seed(1)
    rows = []
    for name, x in inputs.items():
        conv = net.get_submodule(name)
        w = conv.weight.detach()
        b, cin, h, wd = x.shape
        cout = w.shape[0]
        gy = torch.randn((b, cout, h, wd), generator=gen, device=x.device)
        first = name == "conv11"   # its input needs no gradient
        row = {"conv": name, "b": b, "cin": cin, "cout": cout, "h": h,
               "w": wd, "gflop": 2 * b * h * wd * cin * 9 * cout / 1e9}

        def today():
            return sg._conv_backward(gy, x, w, not first, True, True)

        droute, wroute = sg.backward_route(x, w)
        row["rule"] = [None if first else droute, wroute]

        def rule():
            return (None if first else sg._dgrad(droute, gy, x, w),
                    sg._wgrad(wroute, gy, x, w), gy.sum((0, 2, 3)))

        ref = today()
        row["today_kernels"] = _kernels(today)
        row["rule_kernels"] = _kernels(rule)
        sets = [("w", wgrads, ref[1])]
        if not first:
            sets.insert(0, ("d", dgrads, ref[0]))
        for key, routes, want in sets:
            scale = float(want.abs().max())
            for rname, fn in routes.items():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                got = fn(gy, x, w)
                torch.cuda.synchronize()
                row[f"{key}_{rname}_gap"] = float(
                    (got - want).abs().max()) / scale
                row[f"{key}_{rname}_extra_mb"] = (
                    torch.cuda.max_memory_allocated() - base) / 2**20
                del got
        times = {}
        for _ in range(rounds):
            times.setdefault("today", []).append(_events_ms(today, iters))
            times.setdefault("rule", []).append(_events_ms(rule, iters))
            for key, routes, _want in sets:
                for rname, fn in routes.items():
                    times.setdefault(f"{key}_{rname}", []).append(
                        _events_ms(lambda: fn(gy, x, w), iters))
        for k, v in times.items():
            row[f"{k}_ms"] = min(v)
        for key in ("d", "w"):
            cand = {k[2:-3]: v for k, v in row.items()
                    if k.startswith(f"{key}_") and k.endswith("_ms")}
            if cand:
                row[f"{key}_best"] = min(cand, key=cand.get)
        rows.append(row)
        print(json.dumps({k: row[k] for k in row
                          if k.endswith(("_ms", "best")) or k in
                          ("conv", "cin", "cout", "h", "rule")}), flush=True)
        del gy
    return rows


def _step_turns(b, h, w, classes, rounds: int = 3, iters: int = 5) -> dict:
    """The train step at (b, h, w) with autograd's backward ("today":
    ``backward_route`` patched to autograd's) and with the rule's, in turns
    (today, rule, rule, today per round): ms a step by CUDA events, each
    mode's peak memory, and the routes one rule step takes."""
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.models import segnet as sg
    from densefusion_tpu_torch.train.seg import (
        create_seg_train_state, make_seg_train_step,
    )

    rng = np.random.default_rng(1)
    rgb = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(
        np.float32)).cuda()
    label = torch.from_numpy(rng.integers(0, classes, (b, h, w))).cuda()
    step = make_seg_train_step(create_seg_train_state(SegNet(classes),
                                                      seed=0))
    rule = sg.backward_route
    out = {"today_ms": [], "rule_ms": []}

    def run(mode):
        sg.backward_route = (rule if mode == "rule" else
                             lambda x, wt: ("autograd", "autograd"))
        try:
            step(rgb, label)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = sg.backward_routes()
            out[f"{mode}_ms"].append(
                _events_ms(lambda: step(rgb, label), iters))
            out[f"{mode}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if mode == "rule":
                out["rule_routes_a_step"] = {
                    f"{g}/{r}": n / iters for (g, r), n in
                    (sg.backward_routes() - before).items()}
        finally:
            sg.backward_route = rule

    for _ in range(rounds):
        for mode in ("today", "rule", "rule", "today"):
            run(mode)
    out["today_median_ms"] = float(np.median(out["today_ms"]))
    out["rule_median_ms"] = float(np.median(out["rule_ms"]))
    return out


def backward_main(out_path: str | None = None) -> dict:
    """The per-conv backward table at the cell's shapes (B=3, 480x640, 22
    classes, full widths), then the train step with autograd's backward
    and with the rule's, in turns."""
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import create_seg_train_state
    from densefusion_tpu_torch.device import card_line

    b, h, w, classes = 3, 480, 640, 22
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(
        np.float32)).cuda()
    net = create_seg_train_state(SegNet(classes), seed=0).segnet
    out = {"card": card_line(), "shape": [b, h, w, classes],
           "torch": torch.__version__,
           "cudnn": torch.backends.cudnn.version()}
    out["backward"] = _backward_table(net, rgb)
    del net, rgb
    torch.cuda.empty_cache()
    out["step_turns"] = _step_turns(b, h, w, classes)
    print(json.dumps(out["step_turns"]), flush=True)
    text = json.dumps(out, indent=1)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")
    return out


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

    from densefusion_tpu_torch.device import card_line

    out = {"card": card_line(), "shape": [b, h, w, classes]}
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
    args = sys.argv[1:]
    if "--backward" in args:
        args.remove("--backward")
        backward_main(args[0] if args else None)
    else:
        main(args[0] if args else None)
