#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device and exits non-zero
without one, or when any phase fails. Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the serving path from ``densefusion_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card (the remap at
   the scoring shape, at a ragged shape with a gated row, on exact ties);
4. the main path at the YCB width (21 objects, N=1000 points, 192 px crops,
   K=2 refine iterations, random weights from the seed, made as the JAX
   package's parameter trees and carried across by
   ``densefusion_tpu_torch.compat``): ``estimate_frame``
   requests on 480x640 RGB-D frames, ``estimate_batch`` at B=64, and
   ``pose_distances`` on the result, with every kernel's launch count
   reset just before and read just after;
5. the same B=8 batch on the card and on the CPU, with TF32 off, must agree;
6. timings: pose frames/s at B=64, and each kernel's, its plain version's
   and the build's time;
7. a JSON line listing every ported kernel (``kernels``);
8. the card's name and power limit, then ``{"ok": true, "device": ...}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

NUM_OBJ, NUM_POINTS, CROP, REFINE_ITERS = 21, 1000, 192, 2
BATCH, NUM_MESH = 64, 500
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, replays: int = 200) -> float:
    """Device time of one ``fn`` captured in a CUDA graph and replayed: the
    host's per-call launch cost drops out, leaving the kernels' own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=replays)


# ---------------------------------------------------------------------------
# Inputs made from the seed
# ---------------------------------------------------------------------------

def _dense(cin: int, cout: int) -> dict:
    return {"kernel": (cin, cout), "bias": (cout,)}


def posenet_param_shapes(num_obj: int, emb: int = 32) -> dict:
    """The JAX package's PoseNet parameter tree (resnet18 trunk), as shapes."""
    trunk, cin = {"stem": {"kernel": (7, 7, 3, 64)}}, 64
    for s, (cout, stride) in enumerate(((64, 1), (128, 2), (256, 1),
                                        (512, 1)), start=1):
        for b in range(2):
            blk = {"conv1": {"kernel": (3, 3, cin, cout)},
                   "conv2": {"kernel": (3, 3, cout, cout)}}
            if b == 0 and (stride != 1 or cin != cout):
                blk["proj"] = {"kernel": (1, 1, cin, cout)}
            trunk[f"stage{s}_block{b}"], cin = blk, cout
    cnn = {
        "trunk": trunk,
        "psp": {**{f"prior_{k}": {"kernel": (1, 1, 512, 512)}
                   for k in (1, 2, 3, 6)},
                "bottleneck": {"kernel": (1, 1, 2560, 1024),
                               "bias": (1024,)}},
        "up1": {"conv": {"kernel": (3, 3, 1024, 256), "bias": (256,)},
                "prelu": {"slope": ()}},
        "up2": {"conv": {"kernel": (3, 3, 256, 64), "bias": (64,)},
                "prelu": {"slope": ()}},
        "up3_conv": {"kernel": (3, 3, 64, 64), "bias": (64,)},
        "up3_prelu": {"slope": ()},
        "final": {"kernel": (1, 1, 64, emb), "bias": (emb,)},
    }
    fusion = {"geo1": _dense(3, 64), "geo2": _dense(64, 128),
              "col1": _dense(emb, 64), "col2": _dense(64, 128),
              "mix1": _dense(256, 512), "mix2": _dense(512, 1024)}
    heads = {f"head_{c}": {f"fc{i}": _dense(a, b) for i, (a, b) in enumerate(
        zip((1408, 640, 256, 128), (640, 256, 128, num_obj * d)), start=1)}
        for c, d in (("r", 4), ("t", 3), ("c", 1))}
    return {"params": {"cnn": cnn, "fusion": fusion, **heads}}


def refiner_param_shapes(num_obj: int, emb: int = 32) -> dict:
    """The JAX package's PoseRefineNet parameter tree, as shapes."""
    fusion = {"geo1": _dense(3, 64), "geo2": _dense(64, 128),
              "col1": _dense(emb, 64), "col2": _dense(64, 128),
              "mix1": _dense(384, 512), "mix2": _dense(512, 1024)}
    heads = {f"head_{c}_fc{i}": _dense(a, b)
             for c, d in (("r", 4), ("t", 3))
             for i, (a, b) in enumerate(zip((1024, 512, 128),
                                            (512, 128, num_obj * d)),
                                        start=1)}
    return {"params": {"fusion": fusion, **heads}}


def seeded_estimator(rng, states=None, device=None):
    """The YCB-width PoseEstimator with weights drawn from ``rng`` as the
    JAX package's parameter trees and carried across by the port's
    ``compat`` -> (estimator, (posenet_state, refiner_state)). Given
    ``states``, reuses them instead."""
    from densefusion_tpu_torch import compat
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.serve import PoseEstimator

    if states is None:
        states = (compat.posenet_state_dict_from_flax(
                      seeded_params(posenet_param_shapes(NUM_OBJ), rng)),
                  compat.refiner_state_dict_from_flax(
                      seeded_params(refiner_param_shapes(NUM_OBJ), rng)))
    est = PoseEstimator(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ), *states,
                        num_points=NUM_POINTS, crop_size=CROP,
                        refine_iters=REFINE_ITERS, seed=SEED, device=device)
    return est, states


def seeded_params(shapes: dict, rng: np.random.Generator,
                  path: tuple = ()) -> dict:
    """Fill a shape tree from ``rng`` at a realistic scale: kernels
    N(0, 1/fan_in), biases N(0, 0.05^2), PReLU slopes 0.25; the confidence
    head's last layer 8x wider, so hypotheses separate."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = seeded_params(v, rng, path + (k,))
        elif k == "slope":
            out[k] = np.full(v, 0.25, np.float32)
        elif k == "bias":
            out[k] = (0.05 * rng.standard_normal(v)).astype(np.float32)
        else:
            w = rng.standard_normal(v) / np.sqrt(np.prod(v[:-1]))
            if path[-2:] == ("head_c", "fc4"):
                w = w * 8.0
            out[k] = w.astype(np.float32)
    return out


def make_frame(rng: np.random.Generator, n_obj: int = 5):
    """A 480x640 RGB-D frame (depth in 0.1 mm, YCB's factor) with ``n_obj``
    labelled objects of 21 classes."""
    h, w = 480, 640
    rgb = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    depth = np.zeros((h, w), np.uint16)
    label = np.zeros((h, w), np.uint8)
    ids = rng.choice(np.arange(1, NUM_OBJ + 1), size=n_obj, replace=False)
    for i in ids:
        hh, ww = rng.integers(50, 140, size=2)
        r, c = rng.integers(0, h - hh), rng.integers(0, w - ww)
        label[r:r + hh, c:c + ww] = i
        depth[r:r + hh, c:c + ww] = rng.integers(5000, 9000, size=(hh, ww))
    return rgb, depth, label


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def check_kernels(knn, rng) -> dict:
    """Phase 3: the remap kernel against its plain version. Coordinates must
    be equal; scores within 1e-5 relative (the kernel pins its rounding to
    the plain version's, so they are expected to be bit-identical)."""
    dev = torch.device("cuda")
    half = rng.standard_normal((4, 300, 3)).astype(np.float32)
    cases = [
        ("scoring shape (64, 500, 500)",
         rng.standard_normal((BATCH, NUM_MESH, 3)),
         rng.standard_normal((BATCH, NUM_MESH, 3)), None),
        ("ragged (3, 1003, 2600), active [1, 0, 1]",
         rng.standard_normal((3, 1003, 3)), rng.standard_normal((3, 2600, 3)),
         [1, 0, 1]),
        ("ties (4, 700, 2x300 duplicated refs)",
         rng.standard_normal((4, 700, 3)), np.concatenate([half, half], 1),
         None),
    ]
    worst = 0.0
    for name, q, r, act in cases:
        q = torch.from_numpy(q.astype(np.float32)).to(dev)
        r = torch.from_numpy(r.astype(np.float32)).to(dev)
        a = None if act is None else torch.tensor(act, dtype=torch.int32,
                                                  device=dev)
        kc, ks = knn.adds_remap_kernel(q, r, a)
        pc, ps = knn.adds_remap_plain(q, r, a)
        torch.cuda.synchronize()
        if not torch.equal(kc, pc):
            raise AssertionError(f"remap coords differ on {name}")
        err = float((ks - ps).abs().max())
        if not torch.allclose(ks, ps, rtol=1e-5, atol=0.0):
            raise AssertionError(f"remap scores differ on {name}: {err}")
        if name.startswith("ties"):
            _, idx = knn.nearest_neighbor(q, r)
            if int(idx.max()) >= 300:
                raise AssertionError("ties did not go to the lowest index")
        worst = max(worst, err)
        log(f"  remap kernel == plain on {name}: max score err {err}")
    return {"adds_remap": worst}


def main_path(est, frames, mesh):
    """Phase 4: requests through the user-facing entry points."""
    from densefusion_tpu_torch.eval import pose_distances
    from densefusion_tpu_torch.geometry import YCB_CAM_1

    for rgb, depth, label in frames[:3]:
        poses = est.estimate_frame(rgb, depth, label, YCB_CAM_1)
        if not poses:
            raise AssertionError("estimate_frame found no object")
        for q, t, c in poses.values():
            if not (np.isfinite(q).all() and np.isfinite(t).all()
                    and abs(np.linalg.norm(q) - 1) < 1e-4 and 0 < c < 1):
                raise AssertionError(f"bad frame estimate {q} {t} {c}")
    samples = batch_samples(est, frames, BATCH)
    quat, trans, conf, valid = est.estimate_batch(samples)
    if quat.shape != (BATCH, 4) or trans.shape != (BATCH, 3) \
            or not valid.all():
        raise AssertionError("bad estimate_batch output shapes / validity")
    model, target, sym = mesh
    dist = pose_distances(model, torch.from_numpy(quat).cuda(),
                          torch.from_numpy(trans).cuda(), target, sym)
    torch.cuda.synchronize()
    for name, v in (("quat", quat), ("trans", trans), ("conf", conf),
                    ("dist", dist.cpu().numpy())):
        if not np.isfinite(v).all():
            raise AssertionError(f"non-finite {name}")
    return samples, dist


def batch_samples(est, frames, n):
    """The first ``n`` valid detections of ``frames``, assembled on the
    host as ``estimate_frame`` assembles them."""
    from densefusion_tpu_torch.geometry import YCB_CAM_1

    samples = [s for rgb, depth, label in frames
               for i in np.unique(label)[1:]
               if (s := est.make_sample(rgb, depth, label == i, int(i) - 1,
                                        YCB_CAM_1)).valid]
    if len(samples) < n:
        raise AssertionError(f"only {len(samples)} detections in the frames")
    return samples[:n]


def cpu_agreement(est_gpu, est_cpu, samples) -> dict:
    """Phase 5: one B=8 batch through the card and the CPU. The raw
    hypotheses agree to atol 1e-4; the refined poses agree to atol 1e-4
    on every row whose chosen hypothesis is the same on both devices, and a
    row whose choice differs must be a near-tie (a confidence gap within
    twice the measured confidence difference, at least 1e-5)."""
    from densefusion_tpu_torch.data import collate

    b = collate(samples[:8])
    outs = []
    for est in (est_gpu, est_cpu):
        dev = est.pipeline.device
        args = (torch.as_tensor(b.img, device=dev),
                torch.as_tensor(b.points, device=dev),
                torch.as_tensor(b.choose, device=dev).long(),
                torch.as_tensor(b.obj_idx, device=dev).long())
        with torch.no_grad():
            raw = est.pipeline.posenet(*args)
        q, t, c = est.pipeline(*args)
        outs.append(({k: v.cpu() for k, v in raw.items()},
                     q.cpu(), t.cpu(), c.cpu()))
    (rg, qg, tg, _), (rc, qc, tc, _) = outs
    err = {k: float((rg[k] - rc[k]).abs().max())
           for k in ("pred_r", "pred_t", "pred_c", "emb")}
    for k, e in err.items():
        if e > 1e-4:
            raise AssertionError(f"{k} differs card vs CPU by {e}")
    same = rg["pred_c"].argmax(1) == rc["pred_c"].argmax(1)
    if not same.any():
        raise AssertionError("no row chose the same hypothesis on both")
    for row in torch.nonzero(~same).flatten().tolist():
        conf = rc["pred_c"][row]
        gap = float(conf.max() - conf[rg["pred_c"][row].argmax()])
        if gap > max(1e-5, 2 * err["pred_c"]):
            raise AssertionError(f"row {row} chose another hypothesis on "
                                 f"the card (gap {gap})")
    err["quat"] = float((qg - qc)[same].abs().max())
    err["trans"] = float((tg - tc)[same].abs().max())
    err["rows_compared"] = int(same.sum())
    if err["quat"] > 1e-4 or err["trans"] > 1e-4:
        raise AssertionError(f"refined poses differ card vs CPU: {err}")
    return err


def remap_bound_ms(bsz, nq, nr, active_rows) -> tuple[float, str]:
    """Least time for the remap's work on these inputs: ~8 fp32 operations
    per (query, ref) pair of an active row plus 5 per ref for ||r||^2,
    against each input read and each output written once."""
    ops = active_rows * (8 * nq * nr + 5 * nr)
    nbytes = 4 * (3 * bsz * nq + 3 * bsz * nr + 4 * bsz * nq)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def run() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is "
                         "available")
    root = Path(__file__).resolve().parent
    import densefusion_tpu_torch
    if Path(densefusion_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit("densefusion_tpu_torch must come from this checkout")
    from densefusion_tpu_torch.device import precision_policy, resolve_device
    from densefusion_tpu_torch.ops import build, knn

    # 1. the card
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    for name, r in report.items():
        log(f"[2] built {name} in {r['seconds']:.2f} s\n{r['log'].strip()}")
    log(f"[2] build phase {build_s:.2f} s ({len(report)} compiled, "
        f"{len(build.SOURCES) - len(report)} already built)")

    # 3. kernels against their plain versions
    rng = np.random.default_rng(SEED)
    resolve_device("cuda")
    log(f"[3] precision policy {precision_policy()}")
    max_err = check_kernels(knn, rng)

    # 4. main path
    est, states = seeded_estimator(rng)
    frames = [make_frame(rng) for _ in range(20)]
    model = torch.from_numpy((0.05 * rng.standard_normal(
        (BATCH, NUM_MESH, 3))).astype(np.float32)).cuda()
    target = model + 0.01 * torch.randn(model.shape, device="cuda",
                                        generator=torch.Generator(
                                            "cuda").manual_seed(SEED))
    sym = torch.from_numpy(np.arange(BATCH) % 4 == 0).cuda()
    mesh = (model, target, sym)

    knn.adds_remap_kernel.launches = 0
    samples, dist = main_path(est, frames, mesh)
    launches = {"adds_remap": knn.adds_remap_kernel.launches}
    log(f"[4] main path: 3 frames + B={BATCH} batch + pose_distances "
        f"(mean {float(dist.mean()):.4f} m); launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    # 5. card vs CPU, TF32 off
    est_cpu = seeded_estimator(None, states, device="cpu")[0]
    agree = cpu_agreement(est, est_cpu, samples)
    log(f"[5] card vs CPU (TF32 off, {precision_policy()}): {agree}")

    # 6. timings
    from densefusion_tpu_torch.data import collate
    b = collate(samples)
    dev_args = (torch.as_tensor(b.img, device="cuda"),
                torch.as_tensor(b.points, device="cuda"),
                torch.as_tensor(b.choose, device="cuda").long(),
                torch.as_tensor(b.obj_idx, device="cuda").long())
    pipe_ms = cuda_ms(lambda: est.pipeline(*dev_args), iters=20)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        est.estimate_batch(samples)
        walls.append(time.perf_counter() - t0)
    serve_ms = 1e3 * float(np.median(walls))
    from densefusion_tpu_torch.geometry import YCB_CAM_1
    lat, objs = [], []
    for rgb, depth, label in frames[:10]:
        t0 = time.perf_counter()
        objs.append(len(est.estimate_frame(rgb, depth, label, YCB_CAM_1)))
        lat.append(time.perf_counter() - t0)
    frame_ms = 1e3 * float(np.median(lat))
    log(f"[6] estimate_frame (one request, {min(objs)}-{max(objs)} objects, "
        f"host assembly included): median {frame_ms:.3f} ms over "
        f"{len(lat)} frames; card {card}")
    log(f"[6] pipeline B={BATCH} K={REFINE_ITERS} f32 on the card: "
        f"{pipe_ms:.3f} ms = {BATCH * 1e3 / pipe_ms:.1f} frames/s (inputs "
        f"on the card); estimate_batch with host collate and copies: "
        f"{serve_ms:.3f} ms = {BATCH * 1e3 / serve_ms:.1f} frames/s; "
        f"card {card}")

    pred = model + 0.001
    kernel_ms = graph_ms(lambda: knn.adds_remap_kernel(pred, target))
    wrapper_ms = cuda_ms(lambda: knn.adds_remap_kernel(pred, target),
                         iters=200)
    plain_ms = cuda_ms(lambda: knn.adds_remap_plain(pred, target), iters=50)
    bound_ms, bound_by = remap_bound_ms(BATCH, NUM_MESH, NUM_MESH, BATCH)
    log(f"[6] remap (64, 500, 500): kernel {kernel_ms:.4f} ms on the card "
        f"(graph replays), {wrapper_ms:.4f} ms per eager wrapper call, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
        f"build {build_s:.2f} s; card {card}")

    # 7. kernels line
    kernels = [{
        "name": "adds_remap", "route": "cuda",
        "source": "densefusion_tpu_torch/csrc/adds_remap.cu",
        "replaces": "densefusion_tpu/ops/knn.py:303",
        "launches": launches["adds_remap"],
        "max_abs_err": max_err["adds_remap"],
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "wrapper_ms": wrapper_ms, "parity": "ok", "build_s": build_s,
    }]
    summary = {"pipeline_ms_b64": pipe_ms,
               "frames_per_s_b64": BATCH * 1e3 / pipe_ms,
               "estimate_batch_ms_b64": serve_ms,
               "estimate_frame_ms_median": frame_ms, "card": card}
    log(json.dumps({"summary": summary}))
    log(json.dumps({"kernels": kernels}))

    # 8. card, then the result line
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        run()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
