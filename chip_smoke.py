#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device and exits 1 without
one, outside its checkout (a copy of the script alone), or when any phase
fails. Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``densefusion_tpu_torch/csrc``, one ``nvcc`` per
   source, all started together; then load the host data-plane library
   (``csrc/dfnative.cpp``, built with ``g++`` at this first use);
3. each kernel against its plain PyTorch version on the card: the remap at
   the scoring shape, at a ragged shape with a gated row, on exact ties
   (duplicated refs, and refs at swapped x and y at the scoring shape and
   across tiles, where a wrong winner moves the coordinates), on a
   one-sample grid and with every row gated, twice on the same inputs
   (bit-identical), each case with its split;
   the ADD (paired) and ADD-S (min) distance kernels at the phase-1 and
   refiner shapes, a ragged shape with a gated row, exact ties (also
   between targets at swapped x and y, across the split scan's warps and
   its tiles, where a wrong winner moves the coefficients), batches with
   every row and with no row symmetric (also at the phase-1 shape), and
   hypotheses at the pose; the paired kernel alone at the edges of its
   split (fewer model points than the threads that share a hypothesis, N
   past the hypothesis tile, one thread per hypothesis, every row gated at
   the phase-2 main shape), twice on the phase-1 inputs (bit-identical),
   and split at the refiner shape; and the autograd Function's backward;
   3c. the 1-NN kernels (rank 2 and batched) at the ``bench_knn`` shape,
   the phase-1 ADD-S shape, ragged shapes, exact ties, sentinel-padded
   refs, the refiner's shape (a grid of a few blocks) and ties that
   straddle the split scan: indices equal, distances bit-identical;
   3d. the decoder's phase-conv kernel (kernel 6, 3xTF32 on the tensor
   cores) at the decoder's three phase-conv shapes at B=64, the JAX kernel
   test's ragged shapes, B=1, and two cases at the edges of its tiles,
   within 1e-4 of the plain output's largest element, and its autograd
   route's gradients against the library convolution's;
4. the serving path at the YCB width (21 objects, N=1000 points, 192 px
   crops, K=2 refine iterations, random weights from the seed, made as the
   JAX package's parameter trees and carried across by
   ``densefusion_tpu_torch.compat``): ``estimate_frame``
   requests on 480x640 RGB-D frames, ``estimate_batch`` at B=64, and
   ``pose_distances`` on the result, with every kernel's launch count
   reset just before and read just after (the remap kernel, and kernel 6,
   which ``"auto"`` takes on the card for the fused decoder's three phase
   convolutions);
   4b. the training path at the YCB width: ``create_train_state``, three
   phase-1 steps at B=32, M=500 (ADD-S on 8 rows), then three phase-2
   steps at B=32, M=2600, K=2, each step's launch counts reset before it
   and read after it (kernel 6: 3 per step, the PoseNet forward);
   4c. the search path: the KNN benchmark CLI in-process, ``knn(k=1)`` at
   the phase-1 ADD-S shape, and on a one-rank NCCL mesh the sharded and
   ring searches and the hypothesis-sharded distance with its gradient,
   each against its single-device result; the process group is then torn
   down;
   4d. the decoder path with kernel 6: the serving PoseNet's trunk and PSP
   map at B=64, then the three upsample stages through the layer functions
   with ``conv_backend="kernel"``, each against the library route, the
   embedding against ``PSPNet(img, sample_at=choose)``, and the zero border
   at the up2 shape, the kernel's launches reset before and read after;
   4e. ``estimate_batch`` at B=64, K=2 under the dense zero-border and the
   align-corners decoders;
   4f. the data path: a synthetic 21-class YCB root (32 real + 32
   synthetic 480x640 frames) written to a temporary directory, read by
   ``YCBDataset`` (N=1000, M=500, 192 px crops, noise on) through
   ``BatchLoader`` at B=32 with 4 workers: the batch order of epoch 1 is
   ``default_rng((seed, epoch)).shuffle``, thread and fork workers give
   bit-identical batches, ``epoch(1, start_batch=1)`` is the epoch's tail;
   then three phase-1 steps fed by ``PrefetchIterator`` and ``to_device``
   from the fork workers (forked after CUDA is up; they run numpy only),
   each step's launch counts reset before it and read after it (paired and
   min kernels once, kernel 6 three times), finite losses, moved
   parameters, the symmetric rows of each batch printed; then the paired
   and min kernels against their plain versions on the last batch's
   model and target points, gated by its symmetric rows, at the PoseNet's
   own hypotheses;
   4o. the host data-plane library (``densefusion_tpu_torch/native.py``,
   the readers' default path, which [4f] and every later reader ran
   through): a fresh ``g++`` build into a temporary directory, timed;
   every entry point against its numpy plain version on 12 frames of the
   4f root (PNG decode, the label scans and occluders, the crop-window
   mask, compositing and the pool's noise exact; back-projection rtol
   1e-5; the normalize + resize atol 1e-4; the jitter atol 0.35); the
   root's test-mode samples (its real frames without augmentation)
   through the library against the numpy path, float fields within 5e-5,
   the rest exact;
   4g. the training CLI (``cli.train.main``) at the YCB width on the 4f
   root (21 objects, N=1000, 192 px, mesh 500 then 2600, K=2, B=16, 4
   steps per epoch): two epochs with the decay and refine margins above
   any distance, so both gates fire after epoch 1 and epoch 2 trains the
   refiner on data rebuilt at 2600 mesh points; each train and test
   epoch's launches of kernels 1, 2 and 6 reset before it and read after
   it (every kernel launched, kernel 6 three times per step); a fresh
   ``Trainer`` resumes from ``checkpoint_current`` with parameters, Adam
   moments and steps, the step, the dropout generator, the JAX key,
   curriculum and cursor equal bit for bit; the file read back with the
   port's codec holds the flax layout; checkpoint load and save timed;
   ``PoseEstimator.from_checkpoint(checkpoint_best_refine)`` on the B=64
   serving samples equal bit for bit to an estimator built from the
   trainer's state_dicts; then epoch 3 trains in the fresh trainer;
   seconds, steps/s and the input-bound fraction (time waiting on the
   loader over the epoch) per epoch;
   4h. LineMOD: a synthetic root of ape, eggbox and glue, one epoch of the
   training CLI at the LineMOD width (N=500, 192 px), then
   ``cli.eval_linemod`` on its checkpoint with native crops off and on:
   ``result.json`` with rates in [0, 1], the launches of kernels 5 and 6
   in each evaluation;
   4i. YCB keyframe evaluation: a root of its own (12 keyframes of 6 of
   the 21 objects, fake PoseCNN results), 4g's ``checkpoint_best_refine``
   through ``cli.eval_ycb`` by frame, by detection and with native crops,
   then a ``--skip_done`` rerun of the frame route: kernel 6 three times
   per PoseNet forward (counted apart), no remap (scoring is on the host),
   no forward in the rerun and the same ``metrics.json``; the native-crop
   route once more on a copy of that checkpoint under the dense
   align-corners decoder (``decoder="torch"``, chosen by ``--native_crops
   auto``), where kernel 6 must launch 0 times; each run's stages timed
   apart (set-up, inference loop, model clouds, scoring); frame and
   detection poses within 1e-4; ``cli.score_ycb`` gives ``metrics.json``'s
   table exactly; ``cli.visualize`` on 4 frames; the benchmark's
   ``inference`` (B=16) and ``latency`` (B=1, K=2);
   4j. CAD: a synthetic customCAD root at the Unity frame size (520x1109),
   two epochs of ``cli.train --dataset cad`` (N=500, 192 px, B=8) through
   both gates, each epoch's launches of kernels 1, 2 and 6 (kernel 2 never
   in phase 1: no symmetric class; in phase 2 with every row gated off),
   ``cli.eval_cad`` (one remap and three kernel-6 launches per frame) and
   ``cli.inspect_sample --dataset cad``;
   4k. SegNet at full width on the card against the CPU (B=2, 96x128, the
   same seeded JAX-layout variables: eval logits, one train step's loss,
   gradients and BN statistics, the argmax pool on a map with exact
   ties); ``cli.train_seg --format linemod`` (B=8, three epochs) on a copy
   of the 4h root, ``segnet_latest.msgpack`` reloaded bit for bit;
   ``cli.segment --binary_class <obj> --class_vs_bg`` into its
   ``segnet_results/``; ``cli.eval_linemod --mode eval`` of 4h's
   checkpoint on those masks (kernel 6 three launches per PoseNet
   forward, kernel 5 launched), with each object's non-empty masks and
   IoU against the ground truth; ``bench_seg`` (B=4, 480x640, 22
   classes) beside its FLOP bound; ``cli.verify_fat`` and
   ``cli.reconstruct_fat`` on a generated FAT scene;
   4l. bf16 compute and the model options: kernel 6's bf16 route
   (``csrc/phase_conv_bf16.cu``, channels-last padded map) against its
   plain bf16 version at the decoder's three shapes at B=64, B=32 and B=1
   (``bench_latency``'s) and five ragged shapes, every element within one
   bf16 ulp, timed by graph replay in turns with ``F.conv2d`` in bf16 on
   the same channels-last map (and once on the NCHW map, the layout the
   earlier bf16 kernel took) beside its bound at the dense bf16 peak;
   ``estimate_batch`` at B=64, K=2 with bf16 compute on the serving
   weights (float32 outputs; raw outputs against the card's float32 ones
   by the JAX package's bf16 criteria; the bf16 route 3 launches, the
   float32 route none) and its frames/s beside float32's; bf16 phase-1 and
   phase-2 steps at B=32 (finite, float32 gradients, moved parameters, step
   ms beside float32's); a float32 phase-1 step with ``remat_cnn`` against
   the plain one (gradients within 1e-6 of the largest; peak device memory
   and step ms of both); ``cli.train --bf16 --remat_cnn`` for one epoch
   on the 4f root; ``bench_latency`` (bf16 on the card); a resnet50
   PoseNet forward at B=8 (kernel 6 three launches);
   4m. data parallelism over every card, one spawned process per card on
   NCCL (``dp_path``): the data-parallel phase-1 (B=32, M=500) and phase-2
   (B=32, M=2600, K=2) steps on ``make_mesh()`` against the one-device
   steps on the whole batch (half the rows invalid, on the last rank's
   slice on several cards), two steps a phase from one seeded state, each
   from the same state as its one-device step (which is also repeated,
   the card's own spread): the gradients within 1e-5 of each tensor's
   largest element on every card count; on one card the loss, ``dis`` and
   parameters within 1e-6, on several the JAX DP test's gate (loss rtol
   1e-5, parameters atol 1e-3); kernels 1, 2 and 6 launched per step as
   on one device; step ms in turns; ``PoseEstimator(mesh=)`` on 63
   samples at K=2 against the meshless estimator, kernel 6 three
   launches, frames/s in turns; ``torchrun --nproc_per_node=<cards> -m densefusion_tpu_torch.
   cli.train --data_parallel`` one epoch on the 4f root (one
   ``checkpoint_current``, every rank's digest equal, resumed in one
   process and served); ``cli.benchmark --what scaling``;
   4n. export (``densefusion_tpu_torch/export.py``): a seeded checkpoint
   at the YCB width (fused decoder) exported at B=8, K=2 in float32 and
   bf16 on the card, each graph holding kernel 6's registered op three
   times; each artifact loaded in a child process that imports only
   ``torch`` and ``densefusion_tpu_torch.export`` (no ``jax``, no port
   ``models``) and run on a seeded batch: three launches of the route's
   kernel per call and none of the other route's, the poses and
   confidences within 1e-4 of ``PoseEstimator.from_checkpoint``'s, run in
   a fresh process of its own too (whether they are bit-identical is
   printed, and so is this process's ``from_checkpoint`` against the fresh
   one: two processes on one card can differ); the artifact's frames/s
   against the live pipeline's in turns;
   the ``.pth`` round trip (``export_torch_checkpoint`` ->
   ``import_torch_checkpoint``: parameters exact, served on the card as
   the same weights under the reference's decoder); ``cli.benchmark
   --what knn --trace_dir`` and ``cli.train --trace_dir`` (one epoch on
   the 4h root) each write a trace, and whether it names the hand-written
   kernels;
5. the same B=8 batch on the card and on the CPU, with TF32 off, must agree,
   under each of the three decoders;
   5b. one phase-1 and one phase-2 loss and gradient at B=4, dropout off,
   on the same weights on the card and on the CPU, must agree;
   5c. the phase-1 gradient at B=4 on 4g's trained weights, card against
   CPU and each against a float64 reference: a reading, not a gate;
6. timings: pose frames/s at B=64 under each decoder, the phase-1 and
   phase-2 step times at B=32, and each kernel's, its plain version's and
   the build's time (for the 1-NN kernels also ``torch.cdist(q, r)
   .min(-1)``'s, for the remap ``torch.cdist`` + ``argmin`` + ``gather``;
   for kernel 6 at its three shapes ``F.conv2d``'s, timed in turns with
   it, and both its bounds, 3xTF32 and FFMA); the ADD-S min kernel at the
   refiner shape in five windows, with the active rows first and spread;
   for the redesigned kernels (1-5) time over bound and launches x (time -
   bound), for the paired kernel (1) at phase 1, the phase-2 main loss and
   the refiner, with the split each takes, and the remap's (5) split;
   the data plane on the 4f root: the loader's cold, warm (threads) and
   ring (fork workers) samples/s at B=32, and loader-fed phase-1 steps/s
   beside the device-only rate and the input-bound fraction
   (``cli/benchmark.py`` ``bench_loader`` / ``bench_train_e2e``), with
   the host library on and off in turns (on, off, off, on); kernel 6
   and ``F.conv2d`` also at the training batch (B=32), the training CLI's
   (B=16), eval_ycb's largest frame bucket (B=8), one crop (B=1) and the
   three shapes the native-crop evaluation of [4i] launched most; the
   train-step benchmarks ``cli/benchmark.py --what train`` and ``--what
   refine`` at their defaults (B=8);
7. a JSON line listing every ported kernel (``kernels``), with its launch
   count on the path that ported it (``launches``) and on each path
   (``launches_by_path``);
8. the card's name and power limit, then ``{"ok": true, "device": ...}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

NUM_OBJ, NUM_POINTS, CROP, REFINE_ITERS = 21, 1000, 192, 2
BATCH, NUM_MESH = 64, 500
TRAIN_BATCH, REFINE_MESH, TRAIN_SYM_ROWS, LR, W = 32, 2600, 8, 1e-4, 0.015
TRAIN_STEPS = 3   # per phase
# the data path's synthetic YCB root: real and synthetic training frames,
# and the loader's workers
DATA_FRAMES, DATA_WORKERS, E2E_STEPS = 32, 4, 20
# the training CLI on that root: a batch that gives 4 steps per epoch
CLI_BATCH = 16
# the LineMOD evaluation path: ape, eggbox and glue (the symmetric two),
# training frames per object, batch
LM_OBJECTS, LM_TRAIN, LM_BATCH = (1, 10, 11), 8, 8
# the YCB keyframe evaluation: keyframes of its own root (the 21 classes of
# the 4f root, its models), objects rendered per keyframe (YCB-Video's
# keyframes hold 3-6), and the frames the overlay renderer draws
YCB_KEYFRAMES, YCB_OBJS, VIS_FRAMES = 12, 6, 4
# the CAD path: Unity frame size, training and test frames (the test split
# keeps every tenth), batch
CAD_DIMS, CAD_TRAIN, CAD_TEST, CAD_BATCH = (520, 1109), 16, 30, 8
# SegNet ([4k]): 12 classes over the LineMOD root (ape, eggbox, glue: max
# id 11 + 1); the card-vs-CPU check's (B, H, W) and classes; train_seg's
# batch (the linemod recipe's) and epochs; bench_seg's (B, H, W, classes),
# the JAX benchmark's; the FAT scene's frames
SEG_CLASSES, SEG_CARD_SHAPE, SEG_BATCH, SEG_EPOCHS = 22, (2, 96, 128), 8, 3
SEG_BENCH, FAT_FRAMES = (4, 480, 640, 22), 2
# [4m] data parallelism: steps per phase, serving samples (63: padded on
# every rank count but 1, 3, 7, 9, 21 and 63), the ranks' time limit
DP_STEPS, DP_SAMPLES, DP_JOIN_S = 2, 63, 600
# [4n] export: the artifact's batch (the JAX export CLI's default)
EXPORT_BATCH = 8
# the hand-written kernels' __global__ names, as a profiler trace shows them
KERNEL_SYMBOLS = ("nn_kernel", "adds_remap_kernel", "paired_dist",
                  "min_partial", "phase_conv_kernel", "phase_conv_bf16_kernel")
# the KNN benchmark's shape (densefusion_tpu_torch/cli/benchmark.py)
KNN_QUERIES, KNN_REFS = 250_000, 500
SEED = 0
# the decoder's three phase convolutions at 192 px crops: (stage, h = w of
# the half-res map, Cin, Cout = 4 phases x the stage's channels)
DECODER_CONVS = (("up1", CROP // 8, 1024, 4 * 256),
                 ("up2", CROP // 4, 256, 4 * 64),
                 ("up3", CROP // 2, 64, 4 * 64))
# the decoders besides the default fused one, as PoseNet arguments
OTHER_DECODERS = {"dense zero-border": {"fused_decoder": False},
                  "align-corners": {"align_corners": True}}
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# [4l]: kernel 6's bf16 route at the decoder's shapes at these batches
# (B=1: bench_latency's), and at ragged shapes (Cin 130 and 3 take its
# plain-load input path, Cout 5 and 9 its plain-load weights, the others
# TMA); the resnet50 PoseNet's batch
BF16_CONV_BATCHES, R50_BATCH = (BATCH, TRAIN_BATCH, 1), 8
BF16_RAGGED = (("ragged Cin 130, Cout 5", 2, 12, 10, 130, 5),
               ("ragged 5x7 map, Cin 3, Cout 9", 1, 5, 7, 3, 9),
               ("ragged Cout 96", 1, 24, 24, 64, 96),
               ("3x4 map (below one tile), Cin 96", 1, 3, 4, 96, 64),
               ("odd 7x9 map, Cin 40, Cout 136", 3, 7, 9, 40, 136))


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


def seeded_estimator(rng, states=None, device=None, posenet_kw=None):
    """The YCB-width PoseEstimator with weights drawn from ``rng`` as the
    JAX package's parameter trees and carried across by the port's
    ``compat`` -> (estimator, (posenet_state, refiner_state)). Given
    ``states``, reuses them instead; ``posenet_kw`` picks the decoder."""
    from densefusion_tpu_torch import compat
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.serve import PoseEstimator

    if states is None:
        states = (compat.posenet_state_dict_from_flax(
                      seeded_params(posenet_param_shapes(NUM_OBJ), rng)),
                  compat.refiner_state_dict_from_flax(
                      seeded_params(refiner_param_shapes(NUM_OBJ), rng)))
    est = PoseEstimator(PoseNet(NUM_OBJ, **(posenet_kw or {})),
                        PoseRefineNet(NUM_OBJ), *states,
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

def swapped_remap_problem(rng, b, nq, nr):
    """(query (b, nq, 3), ref (b, nr, 3)) as numpy float32 at the ADD-S
    geometry (points of a 5 cm object, in metres) with exact ties between
    refs at different places: refs k and k + nr/2 are (x, y, z) and (y, x,
    z), and every query has q_x = q_y, so it scores both refs of a pair
    alike, bit for bit (the same rounded products, added in the same order
    up to commutation). The first of the pair must win; a wrong winner
    swaps the x and y of the remapped coordinates."""
    q = (0.05 * rng.standard_normal((b, nq, 3))).astype(np.float32)
    q[..., 1] = q[..., 0]
    half = (0.05 * rng.standard_normal((b, nr // 2, 3))).astype(np.float32)
    return q, np.concatenate([half, half[..., [1, 0, 2]]], axis=1)


def check_kernels(knn, rng) -> dict:
    """Phase 3: the remap kernel against its plain version, coordinates and
    scores equal (``torch.equal``: the kernel pins its rounding to the plain
    version's): the scoring shape, a ragged shape past one ref tile with a
    gated row, duplicated refs (the lowest index checked through the 1-NN
    kernel, as equal twins give equal coordinates), refs tied at swapped x
    and y at the scoring shape and at R = 2600 (twins in different tiles),
    where a wrong winner moves the coordinates, a one-sample grid and every
    row gated; then two launches on the scoring inputs, bit-identical. Each
    case prints the split (warps per slot of queries) it ran at."""
    dev = torch.device("cuda")
    half = rng.standard_normal((4, 300, 3)).astype(np.float32)
    # the cases after the first three draw from a generator of their own, so
    # that `rng`, which makes the main path's weights after this phase, is
    # left as the first three leave it
    more = np.random.default_rng(SEED + 8)
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
        ("swapped ties (64, 500, 2x250 refs, x and y swapped)",
         *swapped_remap_problem(more, BATCH, NUM_MESH, NUM_MESH), None),
        ("swapped ties across tiles (64, 500, 2x1300 refs, x and y swapped)",
         *swapped_remap_problem(more, BATCH, NUM_MESH, REFINE_MESH), None),
        ("small grid (1, 37, 500)", more.standard_normal((1, 37, 3)),
         more.standard_normal((1, NUM_MESH, 3)), None),
        ("every row gated (8, 300, 700)", more.standard_normal((8, 300, 3)),
         more.standard_normal((8, 700, 3)), [0] * 8),
    ]
    worst = 0.0
    for name, q, r, act in cases:
        q = torch.from_numpy(q.astype(np.float32)).to(dev)
        r = torch.from_numpy(r.astype(np.float32)).to(dev)
        a = None if act is None else torch.tensor(act, dtype=torch.int32,
                                                  device=dev)
        split = knn.scan_split(*q.shape[:2], r.shape[1])
        kc, ks = knn.adds_remap_kernel(q, r, a)
        pc, ps = knn.adds_remap_plain(q, r, a)
        torch.cuda.synchronize()
        err = max(float((kc - pc).abs().max()), float((ks - ps).abs().max()))
        if not torch.equal(kc, pc) or not torch.equal(ks, ps):
            raise AssertionError(f"remap differs from plain on {name}: max "
                                 f"abs err {err}")
        note = ""
        if name.startswith("ties"):
            _, idx = knn.nearest_neighbor(q, r)
            if int(idx.max()) >= 300:
                raise AssertionError("ties did not go to the lowest index")
            note = "; the 1-NN kernel's indices all in the first copy"
        if name.startswith("swapped"):
            # a wrong twin would show wherever the winner has x != y
            seen = float((pc[..., 0] != pc[..., 1]).float().mean())
            if seen < 0.99:
                raise AssertionError(f"remap {name}: a wrong twin would "
                                     f"show on only {seen:.3f} of queries")
            note = f"; a wrong twin would show on {seen:.4f} of queries"
        if act is not None and not all(act) and (
                kc[a == 0].any() or ks[a == 0].any()):
            raise AssertionError(f"remap gated rows not 0 on {name}")
        worst = max(worst, err)
        log(f"  remap kernel == plain on {name}, split {split}: coordinates "
            f"and scores equal{note}")
    q = torch.from_numpy(cases[0][1].astype(np.float32)).to(dev)
    r = torch.from_numpy(cases[0][2].astype(np.float32)).to(dev)
    first = knn.adds_remap_kernel(q, r)
    again = knn.adds_remap_kernel(q, r)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError("remap: two launches on the scoring inputs "
                             "differ")
    log("  remap: two launches on the scoring inputs are bit-identical")
    return {"adds_remap": worst}


def pose_problem(rng, b, n, m, dup=False, at_pose=False):
    """Hypotheses (R, t) around a random ground-truth pose of a model cloud
    of M points, as CUDA tensors (R, t, model, target). ``dup`` duplicates
    the targets (exact ties in the ADD-S search); ``at_pose`` puts every
    hypothesis at the pose (d^2 below the floor)."""
    from densefusion_tpu_torch.geometry import quat_normalize, quat_to_matrix

    half = m // 2 if dup else m
    model = 0.05 * rng.standard_normal((b, half, 3))
    if dup:
        model = np.concatenate([model, model], axis=1)
    q_gt = quat_normalize(torch.from_numpy(rng.standard_normal((b, 4))))
    R_gt = quat_to_matrix(q_gt).numpy()
    t_gt = rng.uniform(-0.3, 0.3, (b, 3)) + np.array([0.0, 0.0, 0.8])
    target = np.einsum("bmj,bcj->bmc", model, R_gt) + t_gt[:, None]
    if at_pose:
        R = np.broadcast_to(R_gt[:, None], (b, n, 3, 3))
        t = np.broadcast_to(t_gt[:, None], (b, n, 3))
    else:
        q = quat_normalize(torch.from_numpy(
            q_gt.numpy()[:, None] + 0.3 * rng.standard_normal((b, n, 4))))
        R = quat_to_matrix(q).numpy()
        t = t_gt[:, None] + 0.05 * rng.standard_normal((b, n, 3))
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
                 for x in (R, t, model, target))


def swapped_ties_problem(rng, b, n, m, device="cuda"):
    """(R, t, model, target) with exact ties between targets at different
    places: targets k and k + M/2 are (x, y, z) and (y, x, z), every
    hypothesis is the identity rotation with t_x = t_y, and every model
    point has x = y. So every query has q_x = q_y and scores both targets of
    a pair alike, bit for bit (the same rounded products, added in the same
    order up to commutation). A wrong tie winner swaps the x and y of the
    query's difference to its target, and with them the coefficients."""
    model = 0.05 * rng.standard_normal((b, m, 3))
    model[..., 1] = model[..., 0]
    t = (rng.uniform(-0.3, 0.3, (b, 1, 3)) + np.array([0.0, 0.0, 0.8])
         + 0.05 * rng.standard_normal((b, n, 3)))
    t[..., 1] = t[..., 0]
    R = np.broadcast_to(np.eye(3), (b, n, 3, 3))
    half = 0.05 * rng.standard_normal((b, m // 2, 3)) + t[:, :1]
    target = np.concatenate([half, half[..., [1, 0, 2]]], axis=1)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                 .to(device) for x in (R, t, model, target))


def check_add_dist(add_dist, rng) -> dict:
    """Phase 3: the paired (ADD) and min (ADD-S) kernels against their plain
    versions, each gated on its rows: dis within rtol 1e-5, the 12
    coefficients within atol 2e-5 (the kernels pin the rounding of q, d^2
    and the scores, so only the order of the sums and, in the paired
    kernel, a rsqrtf-based distance differ), gated rows exactly 0; then
    paired-only cases at the edges of its split (fewer model points than
    the threads that share a hypothesis, N past the hypothesis tile, every
    row gated at the phase-2 main shape, one thread per hypothesis), two
    launches on the phase-1 inputs bit-identical, the refiner shape split;
    then the autograd Function's backward on the card equal to ``g * coef``
    of the plain versions (atol 2e-5)."""
    from densefusion_tpu_torch.ops import knn

    def compare(key, kernel, plain, args, act, name, at_pose=False,
                note=""):
        a = torch.from_numpy(act.astype(np.int32)).cuda()
        kd, kc = kernel(*args, a)
        pd, pc = plain(*args, a)
        torch.cuda.synchronize()
        off = ~torch.from_numpy(act).cuda()
        if kd[off].any() or kc[off].any():
            raise AssertionError(f"{key}: gated rows not 0 on {name}")
        if not torch.allclose(kd, pd, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{key}: dis differs on {name}: "
                                 f"{float((kd - pd).abs().max())}")
        cerr = float((kc - pc).abs().max())
        if cerr > 2e-5:
            raise AssertionError(f"{key}: coefficients differ on {name}: "
                                 f"{cerr}")
        if at_pose and kc.any():
            raise AssertionError(f"{key}: coefficients not 0 at the pose")
        err = max(float((kd - pd).abs().max()), cerr)
        worst[key] = max(worst[key], err)
        log(f"  {key} kernel == plain on {name}{note}: max abs err "
            f"{err:.3g} (dis {float((kd - pd).abs().max()):.3g}, coef "
            f"{cerr:.3g})")
        return a

    def paired_note(shape):
        threads, hyps = add_dist.paired_split(*shape[:2])
        return f", split {threads} threads x {hyps} hypotheses"

    phase1_sym = np.arange(TRAIN_BATCH) < TRAIN_SYM_ROWS
    cases = [
        ("phase-1 (32, N=1000, M=500)", (TRAIN_BATCH, NUM_POINTS, NUM_MESH),
         {}, phase1_sym),
        ("refiner (32, N=1, M=2600)", (TRAIN_BATCH, 1, REFINE_MESH), {},
         phase1_sym),
        ("ragged (3, N=130, M=1003)", (3, 130, 1003), {},
         np.array([True, False, True])),
        ("ties (4, N=70, 2x300 duplicated targets), every row symmetric",
         (4, 70, 600), {"dup": True}, np.ones(4, bool)),
        ("no symmetric row (3, N=40, M=300)", (3, 40, 300), {},
         np.zeros(3, bool)),
        ("at the pose (4, N=20, M=300)", (4, 20, 300), {"at_pose": True},
         np.array([True, False, True, False])),
        # tied targets at k and k + M/2, at swapped x and y, fall to
        # different warps of a split scan (M/2 is no multiple of the split)
        # and across target tiles: a wrong winner changes the coefficients
        ("ties across the split (4, N=10, 2x301 targets, x and y swapped)",
         (4, 10, 602), {"swapped": True},
         np.array([True, True, False, True])),
        ("ties across the split and tiles (2, N=3, 2x1300 targets, x and y "
         "swapped)", (2, 3, 2600), {"swapped": True}, np.ones(2, bool)),
        ("no active row for the min kernel at the phase-1 shape",
         (TRAIN_BATCH, NUM_POINTS, NUM_MESH), {},
         np.zeros(TRAIN_BATCH, bool)),
    ]
    worst = {"add_dist_paired": 0.0, "add_dist_min": 0.0}
    for name, shape, kw, sym in cases:
        split = knn.scan_split(*shape, min_kernel=True)
        if "across the split" in name and split == 1:
            raise AssertionError(f"add_dist_min: {name} ran unsplit")
        kw = dict(kw)
        args = (swapped_ties_problem(rng, *shape) if kw.pop("swapped", False)
                else pose_problem(rng, *shape, **kw))
        a = compare("add_dist_paired", add_dist.paired_kernel,
                    add_dist.paired_plain, args, ~sym, name,
                    kw.get("at_pose", False), paired_note(shape))
        if name.startswith("phase-1"):
            # no float atomics: a second launch repeats the first bit for bit
            first = add_dist.paired_kernel(*args, a)
            again = add_dist.paired_kernel(*args, a)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(first, again)):
                raise AssertionError("add_dist_paired: two launches on the "
                                     "phase-1 inputs differ")
            log("  add_dist_paired: two launches on the phase-1 inputs are "
                "bit-identical")
        compare("add_dist_min", add_dist.min_kernel, add_dist.min_plain, args,
                sym, name, kw.get("at_pose", False), f", split {split}")

    # the paired kernel alone, at the edges of its split
    threads, _ = add_dist.paired_split(TRAIN_BATCH, 1)
    if threads == 1:
        raise AssertionError("add_dist_paired: the refiner shape ran unsplit")
    mixed = np.array([True, False, True, True])
    for name, shape, act in (
            ("fewer points than threads per hypothesis (4, N=65, M=1)",
             (4, 65, 1), mixed),
            ("fewer points than threads per hypothesis (4, N=65, M=7)",
             (4, 65, 7), mixed),
            ("N past the hypothesis tile (32, N=1001, M=500)",
             (TRAIN_BATCH, NUM_POINTS + 1, NUM_MESH), ~phase1_sym),
            ("one thread per hypothesis (300, N=5, M=50)", (300, 5, 50),
             np.arange(300) % 3 != 0),
            ("every row gated at the phase-2 main shape (32, N=1000, "
             "M=2600)", (TRAIN_BATCH, NUM_POINTS, REFINE_MESH),
             np.zeros(TRAIN_BATCH, bool))):
        threads, _ = add_dist.paired_split(*shape[:2])
        if "fewer points" in name and threads <= shape[2]:
            raise AssertionError(f"add_dist_paired: {name} ran with "
                                 f"{threads} threads per hypothesis")
        if "one thread" in name and threads != 1:
            raise AssertionError(f"add_dist_paired: {name} ran split")
        compare("add_dist_paired", add_dist.paired_kernel,
                add_dist.paired_plain, pose_problem(rng, *shape), act, name,
                note=paired_note(shape))

    R, t, model, target = pose_problem(rng, 6, 50, 300)
    sym = torch.tensor([1, 0, 1, 0, 0, 1], dtype=torch.bool, device="cuda")
    g = torch.from_numpy(rng.uniform(0.2, 1.0, (6, 50)).astype(
        np.float32)).cuda()
    R.requires_grad_(True)
    t.requires_grad_(True)
    (add_dist.hypothesis_mean_dist(R, t, model, target, sym) * g).sum() \
        .backward()
    _, pc = add_dist.paired_plain(R.detach(), t.detach(), model, target,
                                  (~sym).int())
    _, mc = add_dist.min_plain(R.detach(), t.detach(), model, target,
                               sym.int())
    want = g[..., None] * torch.where(sym[:, None, None], mc, pc)
    gerr = max(float((R.grad.reshape(6, 50, 9) - want[..., :9]).abs().max()),
               float((t.grad - want[..., 9:]).abs().max()))
    if gerr > 2e-5:
        raise AssertionError(f"HypothesisMeanDist backward differs: {gerr}")
    log(f"  HypothesisMeanDist backward == g * coef (plain): max abs err "
        f"{gerr:.3g}")
    return worst


def nn_cases(rng):
    """Phase 3c's inputs: (name, batched, query, ref) as numpy float32."""
    def pts(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def dup(r):
        return np.concatenate([r, r], axis=-2)

    def far(r, n):   # the collectives' sentinel padding
        return np.concatenate(
            [r, np.full(r.shape[:-2] + (n, 3), 1.0e15, np.float32)], axis=-2)

    b, m = TRAIN_SYM_ROWS, NUM_MESH
    return [
        (f"bench_knn shape (Q={KNN_QUERIES}, R={KNN_REFS})", False,
         pts(KNN_QUERIES, 3), pts(KNN_REFS, 3)),
        (f"phase-1 ADD-S rows (B={b}, Q={NUM_POINTS * m}, R={m})", True,
         pts(b, NUM_POINTS * m, 3), pts(b, m, 3)),
        ("ragged (Q=37, R=613)", False, pts(37, 3), pts(613, 3)),
        ("ragged (B=3, Q=37, R=613)", True, pts(3, 37, 3), pts(3, 613, 3)),
        ("ties (Q=701, 2x300 duplicated refs)", False, pts(701, 3),
         dup(pts(300, 3))),
        ("ties (B=4, Q=700, 2x300 duplicated refs)", True, pts(4, 700, 3),
         dup(pts(4, 300, 3))),
        ("sentinel-padded (Q=300, R=2598+3)", False, pts(300, 3),
         far(pts(2598, 3), 3)),
        ("a shard of sentinels only (Q=17, R=4)", False, pts(17, 3),
         far(pts(0, 3), 4)),
        ("sentinel-padded (B=2, Q=90, R=70+5)", True, pts(2, 90, 3),
         far(pts(2, 70, 3), 5)),
        # the refiner's shape (M=2600 against M=2600): a grid of a few
        # blocks, so the scan is split across warps
        (f"refiner shape, small grid (Q={REFINE_MESH}, R={REFINE_MESH})",
         False, pts(REFINE_MESH, 3), pts(REFINE_MESH, 3)),
        # duplicates at i and i + R/2 fall to different warps of a split
        # scan (R/2 is no multiple of the split), and across tiles
        ("ties across the split (Q=2000, 2x301 duplicated refs)", False,
         pts(2000, 3), dup(pts(301, 3))),
        ("ties across the split and tiles (Q=900, 2x1300 duplicated refs)",
         False, pts(900, 3), dup(pts(1300, 3))),
        ("ties across the split (B=2, Q=300, 2x301 duplicated refs)", True,
         pts(2, 300, 3), dup(pts(2, 301, 3))),
    ]


def check_nn(knn, rng) -> dict:
    """Phase 3c: the 1-NN kernels (3: rank 2, 4: batched) against their
    plain versions. Indices must be equal and distances bit-identical: the
    kernel rounds ||r||^2, q.r, the score and ||q||^2 with ``__fmul_rn`` /
    ``__fadd_rn`` in the plain version's order and scans refs in ascending
    order with a strict ``<``, so any difference is a fault, not rounding."""
    dev = torch.device("cuda")
    worst = {"nn": 0.0, "nn_batched": 0.0}
    for name, batched, q, r in nn_cases(rng):
        key = "nn_batched" if batched else "nn"
        kernel = knn.nn_batched_kernel if batched else knn.nn_kernel
        plain = knn.nearest_neighbor_plain_batched if batched \
            else knn.nearest_neighbor_plain
        split = knn.scan_split(q.shape[0] if batched else 1, q.shape[-2],
                               r.shape[-2])
        if "across the split" in name and split == 1:
            raise AssertionError(f"{key}: {name} ran unsplit")
        q, r = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
        kd, ki = kernel(q, r)
        pd, pi = plain(q, r)
        torch.cuda.synchronize()
        if ki.dtype != pi.dtype or not torch.equal(ki, pi):
            raise AssertionError(f"{key}: indices differ on {name}")
        err = float((kd - pd).abs().max())
        if not torch.equal(kd, pd):
            raise AssertionError(f"{key}: distances not bit-identical on "
                                 f"{name}: max abs err {err}")
        if name.startswith("ties") and int(ki.max()) >= r.shape[-2] // 2:
            raise AssertionError(f"{key}: ties did not go to the lowest "
                                 f"index on {name}")
        worst[key] = max(worst[key], err)
        log(f"  {key} kernel == plain on {name}, split {split}: indices "
            f"equal, max distance err {err}")
    return worst


def conv_cases(rng):
    """Phase 3d's inputs: (name, xp (B, Cin, h+2, w+2), pk (3, 3, Cin,
    Cout)) as numpy float32: the decoder's three phase convolutions at
    B=64, the ragged shapes of the JAX kernel's test
    (``tests/test_phase_conv.py``), B=1 at up1, and two at the edges of the
    kernel's tiles: a map whose h*(w+2) = 77 fills part of one position
    tile, with a channel length of 99 floats (not 16-byte aligned) and Cin
    12 (not a multiple of the MMA depth 8); and Cin 1100, so that the copy
    ring laps many times and ends on a partial channel chunk."""
    def case(name, b, h, w, cin, cout):
        return (f"{name} (B={b}, {h}x{w}, {cin} -> {cout})",
                rng.standard_normal((b, cin, h + 2, w + 2)).astype(np.float32),
                (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
                .astype(np.float32))

    _, hw1, cin1, cout1 = DECODER_CONVS[0]
    return ([case(name, BATCH, hw, hw, cin, cout)
             for name, hw, cin, cout in DECODER_CONVS]
            + [case("ragged Cin 130, Cout 5", 2, 12, 10, 130, 5),
               case("ragged 5x7 map, Cin 3, Cout 9", 1, 5, 7, 3, 9),
               case("ragged Cout 96", 1, 24, 24, 64, 96),
               case("up1 at B=1", 1, hw1, hw1, cin1, cout1),
               case("ragged 7x9 map, Cin 12, Cout 40", 2, 7, 9, 12, 40),
               case("Cin 1100 (ring laps, K tail)", 1, 6, 6, 1100, 24)])


def check_phase_conv(phase_conv, rng) -> tuple[float, float]:
    """Phase 3d: kernel 6 against its plain version on every case of
    :func:`conv_cases`, within 1e-4 of the plain output's largest element
    (the JAX package's on-chip parity bound, ``bench.py:92-103``); then the
    kernel route's input and weight gradients against the library route's,
    within 1e-6 of their largest element (both are the library's backward).
    Returns the largest absolute error of the forward checks and the
    largest as a share of the plain output's largest element."""
    dev = torch.device("cuda")
    worst, worst_rel = 0.0, 0.0
    cases = conv_cases(rng)
    for name, xp, pk in cases:
        xp, pk = torch.from_numpy(xp).to(dev), torch.from_numpy(pk).to(dev)
        got = phase_conv.phase_conv_kernel(xp, pk)
        want = phase_conv.conv3x3_valid_plain_nchw(xp, pk)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if got.shape != want.shape or not err <= 1e-4 * scale:
            raise AssertionError(f"phase_conv kernel differs from plain on "
                                 f"{name}: {err} against max {scale}")
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        log(f"  phase_conv kernel == plain on {name}: max abs err {err:.3g} "
            f"({err / scale:.3g} of the largest)")
    for name, xp, pk in (cases[3], cases[1]):   # ragged Cin 130, up2
        xp = torch.from_numpy(xp[:8]).to(dev)
        pk = torch.from_numpy(pk).to(dev)
        g = torch.randn((xp.shape[0], pk.shape[-1], xp.shape[2] - 2,
                         xp.shape[3] - 2), device=dev,
                        generator=torch.Generator("cuda").manual_seed(SEED))
        grads = {}
        for backend in ("kernel", "library"):
            x, k = xp.clone().requires_grad_(True), \
                pk.clone().requires_grad_(True)
            (phase_conv.conv3x3_valid_nchw(x, k, backend) * g).sum() \
                .backward()
            grads[backend] = (x.grad, k.grad)
        for part, a, b in zip(("input", "weight"), grads["kernel"],
                              grads["library"]):
            rel = float((a - b).abs().max()) / float(b.abs().max())
            if rel > 1e-6:
                raise AssertionError(f"phase_conv {part} gradient differs "
                                     f"from the library's on {name}: {rel}")
        log(f"  phase_conv kernel route gradients == library's on {name} "
            "(B=8 at most)")
    return worst, worst_rel


def decoder_path(est, samples, phase_conv) -> dict:
    """Phase 4d: the decoder path with kernel 6 selected. The serving
    PoseNet's trunk and PSP module give the B=64 (64, 1024, 24, 24) map
    once; then the three upsample stages run through the layer functions
    with ``conv_backend="kernel"``, each held to the "library" route on the
    same input at 1e-4 of its largest element: up1 and up2 as
    ``phase_upsample_conv3x3`` (replicate border) + PReLU, up3 as
    ``phase_conv_phases``, the sparse phase gather, PReLU and the final 1x1.
    The embedding is held to ``PSPNet(img, sample_at=choose)``; the zero
    border runs once at the up2 shape. The kernel's launch count is reset
    before and read after; it is counted per stage."""
    import torch.nn.functional as F
    from densefusion_tpu_torch.data import collate
    from densefusion_tpu_torch.models.layers import (
        phase_conv_phases, phase_upsample_conv3x3, prelu,
    )
    from densefusion_tpu_torch.models.pspnet import sample_phases

    b = collate(samples)
    dev = est.pipeline.device
    img = torch.as_tensor(b.img, device=dev)
    choose = torch.as_tensor(b.choose, device=dev).long()
    psp = est.pipeline.posenet.cnn.model.module
    kernel = phase_conv.phase_conv_kernel
    rows, cols = choose // CROP, choose % CROP

    def stage3(x, backend):
        conv = psp.up_3.conv[1]
        return phase_conv_phases(x, conv.weight, conv.bias, backend)

    def stage(mod, border="replicate"):
        conv = mod.conv[1]
        return lambda x, backend: prelu(phase_upsample_conv3x3(
            x, conv.weight, conv.bias, border=border, conv_backend=backend),
            mod.conv[2].weight)

    errs, counts = {}, {}

    def run(name, fn, x):
        before = kernel.launches
        got = fn(x, "kernel")
        counts[name] = kernel.launches - before
        want = fn(x, "library")
        rel = float((got - want).abs().max()) / float(want.abs().max())
        errs[name] = rel
        if got.shape != want.shape or not rel <= 1e-4:
            raise AssertionError(f"decoder {name}: kernel route differs from "
                                 f"the library route by {rel} of the largest")
        return got

    with torch.no_grad():
        want_emb = psp(img, sample_at=choose)
        f, _ = psp.feats(img.permute(0, 3, 1, 2))
        x0 = psp.psp(f)
        kernel.launches = 0
        x1 = run("up1", stage(psp.up_1), x0)
        x2 = run("up2", stage(psp.up_2), x1)
        y4 = run("up3", stage3, x2)
        g = prelu(sample_phases(y4, rows, cols), psp.up_3.conv[2].weight)
        final = psp.final[0]
        emb = F.log_softmax(F.linear(g, final.weight[:, :, 0, 0],
                                     final.bias), dim=-1)
        run("up2 zero border", stage(psp.up_2, "zero"), x1)
        total = kernel.launches
    if tuple(x0.shape) != (BATCH, 1024, CROP // 8, CROP // 8):
        raise AssertionError(f"PSP map of shape {tuple(x0.shape)}")
    if total == 0 or any(n == 0 for n in counts.values()):
        raise AssertionError(f"phase_conv never launched on a decoder stage: "
                             f"{counts}")
    rel = float((emb - want_emb).abs().max()) / float(want_emb.abs().max())
    errs["embedding vs PSPNet"] = rel
    if emb.shape != (BATCH, NUM_POINTS, 32) or not rel <= 1e-4:
        raise AssertionError(f"decoder embedding {tuple(emb.shape)} differs "
                             f"from PSPNet's by {rel} of the largest")
    log(f"[4d] decoder path at B={BATCH} with the kernel: launches "
        f"{total} ({counts}); errors against the library route / PSPNet "
        f"(of the largest) {errs}")
    return {"launches": total, "by_stage": counts, "rel_errors": errs}


def other_decoders(states, samples) -> dict:
    """Phase 4e: ``estimate_batch`` at B=64, K=2 through a PoseEstimator over
    ``PoseNet(21, fused_decoder=False)`` and one over ``PoseNet(21,
    align_corners=True)``, on the serving weights: finite poses, unit
    quaternions, every row valid. Returns {name: estimator}."""
    ests = {}
    for name, kw in OTHER_DECODERS.items():
        est = seeded_estimator(None, states, posenet_kw=kw)[0]
        quat, trans, conf, valid = est.estimate_batch(samples)
        if quat.shape != (BATCH, 4) or not valid.all() or not (
                np.isfinite(quat).all() and np.isfinite(trans).all()
                and np.isfinite(conf).all()) or np.abs(
                    np.linalg.norm(quat, axis=1) - 1).max() > 1e-4:
            raise AssertionError(f"bad estimate_batch output under the "
                                 f"{name} decoder")
        log(f"[4e] estimate_batch B={BATCH} K={REFINE_ITERS} under the "
            f"{name} decoder ({kw}): finite, unit quaternions, all valid")
        ests[name] = est
    return ests


def search_path(knn, add_dist, rng) -> dict:
    """Phase 4c: the search path through its user-facing entry points, with
    the launch counts of ``nn``, ``nn_batched`` and both distance kernels
    reset just before and read just after: ``python -m
    densefusion_tpu_torch.cli.benchmark --what knn`` in-process, ``knn(k=1)``
    at the phase-1 ADD-S shape, then on a one-rank NCCL ``make_mesh(1)`` the
    sharded and the ring search at the ``bench_knn`` shape and the
    hypothesis-sharded distance with a gradient at the phase-1 shape, each
    against its single-device result (computed before the reset). On one
    rank they run the same kernels on the same inputs, so indices and
    distances must be equal (the sharded search clamps d >= 0 as the JAX
    one does) and the distance and its gradient within 1e-6 of the largest
    element. The 2-D ``(data, point)`` mesh runs the distance too. The
    process group is torn down before returning."""
    import torch.distributed as dist
    from densefusion_tpu_torch import parallel
    from densefusion_tpu_torch.cli import benchmark

    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((KNN_QUERIES, 3))
                         .astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.standard_normal((KNN_REFS, 3))
                         .astype(np.float32)).to(dev)
    b, m = TRAIN_SYM_ROWS, NUM_MESH
    q4 = torch.from_numpy(rng.standard_normal((b, NUM_POINTS * m, 3))
                          .astype(np.float32)).to(dev)
    r4 = torch.from_numpy(rng.standard_normal((b, m, 3))
                          .astype(np.float32)).to(dev)
    R, t, model, target = pose_problem(rng, TRAIN_BATCH, NUM_POINTS,
                                       NUM_MESH)
    sym = torch.arange(TRAIN_BATCH, device=dev) < TRAIN_SYM_ROWS
    wgt = torch.from_numpy(rng.uniform(0.2, 1.0, (TRAIN_BATCH, NUM_POINTS))
                           .astype(np.float32)).to(dev)

    def hyp_grad(fn):
        Rg, tg = R.clone().requires_grad_(True), t.clone().requires_grad_(True)
        dis = fn(Rg, tg)
        (dis * wgt).sum().backward()
        return dis.detach(), Rg.grad, tg.grad

    # single-device references, before the counts are reset
    want_d, want_i = knn.nearest_neighbor(q, r)
    want_d4, want_i4 = knn.nearest_neighbor_plain_batched(q4, r4)
    want_h = hyp_grad(lambda R_, t_: add_dist.hypothesis_mean_dist(
        R_, t_, model, target, sym))
    torch.cuda.synchronize()

    kernels = {"nn": knn.nn_kernel, "nn_batched": knn.nn_batched_kernel,
               "add_dist_paired": add_dist.paired_kernel,
               "add_dist_min": add_dist.min_kernel}
    for k in kernels.values():
        k.launches = 0
    try:
        bench = benchmark.main(["--what", "knn"])
        d4, i4 = knn.knn(q4, r4, k=1)
        mesh = parallel.make_mesh(1)
        mesh2 = parallel.make_mesh(1, axis_names=("data", "point"))
        sharded = parallel.sharded_nearest_neighbor(q, r, mesh)
        ring = parallel.ring_nearest_neighbor(q, r, mesh)
        hyp = hyp_grad(lambda R_, t_: parallel.sharded_hypothesis_mean_dist(
            R_, t_, model, target, sym, mesh))
        hyp2 = hyp_grad(lambda R_, t_: parallel.sharded_hypothesis_mean_dist(
            R_, t_, model, target, sym, mesh2, axis="point",
            batch_axis="data"))
        torch.cuda.synchronize()
        got = {name: k.launches for name, k in kernels.items()}
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"[4c] search path: bench_knn {bench['knn_us']:.2f} us per search "
        f"({bench['knn_backend']}); {backend} mesh of 1; launches {got}")
    for name, n in got.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the search "
                                 "path")
    if bench["knn_backend"] != "cuda" or backend != "nccl":
        raise AssertionError(f"search path ran on {bench['knn_backend']} / "
                             f"{backend}, not the card and NCCL")
    if d4.shape != (b, NUM_POINTS * m, 1) or not torch.equal(i4[..., 0],
                                                           want_i4) \
            or not torch.equal(d4[..., 0], want_d4):
        raise AssertionError("knn(k=1) differs from the plain search")
    errs = {}
    for name, (d, i), wd in (("sharded", sharded, want_d.clamp_min(0.0)),
                             ("ring", ring, want_d)):
        if not torch.equal(i, want_i) or not torch.equal(d, wd):
            raise AssertionError(f"{name} search on one rank differs from "
                                 "the single-device search")
    for name, got_h in (("hypothesis (data,)", hyp),
                        ("hypothesis (data, point)", hyp2)):
        for part, g, w in zip(("dis", "grad R", "grad t"), got_h, want_h):
            err = float((g - w).abs().max()) / float(w.abs().max())
            errs[f"{name} {part}"] = err
            if err > 1e-6:
                raise AssertionError(f"sharded {name} {part} differs from "
                                     f"the single device: {err}")
    log(f"[4c] knn(k=1) at ({b}, {NUM_POINTS * m}, {m}) == plain; sharded "
        f"and ring searches == single device (indices and distances "
        f"equal); hypothesis distance rel errors {errs}")
    return {"launches": got, "bench": bench}


def train_batch(rng, b, m, device="cuda"):
    """A training batch made as ``bench.py`` makes it (random image, cloud,
    choose, classes, model and target points; the first quarter of the rows
    symmetric, all valid), as tensors on ``device``."""
    from densefusion_tpu_torch.data import PoseSample, to_device

    return to_device(PoseSample(
        points=(rng.standard_normal((b, NUM_POINTS, 3)) * 0.05)
        .astype(np.float32),
        choose=rng.integers(0, CROP * CROP, (b, NUM_POINTS)).astype(np.int32),
        img=rng.standard_normal((b, CROP, CROP, 3)).astype(np.float32),
        target=(rng.standard_normal((b, m, 3)) * 0.05).astype(np.float32),
        model_points=(rng.standard_normal((b, m, 3)) * 0.05)
        .astype(np.float32),
        obj_idx=rng.integers(0, NUM_OBJ, (b,)).astype(np.int32),
        sym=np.arange(b) < b // 4, valid=np.ones((b,), bool)), device)


def _finite_grads(module) -> bool:
    return all(bool(torch.isfinite(p.grad).all())
               for p in module.parameters() if p.grad is not None)


def _snapshot(module) -> list:
    return [p.detach().clone() for p in module.parameters()]


def _moved(module, before) -> bool:
    return any(not torch.equal(p, b)
               for p, b in zip(module.parameters(), before))


def train_path(add_dist, phase_conv, rng):
    """Phase 4b: ``create_train_state``, then three phase-1 steps at B=32,
    M=500 and three phase-2 steps at B=32, M=2600, K=2. Each
    step's kernel launch counts are reset before it and read after it:
    phase 1 must launch the paired and the min kernel, phase 2 the paired
    kernel 3 times (the main loss and 2 refiner iterations) and the min
    kernel twice; both phases' PoseNet forward launches kernel 6 once per
    phase convolution (up1, up2, up3). Every step's loss and gradients must
    be finite and its parameters must move. Returns (state, batches, launch
    totals, launch totals per phase)."""
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        create_train_state, make_pose_train_step, make_refine_train_step,
    )

    kernels = {"add_dist_paired": add_dist.paired_kernel,
               "add_dist_min": add_dist.min_kernel,
               "phase_conv": phase_conv.phase_conv_kernel}
    totals = dict.fromkeys(kernels, 0)
    by_phase = {1: dict.fromkeys(kernels, 0), 2: dict.fromkeys(kernels, 0)}
    state = create_train_state(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ), LR,
                               SEED)
    b1 = train_batch(rng, TRAIN_BATCH, NUM_MESH)
    b2 = train_batch(rng, TRAIN_BATCH, REFINE_MESH)
    # exact launches per step where the count is fixed; at least 1 elsewhere
    for phase, make_step, batch, module, want in (
            (1, lambda: make_pose_train_step(state, use_adds=True), b1,
             state.posenet, {"phase_conv": 3}),
            (2, lambda: make_refine_train_step(state, REFINE_ITERS), b2,
             state.refiner, {"add_dist_paired": 1 + REFINE_ITERS,
                             "add_dist_min": REFINE_ITERS, "phase_conv": 3})):
        step = make_step()   # the phase switch: a fresh Adam
        losses = []
        for i in range(TRAIN_STEPS):
            before = _snapshot(module)
            for k in kernels.values():
                k.launches = 0
            metrics = step(batch, W)
            torch.cuda.synchronize()
            got = {name: k.launches for name, k in kernels.items()}
            for name, n in got.items():
                totals[name] += n
                by_phase[phase][name] += n
                if n < 1 or n != want.get(name, n):
                    raise AssertionError(
                        f"phase-{phase} step {i}: launches {got}, expected "
                        f"{want} and at least 1 each")
            loss = float(metrics["loss"])
            if not (np.isfinite(loss) and np.isfinite(float(metrics["dis"]))
                    and _finite_grads(module)):
                raise AssertionError(f"phase-{phase} step {i}: non-finite "
                                     f"loss {loss} or gradients")
            if not _moved(module, before):
                raise AssertionError(f"phase-{phase} step {i}: no parameter "
                                     "moved")
            losses.append(loss)
        log(f"[4b] phase-{phase} steps at B={TRAIN_BATCH}, M="
            f"{batch.target.shape[1]}: losses {losses}, launches per step "
            f"{got}")
    return state, (b1, b2), totals, by_phase


def data_path(add_dist, phase_conv, root: str) -> dict:
    """Phase 4f: a synthetic 21-class YCB root on disk -> ``YCBDataset`` ->
    ``BatchLoader`` (thread and fork workers) -> three phase-1 steps on the
    card. Checks the batch order, the identity of the worker modes' and a
    resumed epoch's batches, each step's launches (paired and min kernels
    once, kernel 6 three times), finite losses and moved parameters, and
    holds the paired and min kernels to their plain versions on a loader
    batch gated by its real symmetric rows. Returns the launch totals and
    what it measured on the way."""
    from densefusion_tpu_torch.data import (
        YCB_SYM, BatchLoader, PrefetchIterator, YCBDataset,
        generate_ycb_style_dataset, to_device,
    )
    from densefusion_tpu_torch.geometry import quat_normalize, quat_to_matrix
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        create_train_state, make_pose_train_step,
    )

    from densefusion_tpu_torch import native
    if not native.fused_scan_supported():
        raise AssertionError("[4f] the readers' host library is off")
    t0 = time.perf_counter()
    generate_ycb_style_dataset(root, n_classes=NUM_OBJ, n_real=DATA_FRAMES,
                               n_syn=DATA_FRAMES, n_test=2, seed=SEED)
    gen_s = time.perf_counter() - t0
    ds = YCBDataset(root, "train", num_points=NUM_POINTS, crop_size=CROP)
    if (len(ds), len(ds.classes), ds.num_mesh) != (2 * DATA_FRAMES, NUM_OBJ,
                                                   NUM_MESH):
        raise AssertionError(f"reader: {len(ds)} frames, {len(ds.classes)} "
                             f"classes, M={ds.num_mesh}")
    thread = BatchLoader(ds, TRAIN_BATCH, num_workers=DATA_WORKERS, seed=SEED)
    proc = BatchLoader(ds, TRAIN_BATCH, num_workers=DATA_WORKERS, seed=SEED,
                       worker_mode="process")
    try:
        order = np.arange(len(ds))
        np.random.default_rng((SEED, 1)).shuffle(order)
        got = np.concatenate(thread.batch_indices(1))
        if not np.array_equal(got, order):
            raise AssertionError(f"batch order of epoch 1 {got} is not "
                                 f"default_rng((seed, 1)).shuffle {order}")
        t0 = time.perf_counter()
        tb = list(thread.epoch(1))
        thread_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pb = list(proc.epoch(1))
        proc_s = time.perf_counter() - t0
        tail = list(proc.epoch(1, start_batch=1))
        for label, xs, ys in (("fork workers", pb, tb),
                              ("epoch(1, start_batch=1)", tail, tb[1:])):
            if len(xs) != len(ys):
                raise AssertionError(f"{label}: {len(xs)} batches, want "
                                     f"{len(ys)}")
            for x, y in zip(xs, ys):
                for f, a, b in zip(x._fields, x, y):
                    if a.dtype != b.dtype or not np.array_equal(a, b):
                        raise AssertionError(f"{label}: field {f} differs "
                                             "from the thread loader's")
        for b in tb:
            if (b.points.shape != (TRAIN_BATCH, NUM_POINTS, 3)
                    or b.img.shape != (TRAIN_BATCH, CROP, CROP, 3)
                    or b.model_points.shape != (TRAIN_BATCH, NUM_MESH, 3)
                    or not (np.isfinite(b.points).all()
                            and np.isfinite(b.img).all())
                    or not np.array_equal(b.sym, np.isin(b.obj_idx, YCB_SYM))
                    or not b.valid.any()):
                raise AssertionError("a loader batch has the wrong shapes, "
                                     "non-finite values, wrong sym flags or "
                                     "no valid row")
        log(f"[4f] synthetic YCB root ({NUM_OBJ} classes, {DATA_FRAMES} real "
            f"+ {DATA_FRAMES} synthetic frames) written in {gen_s:.2f} s; "
            f"epoch 1 in {len(tb)} batches of {TRAIN_BATCH}: thread "
            f"{thread_s:.2f} s, fork workers {proc_s:.2f} s (pool start "
            f"included), bit-identical; resume from batch 1 equal; order "
            f"== default_rng(({SEED}, 1)).shuffle")

        def batches():
            """TRAIN_STEPS batches from the fork workers, epochs 2, 3, ..."""
            n, epoch = 0, 2
            while True:
                for b in proc.epoch(epoch):
                    yield b
                    n += 1
                    if n == TRAIN_STEPS:
                        return
                epoch += 1

        kernels = {"add_dist_paired": add_dist.paired_kernel,
                   "add_dist_min": add_dist.min_kernel,
                   "phase_conv": phase_conv.phase_conv_kernel}
        want = {"add_dist_paired": 1, "add_dist_min": 1, "phase_conv": 3}
        totals = dict.fromkeys(kernels, 0)
        state = create_train_state(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ),
                                   LR, SEED)
        step = make_pose_train_step(state, use_adds=True)
        losses, sym_rows, last = [], [], None
        for i, b in enumerate(PrefetchIterator(batches(), depth=2)):
            before = _snapshot(state.posenet)
            last = to_device(b, "cuda")
            for k in kernels.values():
                k.launches = 0
            metrics = step(last, W)
            torch.cuda.synchronize()
            got = {name: k.launches for name, k in kernels.items()}
            if got != want:
                raise AssertionError(f"data step {i}: launches {got}, "
                                     f"expected {want}")
            for name, n in got.items():
                totals[name] += n
            loss = float(metrics["loss"])
            if not (np.isfinite(loss) and np.isfinite(float(metrics["dis"]))
                    and _finite_grads(state.posenet)):
                raise AssertionError(f"data step {i}: non-finite loss {loss} "
                                     "or gradients")
            if not _moved(state.posenet, before):
                raise AssertionError(f"data step {i}: no parameter moved")
            losses.append(loss)
            sym_rows.append(int((b.sym & b.valid).sum()))
            log(f"[4f] data step {i}: loss {loss:.6f}, {int(b.valid.sum())} "
                f"valid rows, {sym_rows[-1]} symmetric (the min kernel's "
                f"active rows), launches {got}")
        if len(losses) != TRAIN_STEPS or not any(sym_rows):
            raise AssertionError(f"data path: {len(losses)} steps, symmetric "
                                 f"rows {sym_rows}")

        # both distance kernels against their plain versions on the last
        # batch (its model and target points, gated by its symmetric rows)
        # at the PoseNet's own hypotheses; these launches are not counted
        with torch.no_grad():
            state.posenet.eval()
            out = state.posenet(last.img, last.points, last.choose,
                                last.obj_idx)
        args = (quat_to_matrix(quat_normalize(out["pred_r"])).contiguous(),
                (last.points + out["pred_t"]).contiguous(),
                last.model_points.contiguous(), last.target.contiguous())
        sym_i = last.sym.to(torch.int32)
        max_err = {}
        for name, kernel, plain, act in (
                ("add_dist_paired", add_dist.paired_kernel,
                 add_dist.paired_plain, 1 - sym_i),
                ("add_dist_min", add_dist.min_kernel, add_dist.min_plain,
                 sym_i)):
            kd, kc = kernel(*args, act)
            pd, pc = plain(*args, act)
            torch.cuda.synchronize()
            if not torch.allclose(kd, pd, rtol=1e-5, atol=0.0):
                raise AssertionError(f"{name}: dis differs on a loader "
                                     f"batch: {float((kd - pd).abs().max())}")
            cerr = float((kc - pc).abs().max())
            if cerr > 2e-5:
                raise AssertionError(f"{name}: coefficients differ on a "
                                     f"loader batch: {cerr}")
            max_err[name] = max(float((kd - pd).abs().max()), cerr)
        log(f"[4f] paired / min kernel == plain on the last loader batch "
            f"({int(sym_i.sum())} symmetric rows, PoseNet hypotheses): max "
            f"abs err {max_err}")
    finally:
        proc.close()
    return {"launches": totals, "losses": losses, "sym_rows": sym_rows,
            "max_err": max_err, "generate_s": gen_s}


@contextlib.contextmanager
def host_library(on: bool):
    """The readers' host library on (as built) or off: ``native._load``
    finds none, so every call site takes its numpy plain version (fork
    workers started inside inherit the switch)."""
    from densefusion_tpu_torch import native

    real = native._load
    if not on:
        native._load = lambda: None
    try:
        yield
    finally:
        native._load = real


def host_plane(root: str) -> dict:
    """Phase 4o: the host data-plane library (``csrc/dfnative.cpp``), the
    readers' default path. A fresh ``g++`` build into a temporary
    directory, timed (the cost of a first use in a fresh checkout); every
    entry point against its numpy plain version on the 4f root's frames
    (back-projection rtol 1e-5, the normalize + resize atol 1e-4, the
    jitter atol 0.35, PNG decode, the label scans, compositing and the
    pool's noise exact); then the root's test-mode samples through the
    library against the numpy path, every float field within 5e-5 and the
    rest exact. Returns the build seconds and each check's worst error."""
    import ctypes
    from PIL import Image
    from densefusion_tpu_torch import native
    from densefusion_tpu_torch.data import YCBDataset
    from densefusion_tpu_torch.data.augment import (
        _noise_pool, apply_color_jitter, jitter_params, resize_bilinear_np,
    )
    from densefusion_tpu_torch.data.common import pinhole_point_fn_np
    from densefusion_tpu_torch.data.schema import (
        IMAGENET_MEAN_255, IMAGENET_STD_255, normalize_image,
    )
    from densefusion_tpu_torch.geometry.bbox import (
        remap_choose_to_resized, snap_bbox,
    )
    from densefusion_tpu_torch.ops import build

    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        rep = build.build_host(build=Path(tmp))
        version = ctypes.CDLL(str(build.host_library_path(
            build=Path(tmp)))).df_version()
    if version != native.VERSION:
        raise AssertionError(f"[4o] fresh build reports version {version}")
    lib_path = Path(native._load()._name)
    if lib_path.parent != build.BUILD or not lib_path.name.startswith(
            "libdfnative-"):
        raise AssertionError(f"[4o] the readers load {lib_path}")
    log(f"[4o] host library: g++ build {rep['seconds']:.2f} s (fresh, into "
        f"a temporary directory); the readers use {lib_path.name}")

    worst: dict[str, float] = {}

    def check(name, got, want, atol=0.0, rtol=0.0):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape:
            raise AssertionError(f"[4o] {name}: shape {got.shape}, want "
                                 f"{want.shape}")
        if atol == rtol == 0.0:
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(f"[4o] {name} differs from its plain "
                                     "version")
            err = 0.0
        else:
            diff = np.abs(got.astype(np.float64) - want)
            if not (diff <= atol + rtol * np.abs(want)).all():
                raise AssertionError(f"[4o] {name}: max abs err "
                                     f"{float(diff.max())} over atol {atol} "
                                     f"rtol {rtol}")
            err = float(diff.max()) if diff.size else 0.0
        worst[name] = max(worst.get(name, 0.0), err)

    def png(path):
        with Image.open(path) as im:
            return np.array(im)

    ds = YCBDataset(root, "train", num_points=NUM_POINTS, crop_size=CROP)
    rng = np.random.default_rng(SEED + 11)
    pool = _noise_pool()
    frames = ds.real[:6] + ds.syn[:6]
    for k, fr in enumerate(frames):
        c_path, d_path, l_path, m_path = ds._frame_paths(fr)
        for p in (c_path, d_path, l_path):
            check("decode_png", native.decode_png_file(p), png(p))
        rgb, depth, label = (png(c_path)[..., :3], png(d_path),
                             png(l_path))
        cam, cam_scale = ds._intrinsics(fr), ds._load_meta(m_path)[2]
        valid = depth != 0
        ids = [int(i) for i in np.unique(label) if i != 0]

        counts, bboxes = native.label_hist_bbox(label, depth)
        want_counts = np.bincount(label[valid], minlength=256)
        want_counts[0] = 0      # the scan skips the background
        check("label_hist_bbox counts", counts, want_counts)
        check("label_depth_hist", native.label_depth_hist(label, depth)[1:],
              want_counts[1:])
        want_bb = np.full((256, 4), -1, np.int64)
        for i in ids:
            rs, cs = np.nonzero(label == i)
            want_bb[i] = (rs.min(), rs.max() + 1, cs.min(), cs.max() + 1)
        check("label_hist_bbox bboxes", bboxes, want_bb)

        # occluders: two objects of another synthetic frame
        f_label = png(ds._frame_paths(ds.syn[(k + 1) % len(ds.syn)])[2])
        f_ids = [int(i) for i in np.unique(f_label) if i != 0][:2]
        keep = ~np.isin(f_label, f_ids)
        out, front, n, c2, b2 = native.apply_front_hist_bbox(
            label, f_label, depth, *f_ids)
        check("apply_front_hist_bbox label", out, label * keep)
        check("apply_front_hist_bbox front", front, keep)
        check("apply_front_hist_bbox count", n, int(((label * keep) != 0)
                                                    .sum()))
        c3, b3 = native.label_hist_bbox(label * keep, depth)
        check("apply_front_hist_bbox counts", c2, c3)
        check("apply_front_hist_bbox bboxes", b2, b3)
        o3, f3, n3 = native.apply_front(label, f_label, *f_ids)
        check("apply_front", (o3, f3), (label * keep, keep))

        back = png(ds._frame_paths(ds.real[(k + 1) % len(ds.real)])[0])
        for obj in [i for i in ids if want_counts[i] > 50][:3]:
            ml, mv, box, cnt = native.object_mask(label, depth, obj)
            check("object_mask", (ml, mv), (label == obj,
                                            (label == obj) & valid))
            rmin, rmax, cmin, cmax = snap_bbox(*want_bb[obj],
                                               img_h=label.shape[0],
                                               img_w=label.shape[1])
            win = np.s_[rmin:rmax, cmin:cmax]
            mask_win = native.object_mask_window(label, depth, obj, rmin,
                                                 rmax, cmin, cmax)
            check("object_mask_window", mask_win,
                  ((label == obj) & valid)[win])
            rows, cols = np.nonzero(mask_win)
            rows, cols = rows + rmin, cols + cmin
            check("backproject", native.backproject(
                depth[rows, cols], rows, cols, cam.fx, cam.fy, cam.cx,
                cam.cy, cam_scale, 1.0),
                pinhole_point_fn_np(depth, cam, cam_scale)(rows, cols),
                rtol=1e-5)
            choose = (rows - rmin) * (cmax - cmin) + (cols - cmin)
            check("remap_choose", native.remap_choose(
                choose, rmax - rmin, cmax - cmin, CROP, CROP),
                remap_choose_to_resized(choose, rmax - rmin, cmax - cmin,
                                        CROP, CROP))
            crop, back_win, occluder = rgb[win], back[win][..., :3], \
                rgb[::-1][win]
            plain = np.where((label[win] == 0)[..., None], back_win, crop)
            check("compose_crop", native.compose_crop(
                crop, back_win, label[win], occluder, keep[win]),
                np.where(keep[win][..., None], plain, occluder))
            for src in (crop, crop.astype(np.float32)):
                check("normalize_resize", native.normalize_resize(
                    src, CROP, CROP, IMAGENET_MEAN_255, IMAGENET_STD_255),
                    resize_bilinear_np(normalize_image(src), CROP, CROP),
                    atol=1e-4)
            params = jitter_params(rng)
            jit = native.color_jitter(crop, *params)
            check("color_jitter", jit, apply_color_jitter(
                crop.astype(np.float64), params), atol=0.35)
            off = int(rng.integers(pool.size - jit.size + 1))
            check("add_scaled", native.add_scaled(jit.copy(), pool[off:],
                                                  7.0),
                  jit + np.float32(7.0) * pool[off:off + jit.size].reshape(
                      jit.shape))
    mask = label != 0
    picked = native.choose_pixels(mask, NUM_POINTS, seed=SEED)
    if not (len(np.unique(picked)) == NUM_POINTS and (np.diff(picked) > 0)
            .all() and mask.reshape(-1)[picked].all()):
        raise AssertionError("[4o] choose_pixels: not a sorted subset of "
                             "the mask without repeats")
    noise = native.gaussian_noise(np.zeros(1 << 16, np.float32), 7.0, SEED)
    if not (abs(noise.mean()) < 0.5 and 6.0 < noise.std() < 8.0):
        raise AssertionError(f"[4o] gaussian_noise moments {noise.mean()}, "
                             f"{noise.std()}")
    log(f"[4o] every entry point against its plain version on "
        f"{len(frames)} frames of the 4f root: worst errors {worst}")

    # test-mode samples (no augmentation: the real frames of the training
    # list and the test list) through the library against the numpy path
    sample_err, n = {}, 0
    for mode in ("train", "test"):
        with host_library(False):
            plain_ds = YCBDataset(root, mode, add_noise=False,
                                  num_points=NUM_POINTS, crop_size=CROP)
            idx = [i for i, fr in enumerate(plain_ds.frames)
                   if fr.startswith("data/")]
            want = [plain_ds[i] for i in idx]
        lib_ds = YCBDataset(root, mode, add_noise=False,
                            num_points=NUM_POINTS, crop_size=CROP)
        for i, w in zip(idx, want):
            g = lib_ds[i]
            for name in w._fields:
                a, b = np.asarray(getattr(g, name)), np.asarray(
                    getattr(w, name))
                if b.dtype == np.float32:
                    check(f"sample {name}", a, b, atol=5e-5)
                    sample_err[name] = worst[f"sample {name}"]
                else:
                    check(f"sample {name}", a, b)
            n += 1
    log(f"[4o] {n} test-mode samples of the 4f root, library against the "
        f"numpy path: float fields within {sample_err}, the rest exact")
    return {"build_s": rep["seconds"], "library": lib_path.name,
            "worst": worst, "samples": n}


@contextlib.contextmanager
def counted_epochs(kernels: dict):
    """Patch the port's ``Trainer`` so that every train and test epoch sets
    the launch counts of ``kernels`` to 0 just before it and reads them
    just after: yields ``{"train": [...], "test": [...]}``, one record per
    epoch (epoch, phase, launches, seconds, the epoch's result)."""
    from densefusion_tpu_torch.train import loop

    records = {"train": [], "test": []}
    originals = {kind: getattr(loop.Trainer, f"{kind}_epoch")
                 for kind in records}

    def counted(kind):
        def epoch(self):
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            value = originals[kind](self)
            torch.cuda.synchronize()
            records[kind].append({
                "epoch": self.curriculum.epoch, "phase": self._phase(),
                "launches": {n: k.launches for n, k in kernels.items()},
                "seconds": time.perf_counter() - t0, "value": value})
            return value
        return epoch

    for kind in records:
        setattr(loop.Trainer, f"{kind}_epoch", counted(kind))
    try:
        yield records
    finally:
        for kind, fn in originals.items():
            setattr(loop.Trainer, f"{kind}_epoch", fn)


def _check_epoch_launches(records: list, label: str,
                          absent: tuple = ()) -> None:
    """Every kernel of the path launched in every train epoch, but those in
    ``absent`` (a path without symmetric rows never launches the ADD-S
    kernel), which launched no time; kernel 6 three times per step (the
    PoseNet forward)."""
    for r in records:
        log(f"[{label}] epoch {r['epoch']} ({r['phase']}): "
            f"{r['seconds']:.2f} s, avg_dis {r['value']:.5f}, launches "
            f"{r['launches']}")
        if any((n == 0) != (k in absent) for k, n in r["launches"].items()):
            raise AssertionError(f"[{label}] epoch {r['epoch']}: launches "
                                 f"{r['launches']}, want 0 exactly for "
                                 f"{absent}")
        if r["launches"]["phase_conv"] % 3:
            raise AssertionError(f"[{label}] epoch {r['epoch']}: kernel 6 "
                                 f"launched {r['launches']['phase_conv']} "
                                 "times, not 3 per step")


def _train_metrics(log_dir: str) -> list:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train_epoch"]


def _state_equal(a, b) -> list:
    """Names of what differs between two port train states (parameters,
    the active Adam's moments and steps by parameter name, the step, the
    generator, the JAX key); empty when they are equal bit for bit."""
    bad = []
    for name in ("posenet", "refiner"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        bad += [f"{name}.{k}" for k in sa if not torch.equal(sa[k], sb[k])]
    for module_a, module_b in ((a.posenet, b.posenet), (a.refiner, b.refiner)):
        pb = dict(module_b.named_parameters())
        for k, p in module_a.named_parameters():
            st_a, st_b = a.optimizer.state.get(p), b.optimizer.state.get(pb[k])
            if (st_a is None) != (st_b is None):
                bad.append(f"adam state presence {k}")
            elif st_a is not None:
                bad += [f"adam {f} {k}" for f in ("step", "exp_avg",
                                                  "exp_avg_sq")
                        if not torch.equal(st_a[f], st_b[f])]
    if a.step != b.step:
        bad.append("step")
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        bad.append("generator")
    if not np.array_equal(a.rng_key, b.rng_key):
        bad.append("rng_key")
    return bad


def cli_train_path(kernels: dict, root: str, out: str, samples) -> dict:
    """Phase 4g: ``cli.train.main`` at the YCB width on the 4f root: two
    epochs, both gates after the first (decay and refine margins above any
    distance), so epoch 2 trains the refiner on data rebuilt at 2600 mesh
    points; each epoch's launches of kernels 1, 2 and 6 counted. Then a
    fresh ``Trainer`` resumes from ``checkpoint_current`` (its state equal
    bit for bit to the one saved), the file read back with the port's codec
    holds the flax layout, epoch 3 trains, and ``PoseEstimator.
    from_checkpoint(checkpoint_best_refine)`` equals, bit for bit, an
    estimator built from the trainer's own state_dicts on B=64 samples."""
    import dataclasses

    from densefusion_tpu_torch import compat
    from densefusion_tpu_torch.cli import train as train_cli
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.serve import PoseEstimator
    from densefusion_tpu_torch.train import (
        Trainer, load_checkpoint, save_checkpoint,
    )
    from densefusion_tpu_torch.train.msgpack import unpack

    logs = os.path.join(out, "logs")
    with counted_epochs(kernels) as rec:
        trainer = train_cli.main([
            "--dataset", "ycb", "--dataset_root", root,
            "--batch_size", str(CLI_BATCH), "--workers", str(DATA_WORKERS),
            "--nepoch", "2", "--decay_margin", "1e9", "--refine_margin",
            "1e9", "--out_dir", out, "--log_dir", logs])
        cur = trainer.curriculum
        if not (cur.epoch == 3 and cur.decay_started and cur.refine_started
                and cur.refine_steps > 0
                and trainer.cfg.num_objects == NUM_OBJ
                and trainer.train_ds[0].model_points.shape == (REFINE_MESH, 3)
                and [r["phase"] for r in rec["train"]] == ["pose", "refine"]):
            phases = [r["phase"] for r in rec["train"]]
            raise AssertionError(f"[4g] curriculum after two epochs: {cur}, "
                                 f"phases {phases}")
        _check_epoch_launches(rec["train"], "4g")
        ck_dir = os.path.join(out, "ycb")
        current = os.path.join(ck_dir, "checkpoint_current")

        # a fresh trainer resumes: everything saved comes back bit for bit
        fresh = Trainer(dataclasses.replace(trainer.cfg, nepoch=3))
        t0 = time.perf_counter()
        fresh.setup(resume=current)
        setup_s = time.perf_counter() - t0
        bad = _state_equal(trainer.state, fresh.state)
        if bad or fresh.curriculum.to_dict() != cur.to_dict():
            raise AssertionError(f"[4g] resumed state differs: {bad[:8]} "
                                 f"{fresh.curriculum} vs {cur}")
        t0 = time.perf_counter()
        load_checkpoint(current, fresh.state, restore_opt=True)
        load_ms = 1e3 * (time.perf_counter() - t0)
        with open(os.path.join(current, "state.msgpack"), "rb") as f:
            raw = unpack(f.read())
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(out, "timed_save"), fresh.state,
                        fresh.curriculum, fresh.cfg)
        save_ms = 1e3 * (time.perf_counter() - t0)
        pose_tree, opt = raw["params_pose"]["params"], raw["opt_state"]
        layout_ok = (
            list(raw) == ["step", "params_pose", "params_refine",
                          "opt_state", "rng", "torch_generator"]
            and list(pose_tree) == ["cnn", "fusion", "head_c", "head_r",
                                    "head_t"]
            and pose_tree["cnn"]["trunk"]["stem"]["kernel"].shape
            == (7, 7, 3, 64)
            and pose_tree["cnn"]["up1"]["prelu"]["slope"].shape == ()
            and raw["rng"].dtype == np.uint32 and raw["rng"].shape == (2,)
            and set(opt) == {"0", "1"} and opt["1"] == {}
            and list(opt["0"]) == ["count", "mu", "nu"]
            and list(opt["0"]["mu"]["params"])
            == list(raw["params_refine"]["params"])
            and int(opt["0"]["count"]) == cur.refine_steps)
        if not layout_ok:
            raise AssertionError("[4g] checkpoint_current does not hold the "
                                 "flax layout")
        for to_torch, key, module in (
                (compat.posenet_state_dict_from_flax, "params_pose",
                 trainer.posenet),
                (compat.refiner_state_dict_from_flax, "params_refine",
                 trainer.refiner)):
            want = to_torch(raw[key])
            for k, v in module.state_dict().items():
                if not torch.equal(v.cpu(), want[k]):
                    raise AssertionError(f"[4g] {key} {k} differs from the "
                                         "trainer's")
        size = os.path.getsize(os.path.join(current, "state.msgpack"))
        size_p1 = os.path.getsize(os.path.join(
            ck_dir, "checkpoint_best_pose", "state.msgpack"))
        log(f"[4g] fresh Trainer resumed from checkpoint_current in "
            f"{setup_s:.2f} s (data, weights, load): parameters, Adam "
            f"moments and steps, step {fresh.state.step}, generator, key, "
            f"curriculum and cursor equal bit for bit; flax layout read "
            f"back with the port's codec; state.msgpack {size} bytes "
            f"(phase 2; phase 1 {size_p1}), load {load_ms:.1f} ms, save "
            f"{save_ms:.1f} ms")
        # serving from the best refine checkpoint against the trainer's
        # weights (before epoch 3, which may save a new best)
        best = os.path.join(ck_dir, "checkpoint_best_refine")
        shape = dict(num_points=samples[0].points.shape[0],
                     crop_size=samples[0].img.shape[0])
        est_ck = PoseEstimator.from_checkpoint(best, NUM_OBJ, **shape)
        states = [{k: v.cpu() for k, v in m.state_dict().items()}
                  for m in (trainer.posenet, trainer.refiner)]
        est_direct = PoseEstimator(
            PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ), *states,
            refine_iters=est_ck.pipeline.refine_iters, **shape)
        kernels["phase_conv"].launches = 0
        got = est_ck.estimate_batch(samples)
        serve_launches = kernels["phase_conv"].launches
        want = est_direct.estimate_batch(samples)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("[4g] from_checkpoint differs from the "
                                 "trainer's own weights")
        if serve_launches != 3:
            raise AssertionError(f"[4g] serving from the checkpoint launched "
                                 f"kernel 6 {serve_launches} times, not 3")
        log(f"[4g] PoseEstimator.from_checkpoint(checkpoint_best_refine), "
            f"K={est_ck.pipeline.refine_iters}: estimate_batch "
            f"B={len(samples)} equal bit for bit to an estimator from the "
            f"trainer's state_dicts; kernel 6 launches {serve_launches}")
        fresh.run()
        fresh.close()
        if fresh.curriculum.epoch != 4 or len(rec["train"]) != 3:
            raise AssertionError(f"[4g] the resumed run: {fresh.curriculum}")
        _check_epoch_launches(rec["train"][2:], "4g")

    metrics = _train_metrics(os.path.join(logs, "ycb"))
    per_epoch = [{"epoch": m["epoch"], "phase": m["phase"],
                  "seconds": m["seconds"], "steps": m["steps"],
                  "steps_per_s": m["steps"] / m["seconds"],
                  "input_bound_fraction": m["input_wait_s"] / m["seconds"],
                  "launches": r["launches"]}
                 for m, r in zip(metrics, rec["train"])]
    for e in per_epoch:
        log(f"[4g] epoch {e['epoch']} ({e['phase']}, "
            f"B={trainer.cfg.batch_size}): "
            f"{e['seconds']:.3f} s, {e['steps']} steps, "
            f"{e['steps_per_s']:.3f} steps/s, input-bound fraction "
            f"{e['input_bound_fraction']:.3f} (time waiting on the loader "
            f"over the epoch)")
    return {"epochs": per_epoch, "test_epochs": rec["test"],
            "checkpoint_bytes": size, "checkpoint_bytes_phase1": size_p1,
            "checkpoint_save_ms": save_ms,
            "checkpoint_load_ms": load_ms, "resume_setup_s": setup_s,
            "serve_launches": serve_launches,
            "pose_state": states[0]}


def linemod_eval_path(kernels: dict, root: str, out: str) -> dict:
    """Phase 4h: a synthetic LineMOD root (eggbox and glue among its
    objects) at the LineMOD width (N=500, 192 px), one epoch of
    ``cli.train``, then ``cli.eval_linemod`` on its checkpoint with native
    crops off and on: ``result.json`` with rates in [0, 1], and the launches
    of kernels 5 (ADD-S scoring) and 6 in each evaluation."""
    from densefusion_tpu_torch.cli import eval_linemod
    from densefusion_tpu_torch.cli import train as train_cli
    from densefusion_tpu_torch.data import generate_linemod_style_dataset

    t0 = time.perf_counter()
    generate_linemod_style_dataset(root, objlist=LM_OBJECTS,
                                   n_train=LM_TRAIN, n_test=20, seed=SEED)
    gen_s = time.perf_counter() - t0
    objs = [str(o) for o in LM_OBJECTS]
    train_kernels = {k: kernels[k] for k in ("add_dist_paired",
                                             "add_dist_min", "phase_conv")}
    with counted_epochs(train_kernels) as rec:
        train_cli.main([
            "--dataset", "linemod", "--dataset_root", root, "--objlist",
            *objs, "--nepoch", "1", "--repeat_epoch", "1", "--batch_size",
            str(LM_BATCH), "--workers", str(DATA_WORKERS), "--out_dir", out,
            "--log_dir", os.path.join(out, "logs")])
    _check_epoch_launches(rec["train"], "4h")
    ck = os.path.join(out, "linemod", "checkpoint_best_pose")
    eval_kernels = {k: kernels[k] for k in ("adds_remap", "phase_conv")}
    results = {}
    for native in ("off", "on"):
        for k in eval_kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        eval_linemod.main([
            "--dataset_root", root, "--checkpoint", ck, "--objlist", *objs,
            "--output_dir", os.path.join(out, f"eval_{native}"),
            "--native_crops", native])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: k.launches for n, k in eval_kernels.items()}
        with open(os.path.join(out, f"eval_{native}", "result.json")) as f:
            result = json.load(f)
        rates = [result["rate_per_pixel"], result["rate_refined"]] + [
            o[key] for o in result["per_object"]
            for key in ("rate_per_pixel", "rate_refined")]
        if not (all(0.0 <= r <= 1.0 for r in rates)
                and result["native_crops"] == (native == "on")
                and len(result["per_object"]) == len(LM_OBJECTS)):
            raise AssertionError(f"[4h] result.json: {result}")
        if 0 in launches.values():
            raise AssertionError(f"[4h] eval (native crops {native}): a "
                                 f"kernel never launched: {launches}")
        results[native] = {"seconds": seconds, "launches": launches,
                           "rate_per_pixel": result["rate_per_pixel"],
                           "rate_refined": result["rate_refined"],
                           "iterations": result["iterations"],
                           "lost": result["lost_detections"]}
        log(f"[4h] eval_linemod (native crops {native}, "
            f"{sum(o['count'] for o in result['per_object'])} frames, "
            f"--iterations {result['iterations']}): per-pixel "
            f"{result['rate_per_pixel']:.4f}, refined "
            f"{result['rate_refined']:.4f}, {seconds:.2f} s, launches "
            f"{launches}")
    return {"generate_s": gen_s, "train_epoch": rec["train"][0]["launches"],
            "eval": results}


@contextlib.contextmanager
def recorded_shapes(kernel):
    """Count ``kernel``'s launches by shape while active (kernel 6's
    entry point takes B, Cin, Cout, h, w after its three pointers): yields
    a ``collections.Counter`` of those tuples."""
    import collections

    shapes = collections.Counter()
    original = kernel.launch

    def launch(dev, *args):
        shapes[tuple(args[3:8])] += 1
        return original(dev, *args)

    kernel.launch = launch
    try:
        yield shapes
    finally:
        del kernel.launch


@contextlib.contextmanager
def counted_forwards():
    """Count PoseNet forwards (calls of ``PoseNet.forward``) while active:
    yields ``{"n": count}``."""
    from densefusion_tpu_torch.models import PoseNet

    count = {"n": 0}
    original = PoseNet.forward

    def forward(self, *args, **kwargs):
        count["n"] += 1
        return original(self, *args, **kwargs)

    PoseNet.forward = forward
    try:
        yield count
    finally:
        PoseNet.forward = original


def _fmt(x) -> str:
    return "n/a" if x is None else f"{x:.2f}"


def _mat_poses(out: str, method: str, frame: int) -> np.ndarray:
    import scipy.io as scio
    return np.asarray(scio.loadmat(os.path.join(
        out, method, f"{frame:04d}.mat"))["poses"], np.float64)


def ycb_eval_path(kernels: dict, ck: str, root: str, out: str,
                  card: str, phase_conv) -> dict:
    """Phase 4i: YCB keyframe evaluation of 4g's ``checkpoint_best_refine``
    at the YCB width (21 classes, N=1000, 192 px) on a root of its own
    (``YCB_KEYFRAMES`` keyframes of ``YCB_OBJS`` objects, fake PoseCNN
    results). ``cli.eval_ycb`` through its three routes, then a
    ``--skip_done`` rerun of the frame route, each with the kernels'
    launches and the PoseNet forwards reset before and read after: kernel 6
    three times per forward under the fused decoder, the remap never (the
    toolbox scores on the host); the rerun runs no forward and writes the
    same ``metrics.json``; the native-crop route on a copy of the
    checkpoint under the dense align-corners decoder (``--native_crops
    auto``) launches kernel 6 no time. Each run's stages are timed apart
    (``eval_ycb.main(timings=)``): the rates are the inference loop's,
    not the set-up's. The frame and detection
    routes' poses agree within 1e-4; ``cli.score_ycb`` on the frame route's
    results gives ``metrics.json``'s table exactly. Then ``cli.visualize``
    on ``VIS_FRAMES`` frames of the root, and the benchmark's ``inference``
    (B=16) and ``latency`` (B=1, K=2). Kernel 6's launches in the
    native-crop route are counted by shape (``native_conv_shapes``)."""
    from densefusion_tpu_torch.cli import eval_ycb, score_ycb, visualize
    from densefusion_tpu_torch.cli.benchmark import (
        bench_inference, bench_latency,
    )
    from densefusion_tpu_torch.data import generate_ycb_style_dataset
    from densefusion_tpu_torch.train.checkpoint import peek_config

    # the same weights under the dense align-corners decoder: no kernel 6
    ck_dense = os.path.join(out, "checkpoint_dense")
    shutil.copytree(ck, ck_dense)
    with open(os.path.join(ck_dense, "config.json"), "w") as f:
        f.write(dataclasses.replace(peek_config(ck), decoder="torch")
                .to_json())
    posecnn = root + "_posecnn"
    t0 = time.perf_counter()
    generate_ycb_style_dataset(root, n_classes=NUM_OBJ, n_real=0, n_syn=0,
                               n_test=YCB_KEYFRAMES, seed=SEED,
                               posecnn_dir=posecnn, objs_per_frame=YCB_OBJS)
    gen_s = time.perf_counter() - t0
    fused = peek_config(ck).decoder_flags()["fused_decoder"]
    args = ["--dataset_root", root, "--posecnn_results", posecnn,
            "--num_keyframes", str(YCB_KEYFRAMES)]
    methods = ("Densefusion_wo_refine_result", "Densefusion_iterative_result")
    routes = {"frame": (ck, ["--dispatch", "frame"]),
              "skip_done": (ck, ["--dispatch", "frame", "--skip_done"]),
              "detection": (ck, ["--dispatch", "detection"]),
              "native": (ck, ["--native_crops", "on"]),
              "native_dense": (ck_dense, ["--native_crops", "auto"])}
    results = {}
    for name, (ck_route, extra) in routes.items():
        out_dir = os.path.join(out, "frame" if name == "skip_done" else name)
        for k in kernels.values():
            k.launches = 0
        stages = {}
        with counted_forwards() as fw, \
                recorded_shapes(phase_conv.phase_conv_kernel) as shapes:
            t0 = time.perf_counter()
            summary = eval_ycb.main([*args, "--checkpoint", ck_route,
                                     "--output_dir", out_dir, *extra],
                                    timings=stages)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if name == "native":
            native_shapes = shapes.most_common()
        launches = {n: k.launches for n, k in kernels.items()}
        with open(os.path.join(out_dir, "metrics.json")) as f:
            metrics_text = f.read()
        rows = summary["methods"]["iterative"]["all"]
        if not (0.0 <= summary["adds_auc"] <= 100.0
                and rows["total"] > 0 and rows["detected"] > 0
                and summary["native_crops"] == name.startswith("native")):
            raise AssertionError(f"[4i] {name}: metrics {summary}")
        want = 3 * fw["n"] if fused and name != "native_dense" else 0
        if name == "skip_done":
            if fw["n"] or any(launches.values()) \
                    or metrics_text != results["frame"]["metrics_text"]:
                raise AssertionError(
                    f"[4i] the --skip_done rerun ran {fw['n']} forwards, "
                    f"launches {launches}, or changed metrics.json")
        elif fw["n"] == 0 or launches["phase_conv"] != want \
                or launches["adds_remap"] != 0:
            raise AssertionError(
                f"[4i] {name}: {fw['n']} PoseNet forwards, launches "
                f"{launches}; want kernel 6 at {want} (3 per forward under "
                f"the fused decoder, 0 under the dense one) and no remap")
        infer_s = stages["infer_s"]
        # keyframes/s of the inference loop (none in the rerun), and without
        # its first keyframe (each batch shape's first call)
        rate = YCB_KEYFRAMES / infer_s if fw["n"] else None
        steady = ((YCB_KEYFRAMES - 1) / (infer_s - stages["first_keyframe_s"])
                  if fw["n"] and "first_keyframe_s" in stages else None)
        results[name] = {"seconds": seconds, "forwards": fw["n"],
                         "launches": launches, "stages": stages,
                         "infer_keyframes_per_s": rate,
                         "steady_keyframes_per_s": steady,
                         "score_s_per_keyframe":
                             stages["score_s"] / YCB_KEYFRAMES,
                         "adds_auc": summary["adds_auc"],
                         "add_auc": summary["add_auc"],
                         "adds_under_2cm": summary["adds_under_2cm"],
                         "per_pixel_adds_auc":
                             summary["methods"]["per-pixel"]["all"][
                                 "adds_auc"],
                         "rows": rows["total"],
                         "iterations": summary["refine_iterations"],
                         "metrics_text": metrics_text}
        log(f"[4i] eval_ycb {name}: {YCB_KEYFRAMES} keyframes, "
            f"{rows['total']} gt objects, --iterations "
            f"{summary['refine_iterations']}: {seconds:.3f} s in all = "
            f"set-up {stages['setup_s']:.3f} + inference loop "
            f"{infer_s:.3f} ({_fmt(rate)} keyframes/s; without the first "
            f"keyframe {_fmt(steady)}) + model "
            f"clouds {stages['models_s']:.3f} + scoring "
            f"{stages['score_s']:.3f} "
            f"({stages['score_s'] / YCB_KEYFRAMES:.4f} s per keyframe); "
            f"{fw['n']} PoseNet forwards, launches {launches}; "
            f"ADD-S AUC {summary['adds_auc']:.2f} (per-pixel "
            f"{results[name]['per_pixel_adds_auc']:.2f}), ADD AUC "
            f"{summary['add_auc']:.2f}; card {card}")
    worst = 0.0
    for method in methods:
        for f in range(YCB_KEYFRAMES):
            a = _mat_poses(os.path.join(out, "frame"), method, f)
            b = _mat_poses(os.path.join(out, "detection"), method, f)
            if a.shape != b.shape:
                raise AssertionError(f"[4i] keyframe {f}: {a.shape} vs "
                                     f"{b.shape} poses")
            worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
    if worst > 1e-4:
        raise AssertionError(f"[4i] frame and detection routes' poses "
                             f"differ by {worst}")
    frame_dir = os.path.join(out, "frame")
    t0 = time.perf_counter()
    table = score_ycb.main([
        "--dataset_root", root, "--posecnn_results", posecnn,
        "--results", f"per-pixel={frame_dir}/{methods[0]}",
        "--results", f"iterative={frame_dir}/{methods[1]}",
        "--num_keyframes", str(YCB_KEYFRAMES),
        "--output_dir", os.path.join(out, "score")])
    score_s = time.perf_counter() - t0
    if json.loads(json.dumps(table)) != \
            json.loads(results["frame"]["metrics_text"])["methods"]:
        raise AssertionError("[4i] score_ycb's table differs from "
                             "metrics.json's")
    log(f"[4i] frame vs detection poses: max diff {worst:.3g}; score_ycb "
        f"reproduces metrics.json's table exactly in {score_s:.3f} s (the "
        f"model clouds' loads included, 2 methods)")

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    written = visualize.main([
        "--dataset", "ycb", "--dataset_root", root, "--checkpoint", ck,
        "--frames", str(VIS_FRAMES), "--num_points", str(NUM_POINTS),
        "--output_dir", os.path.join(out, "vis")])
    vis_s = time.perf_counter() - t0
    vis_launches = {n: k.launches for n, k in kernels.items()}
    if not (0 < len(written) <= VIS_FRAMES
            and all(os.path.getsize(p) > 0 for p in written)
            and vis_launches["phase_conv"] == (3 if fused else 0)):
        raise AssertionError(f"[4i] visualize wrote {written}, launches "
                             f"{vis_launches}")
    log(f"[4i] visualize: {len(written)} overlays in {vis_s:.2f} s, "
        f"launches {vis_launches}")

    for k in kernels.values():
        k.launches = 0
    inference = bench_inference(batch=16)
    latency = bench_latency()   # bf16 compute on the card
    bench_launches = kernels["phase_conv"].launches
    for name, value in (("inference_fps", inference["inference_fps"]),
                        ("latency_ms_median", latency["latency_ms_median"])):
        if not (np.isfinite(value) and value > 0):
            raise AssertionError(f"[4i] {name} {value}")
    log(f"[4i] benchmark --what inference (B=16, K=2, f32): "
        f"{inference['inference_ms_per_batch']:.3f} ms per batch, "
        f"{inference['inference_fps']:.1f} frames/s; --what latency (B=1, "
        f"K=2, {latency['dtype']}): median "
        f"{latency['latency_ms_median']:.3f} ms, p90 "
        f"{latency['latency_ms_p90']:.3f} ms (latency_vs_paper_frame "
        f"{latency['latency_vs_paper_frame']:.2f}: the paper's 0.06 s on "
        f"its GPU over the median); kernel 6's f32 route launches "
        f"{bench_launches} (inference only); card {card}")
    for r in results.values():
        r.pop("metrics_text")
    log(f"[4i] kernel 6 in the native-crop route, launches by (B, Cin, "
        f"Cout, h, w): {native_shapes}")
    return {"generate_s": gen_s, "routes": results,
            "native_conv_shapes": native_shapes,
            "frame_vs_detection_max_diff": worst, "score_ycb_s": score_s,
            "visualize": {"frames": len(written), "seconds": vis_s,
                          "launches": vis_launches},
            "inference": inference, "latency": latency,
            "bench_launches": bench_launches}


def cad_path(kernels: dict, root: str, out: str, card: str) -> dict:
    """Phase 4j: a synthetic customCAD root at the Unity frame size, two
    epochs of ``cli.train --dataset cad`` at the CAD preset's width (N=500,
    192 px, one object, B=8) with both gates after the first, each epoch's
    launches of kernels 1, 2 and 6 counted (kernel 2 never in phase 1: CAD
    has no symmetric class; in phase 2 once per refiner iteration with
    every row gated off, as the JAX refine step runs it); ``cli.eval_cad`` on ``checkpoint_best_refine`` with
    the launches of kernels 5 and 6 (one remap and three kernel-6 launches
    per frame); ``cli.inspect_sample --dataset cad``."""
    from densefusion_tpu_torch.cli import eval_cad, inspect_sample
    from densefusion_tpu_torch.cli import train as train_cli
    from densefusion_tpu_torch.data import generate_cad_style_dataset

    t0 = time.perf_counter()
    generate_cad_style_dataset(root, n_train=CAD_TRAIN, n_test=CAD_TEST,
                               img_h=CAD_DIMS[0], img_w=CAD_DIMS[1],
                               seed=SEED)
    gen_s = time.perf_counter() - t0
    train_kernels = {k: kernels[k] for k in ("add_dist_paired",
                                             "add_dist_min", "phase_conv")}
    logs = os.path.join(out, "logs")
    with counted_epochs(train_kernels) as rec:
        trainer = train_cli.main([
            "--dataset", "cad", "--dataset_root", root, "--objlist", "1",
            "--nepoch", "2", "--batch_size", str(CAD_BATCH), "--workers",
            str(DATA_WORKERS), "--decay_margin", "1e9", "--refine_margin",
            "1e9", "--out_dir", out, "--log_dir", logs])
    cur, cfg = trainer.curriculum, trainer.cfg
    if not (cur.epoch == 3 and cur.decay_started and cur.refine_started
            and cur.refine_steps > 0
            and (cfg.num_points, cfg.crop_size, cfg.num_objects)
            == (500, CROP, 1)
            and [r["phase"] for r in rec["train"]] == ["pose", "refine"]):
        raise AssertionError(f"[4j] curriculum after two epochs: {cur}")
    # phase 1 skips the ADD-S branch (no symmetric class); the refiner's
    # loss keeps it, as the JAX refine step does, with every row gated off
    _check_epoch_launches(rec["train"][:1], "4j", absent=("add_dist_min",))
    _check_epoch_launches(rec["train"][1:], "4j")
    metrics = _train_metrics(os.path.join(logs, "cad"))
    epochs = [{"epoch": m["epoch"], "phase": m["phase"],
               "seconds": m["seconds"], "steps": m["steps"],
               "input_bound_fraction": m["input_wait_s"] / m["seconds"],
               "launches": r["launches"]}
              for m, r in zip(metrics, rec["train"])]

    eval_kernels = {k: kernels[k] for k in ("adds_remap", "phase_conv")}
    for k in eval_kernels.values():
        k.launches = 0
    eval_dir = os.path.join(out, "eval")
    t0 = time.perf_counter()
    rate = eval_cad.main([
        "--dataset_root", root, "--checkpoint",
        os.path.join(out, "cad", "checkpoint_best_refine"),
        "--output_dir", eval_dir])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in eval_kernels.items()}
    with open(os.path.join(eval_dir, "eval_log.txt")) as f:
        frames = sum(" dis " in line for line in f)
    if not (0.0 <= rate <= 1.0 and frames == CAD_TEST // 10
            and launches == {"adds_remap": frames,
                             "phase_conv": 3 * frames}
            and os.path.exists(os.path.join(eval_dir, "pred_pcld_0.ply"))):
        raise AssertionError(f"[4j] eval_cad: rate {rate}, {frames} frames, "
                             f"launches {launches}")
    nn_mm = 1e3 * inspect_sample.main([
        "--dataset", "cad", "--dataset_root", root, "--out_dir",
        os.path.join(out, "inspect")])
    if not nn_mm < 10.0:
        raise AssertionError(f"[4j] inspect_sample: cloud to target "
                             f"{nn_mm} mm")
    log(f"[4j] CAD root ({CAD_TRAIN} + {CAD_TEST} frames at "
        f"{CAD_DIMS[0]}x{CAD_DIMS[1]}) in {gen_s:.2f} s; eval_cad "
        f"(--iterations 4, {frames} frames): success rate {rate:.3f} at "
        f"0.01 m, {eval_s:.2f} s, launches {launches}; inspect_sample "
        f"cloud to target {nn_mm:.2f} mm; card {card}")
    return {"generate_s": gen_s, "epochs": epochs,
            "eval": {"rate": rate, "frames": frames, "seconds": eval_s,
                     "launches": launches},
            "inspect_nn_mm": nn_mm}


def seeded_segnet_variables(rng: np.random.Generator) -> dict:
    """Full-width SegNet variables in the JAX layout (``{"params",
    "batch_stats"}``, the tree ``densefusion_tpu_torch.compat`` carries),
    every leaf drawn from ``rng``: conv kernels N(0, 2 / fan_in), biases
    and BN shifts N(0, 0.05^2), BN scales near 1, running means N(0,
    0.1^2), running variances in [0.5, 1.5]."""
    from densefusion_tpu_torch import compat
    from densefusion_tpu_torch.models import SegNet

    sd = {}
    for k, v in SegNet(SEG_CLASSES).state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean"):
            a = 0.1 * rng.standard_normal(shape)
        elif k.startswith("bn") and k.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif k.endswith("weight"):
            a = rng.standard_normal(shape) * np.sqrt(
                2.0 / np.prod(shape[1:]))
        else:
            a = 0.05 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return compat.segnet_variables_from_state_dict(sd)


def _pre_bn_bias(name: str) -> bool:
    """A conv bias ahead of a BN: its exact gradient is 0 (BN subtracts
    its shift), so card and CPU each hold rounding noise there."""
    return name.startswith("conv") and name != "conv11d.bias" \
        and name.endswith("bias")


def _seg_step_on(variables, x, label, dev, dtype) -> dict:
    """One SegNet train step (fresh Adam) from ``variables`` on ``dev`` in
    ``dtype``: loss, gradients and updated BN statistics, on the CPU."""
    from densefusion_tpu_torch import compat
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import (
        create_seg_train_state, make_seg_train_step,
    )

    state = create_seg_train_state(SegNet(SEG_CLASSES), device=dev)
    state.segnet.load_state_dict(
        compat.segnet_state_dict_from_flax(variables), strict=True)
    net = state.segnet.to(dtype)
    loss = make_seg_train_step(state)(x.to(dev, dtype), label.to(dev))
    return {"loss": float(loss),
            "grads": {n: p.grad.detach().cpu().double()
                      for n, p in net.named_parameters()},
            "stats": {n: v.cpu().double() for n, v in net.state_dict().items()
                      if "running" in n}}


def _seg_step_errors(got: dict, want: dict) -> dict:
    """Relative distances of two :func:`_seg_step_on` results: the loss,
    gradients (each tensor's largest difference over its largest; the
    pre-BN conv biases, whose exact gradient is 0, over the largest
    gradient of the network) and statistics (over each tensor's
    largest)."""
    top = max(float(g.abs().max()) for d in (got, want)
              for g in d["grads"].values())
    grad, bias = 0.0, 0.0
    for n, g in want["grads"].items():
        if _pre_bn_bias(n):
            bias = max(bias, float((got["grads"][n] - g).abs().max()) / top)
        else:
            grad = max(grad, float((got["grads"][n] - g).abs().max()
                                   / g.abs().max()))
    stats = max(float((got["stats"][n] - v).abs().max() / v.abs().max())
                for n, v in want["stats"].items())
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_rel": grad, "pre_bn_bias_grad_over_top": bias,
            "stats_rel": stats}


def segnet_card_vs_cpu(rng: np.random.Generator) -> dict:
    """[4k] 1: full-width SegNet, B=2 at 96x128, the same seeded JAX-layout
    variables on the card and on the CPU (TF32 off).

    float32: eval logits within 1e-4 of the largest, one train step's loss
    rel 1e-4, and the argmax pool of the first block's map (exact zeros
    after the ReLU tie) equal on both devices. The float32 gradients and
    statistics are a reading beside the CPU's own distance from float64:
    at this shape the deep stages hold 96-384 positions per channel, and a
    near-tie that pools to another position on one device moves a decoder
    input pixel, so the float32 CPU step itself is ~0.29 of the largest
    gradient away from float64 in the decoder convs. The gate on the
    step's arithmetic is therefore the float64 step on both devices:
    gradients and statistics within 1e-6 of each tensor's largest, loss rel
    1e-9 (the pre-BN conv biases, whose exact gradient is 0, within 1e-6
    of the largest gradient)."""
    from densefusion_tpu_torch import compat
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.models.layers import max_pool_argmax

    variables = seeded_segnet_variables(rng)
    b, h, w = SEG_CARD_SHAPE
    x = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(
        np.float32))
    label = torch.from_numpy(rng.integers(0, SEG_CLASSES, (b, h, w)))
    logits, blocks = {}, {}
    for dev in ("cpu", "cuda"):
        net = SegNet(SEG_CLASSES)
        net.load_state_dict(compat.segnet_state_dict_from_flax(variables))
        net = net.to(dev).eval()
        with torch.no_grad():
            logits[dev] = net(x.to(dev)).cpu()
            blocks[dev] = torch.relu(net.bn11(net.conv11(x.to(dev)))).cpu()
    logit_err = float((logits["cuda"] - logits["cpu"]).abs().max()
                      / logits["cpu"].abs().max())
    # the pooling op alone on one map: tie-breaking on both devices
    block = blocks["cpu"]
    pooled, idx = max_pool_argmax(block)
    pooled_c, idx_c = max_pool_argmax(block.cuda())
    pool_equal = bool(torch.equal(idx, idx_c.cpu())
                      and torch.equal(pooled, pooled_c.cpu()))
    steps = {(dev, dt): _seg_step_on(variables, x, label, dev, dt)
             for dev in ("cpu", "cuda")
             for dt in (torch.float32, torch.float64)}
    f32 = _seg_step_errors(steps["cuda", torch.float32],
                           steps["cpu", torch.float32])
    cpu_vs_f64 = _seg_step_errors(steps["cpu", torch.float32],
                                  steps["cpu", torch.float64])
    f64 = _seg_step_errors(steps["cuda", torch.float64],
                           steps["cpu", torch.float64])
    reading = {"logits_rel": logit_err, "pool_equal": pool_equal,
               "zeros_in_pooled_map": int((block == 0).sum()),
               "f32_card_vs_cpu": f32, "f32_cpu_vs_f64": cpu_vs_f64,
               "f64_card_vs_cpu": f64}
    if not (logit_err <= 1e-4 and pool_equal and f32["loss_rel"] <= 1e-4
            and f64["loss_rel"] <= 1e-9 and f64["grad_rel"] <= 1e-6
            and f64["pre_bn_bias_grad_over_top"] <= 1e-6
            and f64["stats_rel"] <= 1e-6):
        raise AssertionError(f"[4k] SegNet card vs CPU: {reading}")
    log(f"[4k] SegNet card vs CPU (B={b}, {h}x{w}, {SEG_CLASSES} classes, "
        f"full width, TF32 off): {reading}")
    return reading


def _mask_stats(root: str, objs) -> dict:
    """Per object: test frames, frames with a non-empty SegNet mask, and
    the IoU of SegNet's masks against the ground-truth masks (over all
    test frames)."""
    from PIL import Image

    stats = {}
    for obj in objs:
        base = os.path.join(root, "data", f"{obj:02d}")
        with open(os.path.join(base, "test.txt")) as f:
            frames = [int(ln) for ln in f if ln.strip()]
        inter = union = nonempty = 0
        for fr in frames:
            pred = np.array(Image.open(os.path.join(
                root, "segnet_results", f"{obj:02d}_label",
                f"{fr:04d}_label.png"))) == 255
            gt = np.array(Image.open(os.path.join(
                base, "mask", f"{fr:04d}.png"))) == 255
            if gt.ndim == 3:
                gt = gt[..., 0]
            nonempty += bool(pred.any())
            inter += int((pred & gt).sum())
            union += int((pred | gt).sum())
        stats[obj] = {"frames": len(frames), "nonempty": nonempty,
                      "iou": inter / max(union, 1)}
    return stats


def segnet_path(kernels: dict, lm_root: str, lm_ck: str, out: str,
                card: str) -> dict:
    """Phase 4k: SegNet and the FAT tools.

    1. SegNet on the card against the CPU (:func:`segnet_card_vs_cpu`);
    2. ``cli.train_seg --format linemod`` on a copy of [4h]'s 480x640 root
       (ape, eggbox, glue: 12 classes), B=8, ``SEG_EPOCHS`` epochs; then
       ``segnet_latest.msgpack`` reloaded into a fresh state equal bit for
       bit (parameters, BN statistics, Adam moments and step);
    3. ``cli.segment --binary_class <obj> --class_vs_bg`` per object into
       the copy's ``segnet_results/`` (the generator's ground-truth masks
       removed first);
    4. ``cli.eval_linemod --mode eval`` of [4h]'s checkpoint on those masks:
       rates in [0, 1]; kernel 6 exactly three launches per PoseNet
       forward, kernel 5 launched (counts reset before, read after); the
       frames with a non-empty mask and the masks' IoU against the ground
       truth (an empty mask is an invalid sample, as in JAX);
    5. ``bench_seg`` (B=4, 480x640, 22 classes) beside its FLOP bound;
    6. ``cli.verify_fat`` on a generated FAT scene (every object ok, mean
       NN distance under 1 cm), then ``cli.reconstruct_fat``'s PLYs."""
    from densefusion_tpu_torch.cli import (
        eval_linemod, reconstruct_fat, segment, train_seg, verify_fat,
    )
    from densefusion_tpu_torch.cli.benchmark import bench_seg
    from densefusion_tpu_torch.data import fat, generate_fat_style_scene
    from densefusion_tpu_torch.data.ply import write_ply
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import (
        create_seg_train_state, load_seg_latest,
    )

    result = {"card_vs_cpu": segnet_card_vs_cpu(
        np.random.default_rng(SEED + 9))}

    # 2. train_seg on a copy of the LineMOD root
    root = os.path.join(out, "root")
    shutil.copytree(lm_root, root)
    shutil.rmtree(os.path.join(root, "segnet_results"))
    seg_out, seg_logs = os.path.join(out, "segnet"), os.path.join(out, "logs")
    run = train_seg.main([
        "--dataset_root", root, "--format", "linemod", "--objlist",
        *[str(o) for o in LM_OBJECTS], "--batch_size", str(SEG_BATCH),
        "--n_epochs", str(SEG_EPOCHS), "--workers", str(DATA_WORKERS),
        "--out_dir", seg_out, "--log_dir", seg_logs])
    records = run["epochs"]
    torch.cuda.synchronize()
    num_classes = max(LM_OBJECTS) + 1
    if not ([r["epoch"] for r in records] == list(range(1, SEG_EPOCHS + 1))
            and all(np.isfinite(r["train_loss"]) and np.isfinite(
                r["test_loss"]) and 0.0 <= r["fg_iou"] <= 1.0
                for r in records)):
        raise AssertionError(f"[4k] train_seg epochs: {records}")
    for r in records:
        log(f"[4k] train_seg epoch {r['epoch']}: {r['seconds']:.2f} s, "
            f"train loss {r['train_loss']:.4f}, test loss "
            f"{r['test_loss']:.4f}, pixel acc {r['pixel_acc']:.4f}, fg IoU "
            f"{r['fg_iou']:.4f} (B={SEG_BATCH}, 480x640, {num_classes} "
            f"classes); card {card}")
    # the latest file into a fresh state: every tensor bit for bit
    trained = run["state"]
    latest = os.path.join(seg_out, "segnet_latest.msgpack")
    fresh = create_seg_train_state(SegNet(num_classes), seed=SEED + 1)
    t0 = time.perf_counter()
    epoch, best = load_seg_latest(latest, fresh)
    load_s = time.perf_counter() - t0
    same = (epoch == SEG_EPOCHS and fresh.step == trained.step
            and best == np.float32(min(r["test_loss"] for r in records)))
    want = trained.segnet.state_dict()
    same = same and all(torch.equal(v, want[k]) for k, v in
                        fresh.segnet.state_dict().items())
    for p, q in zip(fresh.segnet.parameters(), trained.segnet.parameters()):
        a, b = fresh.optimizer.state[p], trained.optimizer.state[q]
        same = same and int(a["step"]) == int(b["step"]) and all(
            torch.equal(a[m], b[m]) for m in ("exp_avg", "exp_avg_sq"))
    if not same:
        raise AssertionError("[4k] segnet_latest.msgpack does not reload "
                             "bit for bit")
    log(f"[4k] segnet_latest.msgpack ({os.path.getsize(latest)} bytes) "
        f"reloaded in {load_s:.3f} s: parameters, BN statistics, Adam "
        f"moments and step ({fresh.step}) equal to the trained state bit "
        f"for bit; epoch {epoch}, best {best:.4f}")
    result.update(train_epochs=records, latest_bytes=os.path.getsize(latest),
                  latest_load_s=load_s)

    # 3. segment each object's test frames into segnet_results/
    ckpt = os.path.join(seg_out, "segnet_best.msgpack")
    t0 = time.perf_counter()
    for obj in LM_OBJECTS:
        base = os.path.join(root, "data", f"{obj:02d}")
        segment.main([
            "--checkpoint", ckpt, "--images",
            os.path.join(base, "rgb", "*.png"), "--list",
            os.path.join(base, "test.txt"), "--out_dir",
            os.path.join(root, "segnet_results", f"{obj:02d}_label"),
            "--num_classes", str(num_classes), "--binary_class", str(obj),
            "--class_vs_bg", "--batch_size", "4"])
    torch.cuda.synchronize()
    segment_s = time.perf_counter() - t0
    masks = _mask_stats(root, LM_OBJECTS)
    per_obj = {o: (m["nonempty"], m["frames"], round(m["iou"], 4))
               for o, m in masks.items()}
    log(f"[4k] segment ({sum(m['frames'] for m in masks.values())} test "
        f"frames, --class_vs_bg) in {segment_s:.2f} s: (non-empty masks, "
        f"frames, IoU against the ground truth) per object {per_obj}")

    # 4. LineMOD eval mode on SegNet's masks
    eval_kernels = {k: kernels[k] for k in ("adds_remap", "phase_conv")}
    for k in eval_kernels.values():
        k.launches = 0
    eval_dir = os.path.join(out, "eval")
    t0 = time.perf_counter()
    with counted_forwards() as fw:
        eval_linemod.main([
            "--dataset_root", root, "--checkpoint", lm_ck, "--objlist",
            *[str(o) for o in LM_OBJECTS], "--mode", "eval", "--output_dir",
            eval_dir, "--native_crops", "off"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in eval_kernels.items()}
    with open(os.path.join(eval_dir, "result.json")) as f:
        res = json.load(f)
    rates = [res["rate_per_pixel"], res["rate_refined"]] + [
        o[key] for o in res["per_object"]
        for key in ("rate_per_pixel", "rate_refined")
        if o[key] is not None]
    frames = sum(m["frames"] for m in masks.values())
    valid = sum(o["count"] for o in res["per_object"])
    if not (all(0.0 <= r <= 1.0 for r in rates)
            and valid + res["lost_detections"] == frames
            and fw["n"] > 0 and launches["phase_conv"] == 3 * fw["n"]
            and launches["adds_remap"] > 0):
        raise AssertionError(f"[4k] eval_linemod --mode eval: {res}, "
                             f"{fw['n']} forwards, launches {launches}")
    log(f"[4k] eval_linemod --mode eval on SegNet's masks ({frames} frames, "
        f"{valid} with a mask, {res['lost_detections']} lost, --iterations "
        f"{res['iterations']}): per-pixel {res['rate_per_pixel']:.4f}, "
        f"refined {res['rate_refined']:.4f}, {eval_s:.2f} s, {fw['n']} "
        f"PoseNet forwards, launches {launches}; card {card}")
    result.update(segment_s=segment_s, masks=masks, eval={
        "seconds": eval_s, "forwards": fw["n"], "launches": launches,
        "valid": valid, "lost": res["lost_detections"],
        "rate_per_pixel": res["rate_per_pixel"],
        "rate_refined": res["rate_refined"]})

    # 5. bench_seg beside its FLOP bound
    bench = bench_seg(batch=SEG_BENCH[0], height=SEG_BENCH[1],
                      width=SEG_BENCH[2], num_classes=SEG_BENCH[3])
    flops = segnet_forward_flops(SegNet(SEG_BENCH[3]), *SEG_BENCH[1:3])
    infer_bound = SEG_BENCH[0] * flops / PEAK_FP32_FLOPS * 1e3
    train_bound = 3 * infer_bound
    bench.update(forward_gflop_per_frame=flops / 1e9,
                 infer_bound_ms=infer_bound, train_bound_ms=train_bound)
    log(f"[4k] bench_seg B={SEG_BENCH[0]} {SEG_BENCH[1]}x{SEG_BENCH[2]} "
        f"{SEG_BENCH[3]} classes f32: train "
        f"{bench['seg_train_ms_per_step']:.3f} ms per step "
        f"({bench['seg_train_frames_per_s']:.2f} frames/s), bound "
        f"{train_bound:.2f} ms (3x forward, "
        f"{bench['seg_train_ms_per_step'] / train_bound:.2f}x it); "
        f"inference {bench['seg_infer_ms_per_batch']:.3f} ms per batch "
        f"({bench['seg_infer_frames_per_s']:.2f} frames/s), bound "
        f"{infer_bound:.2f} ms "
        f"({bench['seg_infer_ms_per_batch'] / infer_bound:.2f}x it); forward "
        f"{flops / 1e9:.1f} GFLOP per frame at the fp32 peak "
        f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s; card {card}")
    result["bench_seg"] = bench

    # 6. the FAT tools on a generated scene
    scene = os.path.join(out, "fat_scene")
    t0 = time.perf_counter()
    model = generate_fat_style_scene(scene, n_frames=FAT_FRAMES, seed=SEED)
    model_ply = os.path.join(out, "fat_model.ply")
    write_ply(model_ply, model)
    rows = fat.verify_scene(scene, model)
    failures = verify_fat.main(["--scene", scene, "--model", model_ply])
    recon = os.path.join(out, "fat_recon")
    reconstruct_fat.main(["--scene", scene, "--model", model_ply,
                          "--out_dir", recon])
    fat_s = time.perf_counter() - t0
    plys = sorted(os.listdir(recon))
    if not (failures == 0 and len(rows) == FAT_FRAMES
            and all(r["status"] == "ok" and r["mean_nn_dist_m"] < 0.01
                    for r in rows)
            and plys == ["identity.ply", "projected.ply", "target.ply"]):
        raise AssertionError(f"[4k] FAT tools: {rows}, {failures} failures, "
                             f"{plys}")
    log(f"[4k] verify_fat ({FAT_FRAMES} frames): mean NN distance "
        f"{[round(1e3 * r['mean_nn_dist_m'], 3) for r in rows]} mm, all ok; "
        f"reconstruct_fat wrote {plys}; {fat_s:.2f} s with the scene")
    result["fat"] = {"mean_nn_mm": [1e3 * r["mean_nn_dist_m"] for r in rows],
                     "seconds": fat_s}
    return result


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference of two bf16 tensors in units of one bf16 ulp
    (2^-7 of the element's binade) of ``want``'s element, an element's
    magnitude counted at no less than 2^-10 of ``want``'s largest: below
    that, float32 sums taken in another order (~1e-7 of the largest) can
    round to the neighbouring bf16 value while the element's own ulp is
    smaller than that noise."""
    g, w = got.float(), want.float()
    mag = w.abs().clamp_min(float(w.abs().max()) * 2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def check_phase_conv_bf16(phase_conv, gen, card: str) -> dict:
    """[4l] 1: kernel 6's bf16 route against its plain bf16 version (float32
    sums, one rounding) at the decoder's three shapes at B=64, B=32 and B=1
    and at ragged shapes: every element within one bf16 ulp
    (:func:`bf16_ulps`). The padded map is channels-last, the layout the
    kernel takes. At the decoder's shapes, its device time by CUDA-graph
    replay in turns with ``F.conv2d`` in bf16 on the same map (library,
    kernel, kernel, library), ``F.conv2d`` once more on the map's NCHW
    copy (the earlier bf16 kernel's layout), the plain version's time,
    and the bound at the dense bf16 peak."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    cases = [(f"{name} (B={bsz}, {hw}x{hw}, {cin} -> {cout})", bsz, hw, hw,
              cin, cout, True)
             for bsz in BF16_CONV_BATCHES
             for name, hw, cin, cout in DECODER_CONVS]
    cases += [(name, *shape, False) for name, *shape in BF16_RAGGED]
    results, worst_abs = {}, 0.0
    for name, bsz, h, w, cin, cout, timed in cases:
        xp = torch.randn((bsz, cin, h + 2, w + 2), device=dev,
                         generator=gen).to(torch.bfloat16).contiguous(
                             memory_format=torch.channels_last)
        pk = (torch.randn((3, 3, cin, cout), device=dev, generator=gen)
              / np.sqrt(9 * cin)).to(torch.bfloat16)
        got = phase_conv.phase_conv_bf16_kernel(xp, pk)
        want = phase_conv.conv3x3_valid_plain_nchw(xp, pk)
        torch.cuda.synchronize()
        ulps = bf16_ulps(got, want)
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != torch.bfloat16 or got.shape != want.shape \
                or not ulps <= 1.0:
            raise AssertionError(f"[4l] phase_conv bf16 kernel differs from "
                                 f"plain on {name}: {ulps} ulps, {err} abs")
        worst_abs = max(worst_abs, err)
        entry = {"max_ulps": ulps, "max_abs_err": err}
        if timed:
            # the OIHW weight in the map's layout, so cuDNN converts neither
            w_cl = pk.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            readings = [
                graph_ms(lambda: F.conv2d(xp, w_cl), replays=20)
                if fn == "library" else
                graph_ms(lambda: phase_conv.phase_conv_bf16_kernel(xp, pk),
                         replays=20)
                for fn in ("library", "kernel", "kernel", "library")]
            k_ms = (readings[1] + readings[2]) / 2
            l_ms = (readings[0] + readings[3]) / 2
            x_nchw, w_oihw = xp.contiguous(), pk.permute(3, 2, 0, 1) \
                .contiguous()
            ln_ms = graph_ms(lambda: F.conv2d(x_nchw, w_oihw), replays=20)
            p_ms = cuda_ms(lambda: phase_conv.conv3x3_valid_plain_nchw(
                xp, pk), iters=3, warmup=1)
            bnd, by = conv_bound_ms(bsz, h, w, cin, cout, "bf16")
            entry.update({"ms": k_ms, "library_ms": l_ms, "plain_ms": p_ms,
                          "kernel_over_library": k_ms / l_ms,
                          "library_nchw_ms": ln_ms,
                          "kernel_over_library_nchw": k_ms / ln_ms,
                          "readings_ms": {"library": readings[::3],
                                          "kernel": readings[1:3]},
                          "bound_ms": bnd, "bound_by": by,
                          "bound_arithmetic": "bf16"})
            log(f"[4l] phase_conv bf16 {name}: kernel {k_ms:.4f} ms (graph "
                f"replays), F.conv2d bf16 {l_ms:.4f} ms on the same "
                f"channels-last map (kernel / library {k_ms / l_ms:.3f}), "
                f"{ln_ms:.4f} ms on its NCHW copy ({k_ms / ln_ms:.3f}); "
                f"plain {p_ms:.4f} ms; bound {bnd:.4f} ms (bf16 at 989 "
                f"TFLOP/s, {by}), {k_ms / bnd:.2f}x it; {ulps:.0f} ulp from "
                f"plain; card {card}")
        else:
            log(f"[4l] phase_conv bf16 kernel == plain on {name}: "
                f"{ulps:.0f} ulp, max abs err {err:.3g}")
        results[name] = entry
    return {"by_shape": results, "max_abs_err": worst_abs}


def bf16_serving(states, samples, phase_conv, card: str) -> dict:
    """[4l] 2: ``estimate_batch`` and the pipeline at B=64, K=2 with bf16
    compute on the serving weights: float32 outputs; the raw PoseNet
    outputs against the card's float32 ones by the JAX package's own bf16
    criteria (``tests/test_bf16.py``: max |diff| < 0.5, correlation >
    0.98); kernel 6's bf16 route 3 launches per PoseNet forward and the
    float32 route none (counts reset before, read after); frames/s beside
    float32's, timed in turns (f32, bf16, bf16, f32)."""
    from densefusion_tpu_torch.data import collate
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.serve import PoseEstimator

    ests = {name: PoseEstimator(
        PoseNet(NUM_OBJ, dtype=dtype), PoseRefineNet(NUM_OBJ, dtype=dtype),
        *states, num_points=NUM_POINTS, crop_size=CROP,
        refine_iters=REFINE_ITERS, seed=SEED)
        for name, dtype in (("f32", None), ("bf16", torch.bfloat16))}
    kernels = {"phase_conv": phase_conv.phase_conv_kernel,
               "phase_conv_bf16": phase_conv.phase_conv_bf16_kernel}
    for k in kernels.values():
        k.launches = 0
    quat, trans, conf, valid = ests["bf16"].estimate_batch(samples)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    if launches != {"phase_conv": 0, "phase_conv_bf16": 3}:
        raise AssertionError(f"[4l] bf16 estimate_batch launches {launches}")
    if not (quat.dtype == trans.dtype == conf.dtype == np.float32
            and all(np.isfinite(v).all() for v in (quat, trans, conf))
            and np.allclose(np.linalg.norm(quat, axis=1), 1, atol=1e-4)):
        raise AssertionError("[4l] bf16 estimate_batch output")
    b = collate(samples)
    args = (torch.as_tensor(b.img, device="cuda"),
            torch.as_tensor(b.points, device="cuda"),
            torch.as_tensor(b.choose, device="cuda").long(),
            torch.as_tensor(b.obj_idx, device="cuda").long())
    raw = {}
    for name, est in ests.items():
        with torch.no_grad():
            raw[name] = {k: v.float().cpu().numpy() for k, v in
                         est.pipeline.posenet(*args).items()}
    gap = {}
    for k in ("pred_r", "pred_t", "pred_c"):
        a, c = raw["f32"][k], raw["bf16"][k]
        gap[k] = {"max_abs_diff": float(np.abs(a - c).max()),
                  "corr": float(np.corrcoef(a.ravel(), c.ravel())[0, 1]),
                  "max_abs_f32": float(np.abs(a).max())}
        if raw["bf16"][k].dtype != np.float32 or not (
                gap[k]["max_abs_diff"] < 0.5 and gap[k]["corr"] > 0.98):
            raise AssertionError(f"[4l] bf16 vs f32 {k}: {gap[k]}")
    readings = [cuda_ms(lambda: ests[name].pipeline(*args), iters=10,
                        warmup=2) for name in ("f32", "bf16", "bf16", "f32")]
    ms = {"f32": (readings[0] + readings[3]) / 2,
          "bf16": (readings[1] + readings[2]) / 2}
    fps = {k: BATCH * 1e3 / v for k, v in ms.items()}
    log(f"[4l] bf16 serving B={BATCH} K={REFINE_ITERS}: launches per "
        f"estimate_batch {launches}; raw outputs vs the card's f32 {gap}; "
        f"pipeline {ms['bf16']:.3f} ms = {fps['bf16']:.1f} frames/s against "
        f"f32 {ms['f32']:.3f} ms = {fps['f32']:.1f} frames/s (in turns); "
        f"card {card}")
    return {"launches": launches, "vs_f32": gap, "pipeline_ms": ms,
            "frames_per_s": fps, "readings_ms": readings}


def bf16_training(states, batches, phase_conv, card: str) -> dict:
    """[4l] 3-4: bf16 phase-1 (B=32, M=500) and phase-2 (B=32, M=2600, K=2)
    steps beside float32 ones on the same seeded weights: finite losses,
    float32 gradients, moved parameters, kernel 6's bf16 route 3 launches
    per step and the float32 route none; step ms of both (host clock, in
    turns). Then a float32 phase-1 step with ``remat_cnn`` against the
    plain one on the same weights and dropout seed: the gradients within
    1e-6 of the largest gradient element (read also against each tensor's
    own largest, and a second plain step's as the card's noise: its
    backward sums with atomics); peak device memory and step ms of
    both."""
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        create_train_state, make_pose_train_step, make_refine_train_step,
    )

    def state(dtype=None, remat=False):
        st = create_train_state(PoseNet(NUM_OBJ, dtype=dtype,
                                        remat_cnn=remat),
                                PoseRefineNet(NUM_OBJ, dtype=dtype), LR, SEED)
        st.posenet.load_state_dict(states[0])
        st.refiner.load_state_dict(states[1])
        return st

    kernels = {"phase_conv": phase_conv.phase_conv_kernel,
               "phase_conv_bf16": phase_conv.phase_conv_bf16_kernel}
    b1, b2 = batches
    out = {"launches": dict.fromkeys(kernels, 0)}
    sts = {"f32": state(), "bf16": state(torch.bfloat16)}
    for phase, make, batch in (
            (1, lambda st: make_pose_train_step(st, use_adds=True), b1),
            (2, lambda st: make_refine_train_step(st, REFINE_ITERS), b2)):
        steps = {k: make(st) for k, st in sts.items()}
        st = sts["bf16"]
        module = st.posenet if phase == 1 else st.refiner
        before = _snapshot(module)
        for k in kernels.values():
            k.launches = 0
        metrics = steps["bf16"](batch, W)
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in kernels.items()}
        for n, c in got.items():
            out["launches"][n] += c
        loss = float(metrics["loss"])
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        if got != {"phase_conv": 0, "phase_conv_bf16": 3} \
                or not np.isfinite(loss) or not _finite_grads(module) \
                or not all(g.dtype == torch.float32 for g in grads) \
                or not _moved(module, before):
            raise AssertionError(f"[4l] bf16 phase-{phase} step: launches "
                                 f"{got}, loss {loss}")
        readings = [step_ms(steps[k], batch)
                    for k in ("f32", "bf16", "bf16", "f32")]
        ms = {"f32": (readings[0] + readings[3]) / 2,
              "bf16": (readings[1] + readings[2]) / 2}
        out[f"phase{phase}"] = {"loss": loss, "step_ms": ms,
                                "readings_ms": readings}
        log(f"[4l] bf16 phase-{phase} step B={TRAIN_BATCH} M="
            f"{batch.target.shape[1]}: loss {loss:.6f}, launches {got}; "
            f"{ms['bf16']:.3f} ms per step against f32 {ms['f32']:.3f} ms "
            f"(in turns); card {card}")

    # remat_cnn, float32, train mode: gradients, peak memory, step time;
    # a second plain step gives the card's own step-to-step noise (cuDNN's
    # backward and the gathers' scatter-adds use atomics)
    remat = {}
    for name, flag in (("plain", False), ("remat", True),
                       ("plain again", False)):
        st = state(remat=flag)
        step = make_pose_train_step(st, use_adds=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(b1, W)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        remat[name] = {"grads": {k: p.grad.clone() for k, p in
                                 st.posenet.named_parameters()},
                       "peak_bytes": peak, "peak_over_base_bytes":
                       peak - base, "step": step}
    plain = remat["plain"]["grads"]
    largest = max(float(g.abs().max()) for g in plain.values())

    def diff(name):
        """(largest difference from the plain step over its largest
        element, the same over each tensor's own largest, worst tensor)"""
        got = remat[name]["grads"]
        return (max(float((got[k] - g).abs().max()) for k, g in plain.items())
                / largest,
                max(float((got[k] - g).abs().max())
                    / max(float(g.abs().max()), 1e-30)
                    for k, g in plain.items()))

    worst, worst_tensor = diff("remat")
    noise, noise_tensor = diff("plain again")
    if not worst <= 1e-6:
        raise AssertionError(f"[4l] remat_cnn gradients differ from the "
                             f"plain step's by {worst} of the largest "
                             f"element (a second plain step: {noise})")
    readings = [step_ms(remat[k]["step"], b1)
                for k in ("plain", "remat", "remat", "plain")]
    remat.pop("plain again")
    out["remat"] = {
        "max_grad_diff_over_largest": worst,
        "max_grad_diff_over_each_tensors_largest": worst_tensor,
        "plain_again_over_largest": noise,
        "plain_again_over_each_tensors_largest": noise_tensor,
        "peak_bytes": {k: remat[k]["peak_bytes"] for k in remat},
        "peak_over_base_bytes": {k: remat[k]["peak_over_base_bytes"]
                                 for k in remat},
        "step_ms": {"plain": (readings[0] + readings[3]) / 2,
                    "remat": (readings[1] + readings[2]) / 2},
        "readings_ms": readings}
    r = out["remat"]
    log(f"[4l] remat_cnn phase-1 step B={TRAIN_BATCH} f32 (train mode): "
        f"gradients within {worst:.3g} of the plain step's largest element "
        f"({worst_tensor:.3g} of a tensor's own largest; a second plain "
        f"step: {noise:.3g}, {noise_tensor:.3g}); peak "
        f"device memory {r['peak_bytes']['remat'] / 2**30:.3f} GiB against "
        f"{r['peak_bytes']['plain'] / 2**30:.3f} GiB plain (above the state "
        f"before the step: {r['peak_over_base_bytes']['remat'] / 2**30:.3f} "
        f"against {r['peak_over_base_bytes']['plain'] / 2**30:.3f}); "
        f"{r['step_ms']['remat']:.3f} ms per step against "
        f"{r['step_ms']['plain']:.3f} ms (in turns); card {card}")
    return out


def bf16_cli_path(phase_conv, root: str, out: str, card: str) -> dict:
    """[4l] 5-6: ``cli.train --bf16 --remat_cnn``, one epoch at the YCB
    width on the 4f root (B=16), kernel 6's bf16 route 3 launches per train
    step and the float32 route none; ``bench_latency`` with bf16 compute
    on the card; then a resnet50 PoseNet forward at B=8, float32, at the
    YCB width: kernel 6 three launches, finite outputs."""
    from densefusion_tpu_torch.cli import train as train_cli
    from densefusion_tpu_torch.cli.benchmark import bench_latency
    from densefusion_tpu_torch.data import collate
    from densefusion_tpu_torch.models import PoseNet
    from densefusion_tpu_torch.models.init import init_posenet_

    kernels = {"phase_conv": phase_conv.phase_conv_kernel,
               "phase_conv_bf16": phase_conv.phase_conv_bf16_kernel}
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    trainer = train_cli.main([
        "--dataset", "ycb", "--dataset_root", root, "--batch_size",
        str(CLI_BATCH), "--workers", str(DATA_WORKERS), "--nepoch", "1",
        "--bf16", "--remat_cnn", "--out_dir", out, "--log_dir",
        os.path.join(out, "logs")])
    cli_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    records = _train_metrics(os.path.join(out, "logs", "ycb"))
    if not (trainer.cfg.bf16_compute and trainer.cfg.remat_cnn
            and trainer.posenet.remat_cnn
            and trainer.posenet.feat.dtype == torch.bfloat16
            and trainer.curriculum.epoch == 2
            and launches["phase_conv"] == 0
            and launches["phase_conv_bf16"] > 0
            and launches["phase_conv_bf16"] % 3 == 0
            and all(p.dtype == torch.float32
                    for p in trainer.posenet.parameters())):
        raise AssertionError(f"[4l] cli.train --bf16 --remat_cnn: launches "
                             f"{launches}, {trainer.curriculum}")
    log(f"[4l] cli.train --bf16 --remat_cnn: one epoch in {cli_s:.2f} s, "
        f"kernel launches {launches} (train steps recompute the CNN: 6 per "
        f"step, 3 per test batch); metrics {records[-1:]}; card {card}")

    for k in kernels.values():
        k.launches = 0
    latency = bench_latency(repeats=10)
    lat_launches = {n: k.launches for n, k in kernels.items()}
    if latency["dtype"] != "bfloat16" or lat_launches["phase_conv"] != 0 \
            or lat_launches["phase_conv_bf16"] != 3 * 11:
        raise AssertionError(f"[4l] bench_latency: {latency}, launches "
                             f"{lat_launches}")
    log(f"[4l] bench_latency (B=1, K=2, {latency['dtype']}): median "
        f"{latency['latency_ms_median']:.3f} ms, p90 "
        f"{latency['latency_ms_p90']:.3f} ms; launches {lat_launches}; "
        f"card {card}")

    rng = np.random.default_rng(SEED + 11)
    net = PoseNet(NUM_OBJ, cnn_variant="resnet50")
    init_posenet_(net, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        net.cnn.model.module.final[0].weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(SEED))
    net = net.cuda().eval()
    b = collate([_r50_sample(rng) for _ in range(R50_BATCH)])
    args = (torch.as_tensor(b.img, device="cuda"),
            torch.as_tensor(b.points, device="cuda"),
            torch.as_tensor(b.choose, device="cuda").long(),
            torch.as_tensor(b.obj_idx, device="cuda").long())
    for k in kernels.values():
        k.launches = 0
    with torch.no_grad():
        r50 = net(*args)
        torch.cuda.synchronize()
        r50_launches = {n: k.launches for n, k in kernels.items()}
        if r50_launches != {"phase_conv": 3, "phase_conv_bf16": 0} \
                or not all(bool(torch.isfinite(v).all())
                           for v in r50.values()):
            raise AssertionError(f"[4l] resnet50 PoseNet: launches "
                                 f"{r50_launches}")
        r50_ms = cuda_ms(lambda: net(*args), iters=5, warmup=1)
    log(f"[4l] resnet50 PoseNet forward B={R50_BATCH} f32 at the YCB width: "
        f"launches {r50_launches}, {r50_ms:.3f} ms; card {card}")
    return {"cli_seconds": cli_s, "cli_launches": launches,
            "latency": latency, "latency_launches": lat_launches,
            "resnet50_launches": r50_launches, "resnet50_ms": r50_ms}


def _r50_sample(rng):
    """One seeded YCB-width sample for the resnet50 forward."""
    from densefusion_tpu_torch.data import PoseSample

    return PoseSample(
        points=(rng.standard_normal((NUM_POINTS, 3)) * 0.05)
        .astype(np.float32),
        choose=rng.integers(0, CROP * CROP, (NUM_POINTS,)).astype(np.int32),
        img=rng.standard_normal((CROP, CROP, 3)).astype(np.float32),
        target=np.zeros((NUM_MESH, 3), np.float32),
        model_points=np.zeros((NUM_MESH, 3), np.float32),
        obj_idx=np.int32(rng.integers(0, NUM_OBJ)), sym=np.bool_(False),
        valid=np.bool_(True))


def segnet_forward_flops(net, h: int, w: int) -> float:
    """FLOPs of one SegNet forward on an ``h`` x ``w`` frame: 2 x 9 x Cin x
    Cout per output pixel of every 3x3 conv, at its stage's size (BN, ReLU,
    pooling and unpooling, a few per element, are left out)."""
    total = 0.0
    for stage, names in enumerate(net.enc_layers):
        for name in names:
            conv = getattr(net, f"conv{name}")
            total += conv.weight.numel() * 2 * (h >> stage) * (w >> stage)
    for s, names in enumerate(net.dec_layers):
        stage = len(net.dec_layers) - 1 - s
        for name in names:
            conv = getattr(net, f"conv{name}")
            total += conv.weight.numel() * 2 * (h >> stage) * (w >> stage)
    return total + net.conv11d.weight.numel() * 2 * h * w


def dp_batch(rng, b: int, m: int, world: int):
    """A numpy training batch as :func:`train_batch` makes it, with rows
    0, 4, 8, ... symmetric (on every rank's slice) and the last
    min(b / 2, b / world) rows invalid: half the rows on one rank, all on
    the last rank's slice on several."""
    from densefusion_tpu_torch.data import PoseSample

    return PoseSample(
        points=(rng.standard_normal((b, NUM_POINTS, 3)) * 0.05)
        .astype(np.float32),
        choose=rng.integers(0, CROP * CROP, (b, NUM_POINTS)).astype(np.int32),
        img=rng.standard_normal((b, CROP, CROP, 3)).astype(np.float32),
        target=(rng.standard_normal((b, m, 3)) * 0.05).astype(np.float32),
        model_points=(rng.standard_normal((b, m, 3)) * 0.05)
        .astype(np.float32),
        obj_idx=rng.integers(0, NUM_OBJ, (b,)).astype(np.int32),
        sym=np.arange(b) % 4 == 0,
        valid=np.arange(b) < b - min(b // 2, b // world))


def _params(state) -> dict:
    """Both networks' tensors, by ``posenet.`` / ``refiner.`` names."""
    return {f"{name}.{k}": v for name in ("posenet", "refiner")
            for k, v in getattr(state, name).state_dict().items()}


def _rel_errs(got: dict, want: dict, absolute: bool = False
              ) -> tuple[float, int]:
    """The largest max|got - want| / max|want| over the tensors (or the
    largest max|got - want|), and the number of elements that differ at
    all."""
    worst, n = 0.0, 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        scale = 1.0 if absolute else max(float(w.abs().max()), 1e-30)
        worst = max(worst, float(d.max()) / scale)
        n += int((d > 0).sum())
    return worst, n


def _same_state_steps(state, batches, shard, kernels, dev) -> dict:
    """Each phase's ``DP_STEPS`` steps, each taken three times from the
    same state (parameters, Adam's moments, the dropout generator set back
    before each): the one-device step on the whole batch, the same step
    again (the card's own run-to-run spread), and the data-parallel step
    on this rank's rows; the run goes on from the data-parallel step.
    -> ``rows``: per step, for the data-parallel step and for the repeat
    against the first one-device step, the relative differences of the
    loss and ``dis``, the largest of the trained module's gradients and of
    the parameters (each over its tensor's largest element), the largest
    absolute parameter difference, the elements that differ at all, and
    whether the generators agree; ``one_device`` / ``dp``: per step the
    loss, ``dis`` and the launches of ``kernels`` (reset before each step);
    ``steps`` / ``data``: per phase the one-device and data-parallel step
    functions and their batches."""
    import copy

    from densefusion_tpu_torch.data import to_device
    from densefusion_tpu_torch.train import (
        make_pose_train_step, make_refine_train_step,
    )

    out = {"rows": [], "one_device": [], "dp": [], "steps": [], "data": []}
    for phase, batch in ((1, batches[0]), (2, batches[1])):
        module = state.posenet if phase == 1 else state.refiner
        made = []
        for sharding in (None, None, shard.sharding):
            made.append((make_pose_train_step(state, True, 1, sharding)
                         if phase == 1 else make_refine_train_step(
                             state, REFINE_ITERS, 1, sharding),
                         state.optimizer))
        whole = to_device(batch, dev)
        data = (whole, whole, to_device(shard(batch), dev))
        for _ in range(DP_STEPS):
            params = {k: v.clone() for k, v in _params(state).items()}
            opt = copy.deepcopy(made[-1][1].state_dict())
            gen = state.generator.get_state()
            rec = []
            for (step, optimizer), batch_data in zip(made, data):
                for name in ("posenet", "refiner"):
                    mod = getattr(state, name)
                    mod.load_state_dict({k: params[f"{name}.{k}"]
                                         for k in mod.state_dict()})
                optimizer.load_state_dict(copy.deepcopy(opt))
                state.generator.set_state(gen)
                for k in kernels.values():
                    k.launches = 0
                m = step(batch_data, W)
                torch.cuda.synchronize()
                rec.append((float(m["loss"]), float(m["dis"]),
                            {k: p.grad.clone()
                             for k, p in module.named_parameters()},
                            {k: v.clone() for k, v in _params(state).items()},
                            state.generator.get_state(),
                            {n: k.launches for n, k in kernels.items()}))
            for name, r in (("one_device", rec[0]), ("dp", rec[2])):
                out[name].append({"phase": phase, "loss": r[0], "dis": r[1],
                                  "launches": r[5]})
            row = {"phase": phase}
            for name, other in (("dp", rec[2]), ("repeat", rec[1])):
                grad_err, grad_n = _rel_errs(other[2], rec[0][2])
                param_err, param_n = _rel_errs(other[3], rec[0][3])
                row[name] = {
                    "loss": abs(other[0] - rec[0][0]) / max(abs(rec[0][0]),
                                                            1e-30),
                    "dis": abs(other[1] - rec[0][1]) / max(abs(rec[0][1]),
                                                           1e-30),
                    "grad": grad_err, "grad_elements": grad_n,
                    "param": param_err, "param_elements": param_n,
                    "param_abs": _rel_errs(other[3], rec[0][3],
                                           absolute=True)[0],
                    "generator_equal": bool(torch.equal(other[4],
                                                        rec[0][4]))}
            out["rows"].append(row)
        out["steps"].append((made[0][0], made[2][0]))
        out["data"].append((data[0], data[2]))
    return out


def _dp_rank(rank: int, world: int, init: str) -> dict:
    """[4m] on one rank (one card): the data-parallel steps against the
    one-device steps, then mesh serving against the meshless estimator."""
    import hashlib

    from densefusion_tpu_torch import parallel
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.ops import add_dist, phase_conv
    from densefusion_tpu_torch.serve import PoseEstimator
    from densefusion_tpu_torch.train import create_train_state

    parallel.initialize_distributed(init, world, rank)
    mesh = parallel.make_mesh()
    shard = parallel.make_shard_batch_fn(mesh)
    backend = torch.distributed.get_backend()
    dev = torch.device("cuda", torch.cuda.current_device())
    kernels = {"add_dist_paired": add_dist.paired_kernel,
               "add_dist_min": add_dist.min_kernel,
               "phase_conv": phase_conv.phase_conv_kernel}
    rng = np.random.default_rng(SEED + 20)
    batches = (dp_batch(rng, TRAIN_BATCH, NUM_MESH, world),
               dp_batch(rng, TRAIN_BATCH, REFINE_MESH, world))

    state = create_train_state(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ),
                               LR, SEED, dev)
    run = _same_state_steps(state, batches, shard, kernels, dev)
    digest = hashlib.sha256()
    for v in _params(state).values():
        digest.update(v.detach().cpu().contiguous().numpy().tobytes())
    # the steps' host-clock ms, in turns: one device, dp, dp, one device
    step_turns = {}
    for phase, steps, data in zip((1, 2), run.pop("steps"), run.pop("data")):
        readings = [step_ms(steps[j], data[j]) for j in (0, 1, 1, 0)]
        step_turns[phase] = {"one_device_ms": readings[::3],
                             "dp_ms": readings[1:3]}
    del state

    # serving: the mesh estimator against the meshless one, same weights
    est_rng = np.random.default_rng(SEED + 21)
    single, states = seeded_estimator(est_rng)
    on_mesh = PoseEstimator(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ), *states,
                            num_points=NUM_POINTS, crop_size=CROP,
                            refine_iters=REFINE_ITERS, seed=SEED, mesh=mesh)
    frames = [make_frame(est_rng) for _ in range(16)]
    samples = batch_samples(single, frames, DP_SAMPLES)
    want = single.estimate_batch(samples)
    kernels["phase_conv"].launches = 0
    with counted_forwards() as fw:
        got_poses = on_mesh.estimate_batch(samples)
        torch.cuda.synchronize()
    serve_launches = kernels["phase_conv"].launches
    serve_err = {k: float(np.abs(g - w).max()) for k, g, w in
                 zip(("quat", "trans", "conf"), got_poses, want)}
    serve_ok = (got_poses[0].shape == (DP_SAMPLES, 4)
                and np.array_equal(got_poses[3], want[3])
                and all(np.allclose(g, w, rtol=1e-4, atol=1e-5)
                        for g, w in zip(got_poses[:3], want[:3])))
    serve_turns = {"meshless_ms": [], "mesh_ms": []}
    for name, est in (("meshless", single), ("mesh", on_mesh),
                      ("mesh", on_mesh), ("meshless", single)):
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            est.estimate_batch(samples)
            walls.append(time.perf_counter() - t0)
        serve_turns[f"{name}_ms"].append(1e3 * float(np.median(walls)))
    return {"backend": backend, "card": dev.index, "one_device":
            run["one_device"], "dp": run["dp"], "same_state": run["rows"],
            "digest": digest.hexdigest(),
            "step_turns": step_turns, "serve_ok": serve_ok,
            "serve_err": serve_err, "serve_forwards": fw["n"],
            "serve_launches": serve_launches, "serve_turns": serve_turns}


def dp_rank(rank: int, world: int, init: str, queue) -> None:
    """A spawned rank of [4m]: puts ``(rank, result, traceback)``."""
    import torch.distributed as dist

    try:
        queue.put((rank, _dp_rank(rank, world, init), None))
    except BaseException:   # reported to the parent, which fails the run
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_path(root: str, out: str, card: str) -> dict:
    """Phase 4m: data parallelism over every card, one process each.

    1. ``dp_rank`` on each card over NCCL: the data-parallel phase-1 (B=32,
       M=500) and phase-2 (B=32, M=2600, K=2) steps on ``make_mesh()``,
       ``DP_STEPS`` each, against the one-device steps on the whole batch
       (rows 0, 4, ... symmetric, the last rows invalid), each step from
       the same state, the run going on from the data-parallel step
       (``_same_state_steps``): the gradients within 1e-5 of each tensor's
       largest element on every rank count (the one-device step repeated,
       the card's own spread, printed beside); on one rank the loss,
       ``dis`` and every parameter within 1e-6, on several the loss and
       ``dis`` rtol 1e-5 and the parameters atol 1e-3 (the JAX DP test's).
       Each step's launches of kernels 1, 2 and 6 equal to the one-device
       step's; the step times in turns;
       ``PoseEstimator(mesh=)`` on ``DP_SAMPLES`` samples at K=2 against
       the meshless estimator (rtol 1e-4, atol 1e-5, valid flags equal),
       kernel 6 three launches a forward, frames/s in turns.
    2. ``torchrun --nproc_per_node=<cards> -m densefusion_tpu_torch.cli.
       train --data_parallel`` for one epoch on the 4f root (B=16): exit 0,
       the epoch's metrics, one ``checkpoint_current``, every rank's
       parameter digest equal, and the checkpoint resumed in a one-process
       ``Trainer`` (the same digest) and served by ``from_checkpoint``.
    3. ``cli.benchmark --what scaling``: a row per rank count up to the
       cards."""
    from densefusion_tpu_torch.cli import benchmark
    from densefusion_tpu_torch.parallel import spawn_ranks
    from densefusion_tpu_torch.serve import PoseEstimator
    from densefusion_tpu_torch.train import Trainer
    from densefusion_tpu_torch.utils.config import RunConfig

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_rank, world,
                        (f"file://{os.path.join(out, 'store')}",), DP_JOIN_S)
    ranks_s = time.perf_counter() - t0
    for rank, r in sorted(ranks.items()):
        if r["backend"] != "nccl" or r["card"] != rank:
            raise AssertionError(f"[4m] rank {rank} ran {r['backend']} on "
                                 f"card {r['card']}")
        for i, (a, b) in enumerate(zip(r["one_device"], r["dp"])):
            if a["launches"] != b["launches"] \
                    or min(b["launches"].values()) < 1:
                raise AssertionError(f"[4m] rank {rank} step {i}: launches "
                                     f"{b['launches']}, one device "
                                     f"{a['launches']}")
        # each step from the same state. On every rank count the gradients
        # within 1e-5 of each tensor's largest element: the gate that sees
        # a wrong reduction (a mean where a sum belongs, a rank's own
        # count), which Adam's near scale-invariance hides from the
        # parameters. The card's float32 backward is not bit-reproducible:
        # the one-device step repeated reads up to ~2e-6, printed beside.
        # On one rank the arithmetic is the one-device step's: loss, dis
        # and parameters within 1e-6. On several, the JAX DP test's gate:
        # loss and dis rtol 1e-5, parameters atol 1e-3.
        for i, row in enumerate(r["same_state"]):
            dp = row["dp"]
            if max(dp["loss"], dp["dis"]) > (1e-6 if world == 1 else 1e-5) \
                    or dp["grad"] > 1e-5 \
                    or (dp["param"] > 1e-6 if world == 1
                        else dp["param_abs"] > 1e-3) \
                    or not dp["generator_equal"]:
                raise AssertionError(f"[4m] rank {rank} step {i} from the "
                                     f"same state: {row}")
        if not r["serve_ok"] or r["serve_forwards"] != 1 \
                or r["serve_launches"] != 3 * r["serve_forwards"]:
            raise AssertionError(f"[4m] rank {rank} mesh serving: errors "
                                 f"{r['serve_err']}, {r['serve_forwards']} "
                                 f"forwards, {r['serve_launches']} launches")
    if len({r["digest"] for r in ranks.values()}) != 1:
        raise AssertionError("[4m] the ranks' parameters differ")
    r0 = ranks[0]
    turns = r0["step_turns"]
    for i, row in enumerate(r0["same_state"]):
        log(f"[4m] phase-{row['phase']} step {i % DP_STEPS} from the same "
            f"state, data-parallel vs one device: {row['dp']}; the "
            f"one-device step repeated: {row['repeat']}")
    log(f"[4m] {world} rank(s) on NCCL ({ranks_s:.1f} s with start-up): "
        f"data-parallel steps vs one device, B={TRAIN_BATCH} ("
        f"{TRAIN_BATCH - min(TRAIN_BATCH // 2, TRAIN_BATCH // world)} rows "
        f"valid): losses {[x['loss'] for x in r0['dp']]} vs "
        f"{[x['loss'] for x in r0['one_device']]}; "
        f"launches per step {r0['dp'][0]['launches']} "
        f"(phase 1), {r0['dp'][-1]['launches']} (phase 2), as one device; "
        f"step ms in turns (one device, dp, dp, one device): phase 1 "
        f"{turns[1]}, phase 2 {turns[2]}; card {card}")
    st = r0["serve_turns"]
    log(f"[4m] PoseEstimator(mesh=) on {DP_SAMPLES} samples, K="
        f"{REFINE_ITERS}: max diff to meshless {r0['serve_err']}; kernel 6 "
        f"{r0['serve_launches']} launches in {r0['serve_forwards']} forward; "
        f"estimate_batch ms in turns: meshless {st['meshless_ms']}, mesh "
        f"{st['mesh_ms']} = {DP_SAMPLES * 1e3 / np.mean(st['mesh_ms']):.1f} "
        f"vs {DP_SAMPLES * 1e3 / np.mean(st['meshless_ms']):.1f} frames/s; "
        f"card {card}")

    # 2. the training CLI under torchrun (python -m torch.distributed.run)
    cli_out, logs = os.path.join(out, "cli"), os.path.join(out, "logs")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={world}", "--nnodes=1", "--node_rank=0",
           "--master_addr=127.0.0.1", f"--master_port={_free_port()}",
           "-m", "densefusion_tpu_torch.cli.train", "--data_parallel",
           "--dataset", "ycb", "--dataset_root", root, "--batch_size",
           str(CLI_BATCH), "--workers", str(DATA_WORKERS), "--nepoch", "1",
           "--out_dir", cli_out, "--log_dir", logs]
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=DP_JOIN_S)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[4m] torchrun cli.train --data_parallel "
                             f"exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    digests = sorted(ln.split()[-1] for ln in proc.stdout.splitlines()
                     if "parameters sha256" in ln)
    with open(os.path.join(logs, "ycb", "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    currents = sorted(str(p) for p in Path(cli_out).rglob(
        "checkpoint_current"))
    if len(digests) != world or len(set(digests)) != 1 \
            or [r["kind"] for r in records] != ["train_epoch", "test_epoch"] \
            or len(currents) != 1:
        raise AssertionError(f"[4m] torchrun run: digests {digests}, "
                             f"metrics {records}, checkpoints {currents}")
    cfg = RunConfig.preset("ycb", dataset_root=root, batch_size=CLI_BATCH,
                           num_workers=DATA_WORKERS,
                           out_dir=os.path.join(out, "resume"),
                           log_dir=os.path.join(out, "resume_logs"))
    resumed = Trainer(cfg)
    try:
        resumed.setup(resume=currents[0])
    finally:
        resumed.close()
    est = PoseEstimator.from_checkpoint(currents[0], num_obj=NUM_OBJ,
                                        num_points=NUM_POINTS)
    frames = [make_frame(np.random.default_rng(SEED + 22)) for _ in range(2)]
    poses = est.estimate_batch(batch_samples(est, frames, 4))
    if resumed.param_digest() != digests[0] \
            or resumed.curriculum.epoch != 2 \
            or not all(np.isfinite(x).all() for x in poses[:3]):
        raise AssertionError("[4m] the torchrun checkpoint does not resume "
                             "or serve")
    log(f"[4m] torchrun --nproc_per_node={world} cli.train --data_parallel: "
        f"one epoch (B={CLI_BATCH}) in {cli_s:.1f} s with start-up, exit 0, "
        f"metrics {[(r['kind'], round(r['avg_dis'], 6)) for r in records]}, "
        f"one checkpoint_current, {world} rank digest(s) equal, resumed in "
        f"one process (same digest) and served by from_checkpoint")

    # 3. the scaling benchmark
    t0 = time.perf_counter()
    scaling = benchmark.main(["--what", "scaling"])
    scaling_s = time.perf_counter() - t0
    rows = {k: v for k, v in scaling.items() if k.startswith("scaling_")}
    if set(rows) != {f"scaling_{n}dev_{k}" for n in (1, 2, 4, 8, 16, 32)
                     if n <= world for k in ("fps", "efficiency")} \
            or not all(np.isfinite(v) and v > 0 for v in rows.values()):
        raise AssertionError(f"[4m] bench_scaling: {scaling}")
    log(f"[4m] cli.benchmark --what scaling saw {world} card(s): {rows} "
        f"({scaling_s:.1f} s)" + ("; one card: no scaling claimed, the "
                                  "efficiency of 1 is the definition"
                                  if world == 1 else "") + f"; card {card}")
    return {"world": world, "ranks": ranks, "ranks_s": ranks_s,
            "cli_s": cli_s, "cli_metrics": records, "scaling": scaling,
            "launches": {"dp_training": {
                n: sum(r["launches"][n] for r in r0["dp"])
                for n in r0["dp"][0]["launches"]},
                "mesh_serving": {"phase_conv": r0["serve_launches"]}}}


@contextlib.contextmanager
def float64_casts():
    """The port casts to float32 in a few places (heads, embedding, the
    distance op); for the float64 reference those casts keep float64."""
    keep = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = keep


def phase1(state, batch, dev, dtype, use_adds=True):
    """One phase-1 loss and gradient of a PoseNet with ``state`` in eval
    mode (dropout off) on ``dev`` in ``dtype``: (loss, {name: grad float64
    on the CPU}, R, t of row 0)."""
    from densefusion_tpu_torch.geometry import quat_normalize, quat_to_matrix
    from densefusion_tpu_torch.losses import pose_loss
    from densefusion_tpu_torch.models import PoseNet

    pose = PoseNet(NUM_OBJ)
    pose.load_state_dict(state)
    pose = pose.to(dev, dtype).eval()
    b = type(batch)(*(x.to(dev, dtype) if x.is_floating_point()
                      else x.to(dev) for x in batch))
    ctx = float64_casts() if dtype == torch.float64 else \
        contextlib.nullcontext()
    with ctx:
        out = pose(b.img, b.points, b.choose, b.obj_idx)
        lo = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"],
                       b.target, b.model_points, b.points, b.sym, W,
                       use_adds=use_adds, sample_weight=b.valid.to(dtype),
                       pred_c_logit=out["pred_c_logit"])
        lo.loss.backward()
    grads = {k: p.grad.detach().double().cpu()
             for k, p in pose.named_parameters()}
    with torch.no_grad():
        R = quat_to_matrix(quat_normalize(out["pred_r"][:1].float()))
        t = (b.points + out["pred_t"])[:1].float()
    return float(lo.loss.detach()), grads, R, t


def worst(got: dict, want: dict) -> dict:
    """The parameter with the largest max|diff| / max|grad|."""
    errs = [(float((got[k] - want[k]).abs().max())
             / float(want[k].abs().max()), k)
            for k in want if float(want[k].abs().max()) > 0]
    e, k = max(errs)
    return {"max_rel_to_max": e, "param": k}


def trained_grad_reading(pose_state: dict) -> dict:
    """Phase 5c: the phase-1 gradient at B=4 with dropout off on [4g]'s
    trained PoseNet, card against CPU, and each against a float64
    reference on the CPU: a reading, not a gate (the seeded-weights gate
    of 5b stays as it is)."""
    batch = train_batch(np.random.default_rng(SEED + 3), 4, NUM_MESH, "cpu")
    ref = phase1(pose_state, batch, "cpu", torch.float64)
    card = phase1(pose_state, batch, "cuda", torch.float32)
    cpu = phase1(pose_state, batch, "cpu", torch.float32)
    return {"card_vs_cpu": worst(card[1], cpu[1]),
            "card_vs_f64": worst(card[1], ref[1]),
            "cpu_vs_f64": worst(cpu[1], ref[1]),
            "loss_rel_card_vs_cpu": abs(card[0] - cpu[0]) / abs(cpu[0])}


def train_cpu_agreement(states, rng) -> dict:
    """Phase 5b: one phase-1 loss and gradient (PoseNet in eval mode, so
    dropout off; ADD-S on one row) and one phase-2 step
    (``make_refine_train_step``, K=2) at B=4, on the serving phase's weights
    on the card and on the CPU, TF32 off. Losses agree to rel 1e-4; every
    parameter's gradient to ``max|diff| <= 1e-3 * max|grad|``."""
    from densefusion_tpu_torch.losses import pose_loss
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import (
        TrainState, make_optimizer, make_refine_train_step,
    )

    batches = (train_batch(rng, 4, NUM_MESH, "cpu"),
               train_batch(rng, 4, REFINE_MESH, "cpu"))
    res = {}
    for dev in ("cuda", "cpu"):
        pose, ref = PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ)
        pose.load_state_dict(states[0])
        ref.load_state_dict(states[1])
        pose, ref = pose.to(dev).eval(), ref.to(dev)
        b1, b2 = (type(b)(*(x.to(dev) for x in b)) for b in batches)
        out = pose(b1.img, b1.points, b1.choose, b1.obj_idx)
        l1 = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"],
                       b1.target, b1.model_points, b1.points, b1.sym, W,
                       sample_weight=b1.valid.float(),
                       pred_c_logit=out["pred_c_logit"])
        l1.loss.backward()
        state = TrainState(step=0, posenet=pose, refiner=ref,
                           optimizer=make_optimizer(pose.parameters(), LR),
                           generator=torch.Generator(device=dev))
        metrics = make_refine_train_step(state, REFINE_ITERS)(b2, W)
        res[dev] = (float(l1.loss.detach()), float(metrics["loss"]),
                    {k: p.grad.cpu() for k, p in pose.named_parameters()},
                    {k: p.grad.cpu() for k, p in ref.named_parameters()})
    (g1, g2, gpose, gref), (c1, c2, cpose, cref) = res["cuda"], res["cpu"]
    err = {"phase1_loss_rel": abs(g1 - c1) / abs(c1),
           "phase2_loss_rel": abs(g2 - c2) / abs(c2)}
    if err["phase1_loss_rel"] > 1e-4 or err["phase2_loss_rel"] > 1e-4:
        raise AssertionError(f"losses differ card vs CPU: {err}")
    for name, gg, cg in (("phase1_grad", gpose, cpose),
                         ("phase2_grad", gref, cref)):
        worst = 0.0
        for k in cg:
            scale = float(cg[k].abs().max())
            diff = float((gg[k] - cg[k]).abs().max())
            if diff > 1e-3 * scale:
                raise AssertionError(f"{name} {k} differs card vs CPU: "
                                     f"{diff} against max |grad| {scale}")
            worst = max(worst, diff / scale if scale else 0.0)
        err[f"{name}_max_rel_to_max"] = worst
    return err


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


# [4n]'s child: loads each artifact with the port's export module alone,
# runs it on the saved batch, reports its launches and what it imported
EXPORT_CHILD = """
import json, sys, time
import numpy as np
import torch
from densefusion_tpu_torch import export
arrays = np.load(sys.argv[1])
inputs = [arrays[k] for k in ("img", "points", "choose", "obj")]
report = {}
for name, path in zip(("f32", "bf16"), sys.argv[2:4]):
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        fn = export.load_exported(f.read())
    load_s = time.perf_counter() - t0
    kernels = export.phase_conv.KERNELS.values()
    first = []
    for _ in range(2):
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = fn(*inputs)
        torch.cuda.synchronize()
        first.append(time.perf_counter() - t0)
    report[name] = {"load_s": load_s, "first_call_s": first[0],
                    "second_call_s": first[1],
                    "launches": {k.name: k.launches for k in kernels}}
    np.savez(sys.argv[4] + name + ".npz",
             *(t.float().cpu().numpy() for t in out))
from densefusion_tpu_torch.device import precision_policy
report["policy"] = precision_policy()
report["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "densefusion_tpu")
    or m.startswith("densefusion_tpu_torch.models"))
print(json.dumps(report))
"""


# [4n]'s reference: the live pipeline (PoseEstimator.from_checkpoint) on the
# same batch, in a fresh process of its own, as the artifact's child is
LIVE_CHILD = """
import sys
import numpy as np
from densefusion_tpu_torch.serve import PoseEstimator
arrays = np.load(sys.argv[1])
inputs = [arrays[k] for k in ("img", "points", "choose", "obj")]
for name in ("f32", "bf16"):
    live = PoseEstimator.from_checkpoint(
        sys.argv[2], num_obj=int(sys.argv[4]), num_points=inputs[1].shape[1],
        crop_size=inputs[0].shape[1], bf16=name == "bf16").pipeline
    np.savez(sys.argv[3] + name + ".npz",
             *(t.float().cpu().numpy() for t in live(*inputs)))
"""


def _children(*runs: tuple) -> list[str]:
    """Run each ``(code, *args)`` in a fresh interpreter with this checkout
    on its path, all at once; return their standard outputs, raise with
    the errors of one that failed."""
    root = Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable, "-c", *run], cwd=root,
                              env={**os.environ, "PYTHONPATH": str(root)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for run in runs]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"[4n] a child process failed:\n"
                                     f"{err[-4000:]}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _trace_kernels(trace_dir: str) -> tuple[int, list]:
    """(events, the hand-written kernels named) of the one trace in
    ``trace_dir``."""
    import glob

    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"[4n] trace files in {trace_dir}: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = " ".join({e.get("name", "") for e in events
                      if e.get("cat") in ("kernel", "Kernel")})
    return len(events), sorted(sym for sym in KERNEL_SYMBOLS
                               if re.search(rf"\b{sym}\b", names))


def export_path(states, samples, lm_root: str, out: str, card: str) -> dict:
    """Phase 4n: export and the remaining tools on the card (see the
    module docstring). Returns the readings; kernel 6's launches per
    artifact call are read in the child."""
    from densefusion_tpu_torch import compat, export
    from densefusion_tpu_torch.cli import benchmark
    from densefusion_tpu_torch.cli import train as train_cli
    from densefusion_tpu_torch.data import collate
    from densefusion_tpu_torch.eval.pipeline import pipeline_inputs
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.ops import phase_conv
    from densefusion_tpu_torch.serve import PoseEstimator
    from densefusion_tpu_torch.train import (
        load_state_dicts, peek_config, save_checkpoint,
    )
    from densefusion_tpu_torch.train.state import (
        Curriculum, create_train_state,
    )
    from densefusion_tpu_torch.utils.config import RunConfig

    t_phase = time.perf_counter()
    # a seeded checkpoint at the YCB width, fused decoder, trained refiner
    ck = os.path.join(out, "checkpoint_best_refine")
    state = create_train_state(PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ),
                               LR, SEED, device="cpu")
    state.posenet.load_state_dict(states[0], strict=True)
    state.refiner.load_state_dict(states[1], strict=True)
    save_checkpoint(ck, state, Curriculum(refine_started=True,
                                          decay_started=True,
                                          refine_steps=20000),
                    RunConfig.preset("ycb", num_points=NUM_POINTS,
                                     crop_size=CROP,
                                     refine_iters=REFINE_ITERS))
    del state
    b = collate(samples[:EXPORT_BATCH])
    arrays = {"img": b.img, "points": b.points,
              "choose": b.choose.astype(np.int64),
              "obj": b.obj_idx.astype(np.int64)}
    np.savez(os.path.join(out, "batch.npz"), **arrays)
    inputs = [arrays[k] for k in ("img", "points", "choose", "obj")]
    op = torch.ops.densefusion_tpu_torch.phase_conv3x3.default
    res, programs = {}, {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        t0 = time.perf_counter()
        blob = export.export_inference(ck, batch=EXPORT_BATCH,
                                       refine_iters=REFINE_ITERS, bf16=bf16)
        export_s = time.perf_counter() - t0
        path = os.path.join(out, f"posenet_b{EXPORT_BATCH}_{name}.pt2")
        with open(path, "wb") as f:
            f.write(blob)
        # the saved program, loaded back here for its graph and, below, its
        # time beside the live pipeline's
        programs[name] = torch.export.load(path)
        nodes = sum(1 for n in programs[name].graph.nodes if n.target == op)
        if nodes != 3:
            raise AssertionError(f"[4n] the {name} program holds {nodes} "
                                 "phase_conv3x3 nodes, not 3")
        res[name] = {"export_s": export_s, "mb": len(blob) / 1e6,
                     "op_nodes": nodes, "path": path,
                     "meta": export.read_meta(blob)}
        log(f"[4n] exported {name} (B={EXPORT_BATCH}, K={REFINE_ITERS}) in "
            f"{export_s:.2f} s: {len(blob) / 1e6:.1f} MB, {nodes} "
            "phase_conv3x3 nodes")

    # each artifact in a fresh process that imports only torch and the
    # export module; the live pipeline in another fresh process, beside it
    t0 = time.perf_counter()
    batch = os.path.join(out, "batch.npz")
    outs = _children(
        (EXPORT_CHILD, batch, res["f32"]["path"], res["bf16"]["path"],
         os.path.join(out, "out_")),
        (LIVE_CHILD, batch, ck, os.path.join(out, "live_"), str(NUM_OBJ)))
    child = json.loads(outs[0].strip().splitlines()[-1])
    child_s = time.perf_counter() - t0
    if child["modules"]:
        raise AssertionError(f"[4n] the child imported {child['modules']}")
    if any(child["policy"].values()):
        raise AssertionError(f"[4n] TF32 on after load: {child['policy']}")
    for name, route, other in (("f32", "phase_conv", "phase_conv_bf16"),
                               ("bf16", "phase_conv_bf16", "phase_conv")):
        launches = child[name]["launches"]
        if launches != {route: 3, other: 0}:
            raise AssertionError(f"[4n] the {name} artifact's call launched "
                                 f"{launches}, not 3 of {route}")
        got = list(np.load(os.path.join(out, f"out_{name}.npz")).values())
        want = list(np.load(os.path.join(out, f"live_{name}.npz")).values())
        diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        if not diff <= 1e-4 or not all(np.isfinite(g).all() for g in got):
            raise AssertionError(f"[4n] the {name} artifact differs from "
                                 f"from_checkpoint by {diff}")
        # a reading: the same live pipeline in this process, against the
        # fresh one
        live = PoseEstimator.from_checkpoint(
            ck, num_obj=NUM_OBJ, num_points=NUM_POINTS, crop_size=CROP,
            bf16=name == "bf16").pipeline
        here = [t.float().cpu().numpy() for t in live(*inputs)]
        spread = max(float(np.abs(h - w).max()) for h, w in zip(here, want))
        # frames/s, artifact and live pipeline in turns, inputs on the card
        module = programs.pop(name).module()
        dev_in = pipeline_inputs(*inputs, "cuda")

        def fn():
            with torch.no_grad():
                return module(*dev_in)

        runs = [cuda_ms(f, iters=20, warmup=3)
                for f in (fn, lambda: live(*dev_in), lambda: live(*dev_in),
                          fn)]
        art_ms, live_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        res[name].update({
            **child[name], "max_abs_diff": diff, "bit_identical": same,
            "live_this_process_vs_fresh": spread,
            "artifact_ms": art_ms, "live_ms": live_ms,
            "artifact_frames_per_s": EXPORT_BATCH * 1e3 / art_ms,
            "live_frames_per_s": EXPORT_BATCH * 1e3 / live_ms})
        log(f"[4n] {name} artifact in a fresh process (imports: torch, "
            f"densefusion_tpu_torch.export; no jax, no models; policy "
            f"{child['policy']}): load {child[name]['load_s']:.2f} s, first "
            f"call {child[name]['first_call_s']:.3f} s, launches per call "
            f"{launches}; against from_checkpoint in a fresh process: max "
            f"abs diff {diff:.3g}, bit-identical {same} (from_checkpoint in "
            f"this process against the fresh one, a reading: {spread:.3g}); "
            f"artifact {art_ms:.3f} ms = {EXPORT_BATCH * 1e3 / art_ms:.1f} "
            f"frames/s, live {live_ms:.3f} ms = "
            f"{EXPORT_BATCH * 1e3 / live_ms:.1f} frames/s (in turns); card "
            f"{card}")
        del fn, module, live
    res["child_s"] = child_s

    # the .pth round trip: export -> import -> served on the card
    t0 = time.perf_counter()
    pths = [os.path.join(out, f) for f in ("pose.pth", "refine.pth")]
    compat.export_torch_checkpoint(ck, *pths)
    ck2 = os.path.join(out, "imported")
    compat.import_torch_checkpoint(pths[0], ck2, num_obj=NUM_OBJ,
                                   refine_pth=pths[1], dataset="ycb",
                                   num_points=NUM_POINTS, crop_size=CROP)
    bad = [k for a, bb in zip(load_state_dicts(ck), load_state_dicts(ck2))
           for k in a if not torch.equal(a[k], bb[k])]
    if bad:
        raise AssertionError(f"[4n] .pth round trip changed {bad[:8]}")
    phase_conv.phase_conv_kernel.launches = 0
    served = PoseEstimator.from_checkpoint(
        ck2, num_obj=NUM_OBJ, num_points=NUM_POINTS, crop_size=CROP
    ).pipeline(*inputs)
    ref = seeded_estimator(None, states,
                           posenet_kw={"fused_decoder": False,
                                       "align_corners": True})[0]
    want = ref.pipeline(*inputs)
    if not all(torch.equal(g, w) for g, w in zip(served, want)) \
            or phase_conv.phase_conv_kernel.launches != 0:
        raise AssertionError("[4n] the imported checkpoint does not serve "
                             "its weights under the reference's decoder")
    res["pth_s"] = time.perf_counter() - t0
    log(f"[4n] .pth round trip (export_torch -> import_torch): parameters "
        f"exact, decoder {peek_config(ck2).decoder!r}, served on the card equal "
        f"to the same weights under the align-corners decoder; "
        f"{res['pth_s']:.2f} s")

    # traces: the KNN benchmark and one training epoch on the 4h root
    traces = {}
    t0 = time.perf_counter()
    knn_dir = os.path.join(out, "trace_knn")
    benchmark.main(["--what", "knn", "--trace_dir", knn_dir])
    traces["knn"] = _trace_kernels(knn_dir) + (time.perf_counter() - t0,)
    t0 = time.perf_counter()
    train_dir = os.path.join(out, "trace_train")
    train_cli.main([
        "--dataset", "linemod", "--dataset_root", lm_root, "--objlist",
        *(str(o) for o in LM_OBJECTS), "--nepoch", "1", "--repeat_epoch",
        "1", "--batch_size", str(LM_BATCH), "--workers", "2",
        "--worker_mode", "thread", "--out_dir", os.path.join(out, "lm"),
        "--log_dir", os.path.join(out, "lm_logs"), "--trace_dir",
        train_dir])
    traces["train"] = _trace_kernels(train_dir) + (time.perf_counter() - t0,)
    for name, what in (("knn", "cli.benchmark --what knn"),
                       ("train", "cli.train, one LineMOD epoch")):
        events, found, secs = traces[name]
        log(f"[4n] --trace_dir on {what}: {events} events in {secs:.2f} s; "
            f"hand-written kernels named in the trace: {found or 'none'}")
    res["traces"] = {k: {"events": v[0], "kernels_named": v[1],
                         "seconds": v[2]} for k, v in traces.items()}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[4n] export path {res['seconds']:.1f} s")
    for r in (res["f32"], res["bf16"]):
        r.pop("path")
    return res


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


def conv_timings(phase_conv, bsz: int, gen, card: str,
                 shapes=None) -> dict:
    """Kernel 6 at the decoder's three phase-conv shapes at batch ``bsz``
    (or at ``shapes``, ``{name: (B, Cin, Cout, h, w)}``), beside its plain
    version and the library convolution on the same padded input; the
    library and the kernel timed in turns (library, kernel, kernel,
    library), each figure the mean of its two readings."""
    import torch.nn.functional as F
    from densefusion_tpu_torch.device import precision_policy

    if shapes is None:
        shapes = {name: (bsz, cin, cout, hw, hw)
                  for name, hw, cin, cout in DECODER_CONVS}
    conv_times = {}
    for name, (bsz, cin, cout, h, w) in shapes.items():
        xp = torch.randn((bsz, cin, h + 2, w + 2), device="cuda",
                         generator=gen)
        pk = torch.randn((3, 3, cin, cout), device="cuda",
                         generator=gen) / np.sqrt(9 * cin)
        w_oihw = pk.permute(3, 2, 0, 1).contiguous()
        readings = [
            cuda_ms(lambda: F.conv2d(xp, w_oihw), iters=10, warmup=2)
            if fn == "library" else
            graph_ms(lambda: phase_conv.phase_conv_kernel(xp, pk),
                     replays=20)
            for fn in ("library", "kernel", "kernel", "library")]
        k_ms = (readings[1] + readings[2]) / 2
        l_ms = (readings[0] + readings[3]) / 2
        p_ms = cuda_ms(lambda: phase_conv.conv3x3_valid_plain_nchw(xp, pk),
                       iters=3, warmup=1)
        got = phase_conv.phase_conv_kernel(xp, pk)
        plain = phase_conv.conv3x3_valid_plain_nchw(xp, pk)
        rel_plain = float((got - plain).abs().max() / plain.abs().max())
        lib = F.conv2d(xp, w_oihw)
        rel_lib = float((got - lib).abs().max() / lib.abs().max())
        bnd, by = conv_bound_ms(bsz, h, w, cin, cout)
        ffma, _ = conv_bound_ms(bsz, h, w, cin, cout, "ffma")
        conv_times[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                            "kernel_over_library": k_ms / l_ms,
                            "readings_ms": {"library": readings[::3],
                                            "kernel": readings[1:3]},
                            "bound_ms": bnd, "bound_by": by,
                            "bound_arithmetic": "3xtf32",
                            "bound_ffma_ms": ffma,
                            "rel_err_vs_plain": rel_plain,
                            "rel_diff_vs_library": rel_lib}
        log(f"[6] phase_conv {name} (B={bsz}, {h}x{w}, {cin} -> {cout}): "
            f"kernel {k_ms:.4f} ms (graph replays), F.conv2d {l_ms:.4f} ms "
            f"({precision_policy()}), kernel / library {k_ms / l_ms:.3f}; "
            f"plain {p_ms:.4f} ms; bound {bnd:.4f} ms (3xTF32, {by}), "
            f"{k_ms / bnd:.2f}x it; FFMA bound {ffma:.4f} ms; kernel vs "
            f"plain {rel_plain:.3g}, vs F.conv2d {rel_lib:.3g} of the "
            f"largest; card {card}")
    return conv_times


def remap_bound_ms(bsz, nq, nr, active_rows) -> tuple[float, str]:
    """Least time for the remap's work on these inputs: ~8 fp32 operations
    per (query, ref) pair of an active row plus 5 per ref for ||r||^2,
    against each input read and each output written once."""
    ops = active_rows * (8 * nq * nr + 5 * nr)
    nbytes = 4 * (3 * bsz * nq + 3 * bsz * nr + 4 * bsz * nq)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def nn_bound_ms(bsz, nq, nr) -> tuple[float, str]:
    """Least time for a 1-NN search's work (kernel 3 with B=1, kernel 4
    batched): ~8 fp32 operations per (query, ref) pair, 5 per ref for
    ||r||^2 and 6 per query for ||q||^2 and its add; queries and refs read
    once, a float32 distance and an int64 index written per query."""
    ops = bsz * (8 * nq * nr + 5 * nr + 6 * nq)
    nbytes = bsz * (12 * nq + 12 * nr + 12 * nq)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def add_dist_bound_ms(bsz, n, m, active_rows,
                      nearest: bool) -> tuple[float, str]:
    """Least time for one distance kernel's work on these inputs: ~60 fp32
    operations per (hypothesis, model point) pair of an active row, plus
    for ADD-S ~8 per (hypothesis, model point, target) triple and 5 per
    target for ||r||^2; against R, t, model, target and act read once and
    the (B, N, 13) result written once."""
    ops = active_rows * n * m * 60
    if nearest:
        ops += active_rows * (n * m * m * 8 + 5 * m)
    nbytes = 4 * (bsz * n * 12 + 2 * bsz * m * 3 + bsz + bsz * n * 13)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def conv_bound_ms(bsz, h, w, cin, cout,
                  arithmetic: str = "3xtf32") -> tuple[float, str]:
    """Least time for kernel 6's work: a 3x3 VALID conv of a (B, Cin, h+2,
    w+2) padded map to float32 accuracy (the port's precision policy), 2
    operations per multiply-add over the h x w outputs (not the phantom
    columns); the padded input, the weights and the (B, Cout, h, w) output
    moved once. ``arithmetic`` is the route's: "3xtf32", the kernel's three
    TF32 tensor-core products per product at ``PEAK_TF32_FLOPS``, "ffma",
    one float32 FMA outside the tensor cores at ``PEAK_FP32_FLOPS``, or
    "bf16", the bf16 route's one bf16 product at ``PEAK_BF16_FLOPS`` on
    bf16 operands (2 bytes each)."""
    ops = 2 * 9 * bsz * h * w * cin * cout
    nbytes = (2 if arithmetic == "bf16" else 4) * (
        bsz * (h + 2) * (w + 2) * cin + 9 * cin * cout + bsz * h * w * cout)
    if arithmetic == "3xtf32":
        t_ops = 3 * ops / PEAK_TF32_FLOPS
    elif arithmetic == "ffma":
        t_ops = ops / PEAK_FP32_FLOPS
    elif arithmetic == "bf16":
        t_ops = ops / PEAK_BF16_FLOPS
    else:
        raise ValueError(f"unknown arithmetic {arithmetic!r}")
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def step_ms(step, batch) -> float:
    """Host-clock mean of 5 train steps after one warm-up step, ended by a
    sync."""
    step(batch, W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(batch, W)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / 5


def check_checkout() -> None:
    """Exit (code 1) unless the port's package is importable from this
    script's own checkout: a copy of the script alone must not run."""
    root = Path(__file__).resolve().parent
    try:
        import densefusion_tpu_torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke.py must run inside a checkout of the "
                         f"repository: {e}") from None
    if Path(densefusion_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit("densefusion_tpu_torch must come from this checkout")


def run() -> None:
    check_checkout()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is "
                         "available")
    from densefusion_tpu_torch.device import precision_policy, resolve_device
    from densefusion_tpu_torch.ops import add_dist, build, knn, phase_conv

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
    # the host data-plane library builds with g++ at its first use
    from densefusion_tpu_torch import native
    fresh = not build.host_library_path().exists()
    t0 = time.perf_counter()
    native._load()
    log(f"[2] host library {build.host_library_path().name} "
        f"{'built and ' if fresh else ''}loaded at first use in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    rng = np.random.default_rng(SEED)
    resolve_device("cuda")
    log(f"[3] precision policy {precision_policy()}")
    max_err = check_kernels(knn, rng)
    max_err.update(check_add_dist(add_dist, np.random.default_rng(SEED + 1)))
    log("[3c] the 1-NN kernels against their plain versions")
    max_err.update(check_nn(knn, np.random.default_rng(SEED + 5)))
    log("[3d] kernel 6 (phase_conv) against its plain version")
    max_err["phase_conv"], conv_rel_err = check_phase_conv(
        phase_conv, np.random.default_rng(SEED + 7))

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

    # launch counts per path: {path: {kernel: launches}}; "auto" is kernel
    # 6 on the card, so the fused decoder's three phase convolutions launch it
    knn.adds_remap_kernel.launches = 0
    phase_conv.phase_conv_kernel.launches = 0
    samples, dist = main_path(est, frames, mesh)
    path_launches = {"serving": {
        "adds_remap": knn.adds_remap_kernel.launches,
        "phase_conv": phase_conv.phase_conv_kernel.launches}}
    log(f"[4] main path: 3 frames + B={BATCH} batch + pose_distances "
        f"(mean {float(dist.mean()):.4f} m); launches "
        f"{path_launches['serving']}")
    for name, n in path_launches["serving"].items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    # 4b. training path (its own launch counts, reset per step)
    train_state, (b1, b2), path_launches["training"], train_by_phase = \
        train_path(add_dist, phase_conv, np.random.default_rng(SEED + 2))
    log(f"[4b] training path: launches over all steps "
        f"{path_launches['training']}")

    # 4c. search path (its own launch counts); ends the process group
    search = search_path(knn, add_dist, np.random.default_rng(SEED + 6))
    path_launches["search"] = search["launches"]

    # 4d. decoder path with kernel 6 (its own launch count)
    decoder = decoder_path(est, samples, phase_conv)
    path_launches["decoder"] = {"phase_conv": decoder["launches"]}

    # 4e. serving under the dense and the align-corners decoders
    other_ests = other_decoders(states, samples)

    # 4f. data path: a YCB root on disk -> loader -> phase-1 steps (its own
    # launch counts, reset per step)
    data_root = tempfile.mkdtemp(prefix="chip_smoke_ycb_")
    atexit.register(shutil.rmtree, data_root, True)
    data = data_path(add_dist, phase_conv, data_root)
    path_launches["data"] = data["launches"]
    log(f"[4f] data path: launches over all steps {data['launches']}")

    # 4o. the host library on the 4f root: a fresh build, every entry point
    # against its plain version, test-mode samples against the numpy path
    host = host_plane(data_root)

    # 4g. the training CLI on the 4f root: two epochs through both gates, a
    # resume in a fresh Trainer, serving from the checkpoint (launch counts
    # reset before each epoch, read after it)
    ck_out = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, ck_out, True)
    train_kernels = {"add_dist_paired": add_dist.paired_kernel,
                     "add_dist_min": add_dist.min_kernel,
                     "phase_conv": phase_conv.phase_conv_kernel}
    cli = cli_train_path(train_kernels, data_root, ck_out, samples)
    trained_pose = cli.pop("pose_state")
    path_launches["cli_train"] = {
        n: sum(e["launches"][n] for e in cli["epochs"]) for n in train_kernels}
    log(f"[4g] training CLI: launches over its three epochs "
        f"{path_launches['cli_train']}")

    # 4h. LineMOD: one epoch of the training CLI, then the evaluation CLI
    lm_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    atexit.register(shutil.rmtree, lm_dir, True)
    lm = linemod_eval_path({**train_kernels,
                            "adds_remap": knn.adds_remap_kernel},
                           os.path.join(lm_dir, "root"),
                           os.path.join(lm_dir, "out"))
    path_launches["linemod_train"] = lm["train_epoch"]
    path_launches["linemod_eval"] = {
        n: sum(r["launches"][n] for r in lm["eval"].values())
        for n in ("adds_remap", "phase_conv")}
    log(f"[4h] LineMOD: train epoch launches {lm['train_epoch']}, "
        f"evaluation launches {path_launches['linemod_eval']}")

    # 4i. YCB keyframe evaluation of 4g's checkpoint on a root of its own
    # (launch counts and PoseNet forwards reset before each run)
    ycb_dir = tempfile.mkdtemp(prefix="chip_smoke_ycbeval_")
    atexit.register(shutil.rmtree, ycb_dir, True)
    eval_kernels = {"adds_remap": knn.adds_remap_kernel,
                    "phase_conv": phase_conv.phase_conv_kernel}
    ycb = ycb_eval_path(eval_kernels,
                        os.path.join(ck_out, "ycb", "checkpoint_best_refine"),
                        os.path.join(ycb_dir, "root"),
                        os.path.join(ycb_dir, "out"), card, phase_conv)
    path_launches["ycb_eval"] = {
        n: sum(r["launches"][n] for r in ycb["routes"].values())
        + ycb["visualize"]["launches"][n] for n in eval_kernels}
    log(f"[4i] YCB evaluation: launches over its routes and the overlays "
        f"{path_launches['ycb_eval']}")

    # 4j. CAD: two epochs of the training CLI, then the evaluation CLI
    cad_dir = tempfile.mkdtemp(prefix="chip_smoke_cad_")
    atexit.register(shutil.rmtree, cad_dir, True)
    cad = cad_path({**train_kernels, **eval_kernels},
                   os.path.join(cad_dir, "root"), os.path.join(cad_dir, "out"),
                   card)
    path_launches["cad_train"] = {
        n: sum(e["launches"][n] for e in cad["epochs"]) for n in train_kernels}
    path_launches["cad_eval"] = cad["eval"]["launches"]
    log(f"[4j] CAD: train launches over two epochs "
        f"{path_launches['cad_train']}, evaluation launches "
        f"{path_launches['cad_eval']}")

    # 4k. SegNet: card vs CPU, cli.train_seg on a copy of the 4h root,
    # cli.segment, eval_linemod --mode eval of 4h's checkpoint on SegNet's
    # masks (launch counts reset before, read after), bench_seg, FAT tools
    seg_dir = tempfile.mkdtemp(prefix="chip_smoke_seg_")
    atexit.register(shutil.rmtree, seg_dir, True)
    seg = segnet_path(eval_kernels, os.path.join(lm_dir, "root"),
                      os.path.join(lm_dir, "out", "linemod",
                                   "checkpoint_best_pose"), seg_dir, card)
    path_launches["segnet_eval"] = seg["eval"]["launches"]
    log(f"[4k] SegNet: eval_linemod --mode eval launches "
        f"{path_launches['segnet_eval']} over {seg['eval']['forwards']} "
        f"PoseNet forwards")

    # 4l. bf16 compute and the model options: kernel 6's bf16 route
    # against its plain version (and timed), bf16 serving and training
    # (their own launch counts), remat_cnn, cli.train --bf16 --remat_cnn,
    # bench_latency in bf16, a resnet50 PoseNet
    bf16_dir = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    atexit.register(shutil.rmtree, bf16_dir, True)
    log("[4l] kernel 6's bf16 route against its plain version")
    bf16_conv = check_phase_conv_bf16(
        phase_conv, torch.Generator("cuda").manual_seed(SEED + 13), card)
    max_err["phase_conv_bf16"] = bf16_conv["max_abs_err"]
    bf16_serve = bf16_serving(states, samples, phase_conv, card)
    path_launches["bf16_serving"] = bf16_serve["launches"]
    bf16_train = bf16_training(states, (b1, b2), phase_conv, card)
    path_launches["bf16_training"] = bf16_train["launches"]
    bf16_cli = bf16_cli_path(phase_conv, data_root, bf16_dir, card)
    path_launches["bf16_cli_train"] = bf16_cli["cli_launches"]
    path_launches["resnet50"] = bf16_cli["resnet50_launches"]

    # 4m. data parallelism: the DP steps on NCCL over every card against
    # the one-device steps, mesh serving, cli.train --data_parallel under
    # torchrun on the 4f root, the scaling benchmark (launch counts reset
    # before each step and the serving call, read after)
    dp_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    atexit.register(shutil.rmtree, dp_dir, True)
    dp = dp_path(data_root, dp_dir, card)
    path_launches.update(dp.pop("launches"))

    # 4n. export: f32 and bf16 artifacts at B=8, each loaded and run in a
    # fresh process whose launch counts start at 0 (read there, per call);
    # the .pth round trip; --trace_dir in the benchmark and training CLIs
    export_dir = tempfile.mkdtemp(prefix="chip_smoke_export_")
    atexit.register(shutil.rmtree, export_dir, True)
    exported = export_path(states, samples, os.path.join(lm_dir, "root"),
                           export_dir, card)
    path_launches["export_f32"] = exported["f32"]["launches"]
    path_launches["export_bf16"] = exported["bf16"]["launches"]

    # 5. card vs CPU, TF32 off
    est_cpu = seeded_estimator(None, states, device="cpu")[0]
    agree = cpu_agreement(est, est_cpu, samples)
    log(f"[5] card vs CPU (TF32 off, {precision_policy()}): {agree}")
    for name, est_d in other_ests.items():
        est_d_cpu = seeded_estimator(None, states, device="cpu",
                                     posenet_kw=OTHER_DECODERS[name])[0]
        agree[name] = cpu_agreement(est_d, est_d_cpu, samples)
        log(f"[5] card vs CPU under the {name} decoder: {agree[name]}")
    train_agree = train_cpu_agreement(states, np.random.default_rng(SEED + 3))
    log(f"[5b] training card vs CPU (B=4, dropout off, TF32 off): "
        f"{train_agree}")
    trained_grads = trained_grad_reading(trained_pose)
    log(f"[5c] phase-1 gradient on the 4g checkpoint's trained weights (B=4, "
        f"dropout off), a reading (the 5b gate is 1e-3): card vs CPU "
        f"{trained_grads['card_vs_cpu']}; against float64: card "
        f"{trained_grads['card_vs_f64']}, CPU {trained_grads['cpu_vs_f64']}")

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
    decoder_fps = {}
    for name, est_d in other_ests.items():
        d_ms = cuda_ms(lambda: est_d.pipeline(*dev_args), iters=5, warmup=1)
        decoder_fps[name] = BATCH * 1e3 / d_ms
        log(f"[6] pipeline B={BATCH} K={REFINE_ITERS} under the {name} "
            f"decoder: {d_ms:.3f} ms = {decoder_fps[name]:.1f} frames/s; "
            f"card {card}")

    pred = model + 0.001
    kernel_ms = graph_ms(lambda: knn.adds_remap_kernel(pred, target))
    wrapper_ms = cuda_ms(lambda: knn.adds_remap_kernel(pred, target),
                         iters=200)
    plain_ms = cuda_ms(lambda: knn.adds_remap_plain(pred, target), iters=50)

    def remap_reference():
        # the library's nearest coordinates are several calls (a distance
        # matrix, its argmin, a gather): a yardstick, not a library_ms
        i = torch.cdist(pred, target).argmin(-1)
        return torch.gather(target, 1, i[..., None].expand(-1, -1, 3))

    remap_ref_ms = cuda_ms(remap_reference, iters=50)
    bound_ms, bound_by = remap_bound_ms(BATCH, NUM_MESH, NUM_MESH, BATCH)
    remap_split = knn.scan_split(BATCH, NUM_MESH, NUM_MESH)
    log(f"[6] remap (64, 500, 500): kernel {kernel_ms:.4f} ms on the card "
        f"(graph replays), {wrapper_ms:.4f} ms per eager wrapper call, "
        f"plain {plain_ms:.4f} ms, torch.cdist + argmin + gather "
        f"{remap_ref_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
        f"build {build_s:.2f} s; card {card}")

    from densefusion_tpu_torch.train import (
        make_pose_train_step, make_refine_train_step,
    )
    p1_ms = step_ms(make_pose_train_step(train_state, use_adds=True), b1)
    p2_ms = step_ms(make_refine_train_step(train_state, REFINE_ITERS), b2)
    log(f"[6] phase-1 train step B={TRAIN_BATCH} M={NUM_MESH} f32: "
        f"{p1_ms:.3f} ms = {TRAIN_BATCH * 1e3 / p1_ms:.1f} samples/s; "
        f"phase-2 step B={TRAIN_BATCH} M={REFINE_MESH} K={REFINE_ITERS}: "
        f"{p2_ms:.3f} ms = {TRAIN_BATCH * 1e3 / p2_ms:.1f} samples/s; "
        f"card {card}")

    # the data plane on the 4f root: the loader alone, then loader-fed
    # phase-1 steps against the same step on one batch
    from densefusion_tpu_torch.cli.benchmark import (
        bench_loader, bench_train_e2e,
    )
    # with the host library on (the default) and off, in turns
    host_turns = []
    for on in (True, False, False, True):
        with host_library(on):
            loader_rates = bench_loader(workers=DATA_WORKERS,
                                        batch=TRAIN_BATCH,
                                        dataset_root=data_root)
            e2e = bench_train_e2e(batch=TRAIN_BATCH, steps=E2E_STEPS,
                                  workers=DATA_WORKERS,
                                  dataset_root=data_root)
        host_turns.append({"library": on, "loader": loader_rates,
                           "train_e2e": e2e})
        lib = "library on" if on else "library off (numpy)"
        log(f"[6] loader on the {NUM_OBJ}-class YCB root, {lib}, "
            f"B={TRAIN_BATCH}, {DATA_WORKERS} workers (host only): cold "
            f"{loader_rates['loader_cold_samples_per_s']:.1f}, warm "
            f"(threads) {loader_rates['loader_warm_samples_per_s']:.1f}, "
            f"ring (fork workers) "
            f"{loader_rates.get('loader_ring_samples_per_s', 0):.1f} "
            f"samples/s; cache hit rate "
            f"{loader_rates['loader_cache_hit_rate']:.3f}; card {card}")
        if e2e["dtype"] != "bfloat16":
            raise AssertionError(f"[6] bench_train_e2e ran {e2e['dtype']}")
        log(f"[6] train_e2e B={TRAIN_BATCH} M={NUM_MESH} bf16, {lib}, "
            f"{E2E_STEPS} loader-fed steps: "
            f"{e2e['train_e2e_steps_per_s']:.3f} steps/s "
            f"({e2e['train_e2e_frames_per_s']:.1f} frames/s), device-only "
            f"{e2e['train_device_only_steps_per_s']:.3f} steps/s, "
            f"input-bound fraction "
            f"{e2e['train_e2e_input_bound_fraction']:.4f}; card {card}")
    loader_rates, e2e = host_turns[0]["loader"], host_turns[0]["train_e2e"]

    # the distance kernels at the phase-1 shape (8 of 32 rows symmetric),
    # and each at the phase-2 shapes for the record
    rng_t = np.random.default_rng(SEED + 4)
    sym1 = torch.arange(TRAIN_BATCH, device="cuda") < TRAIN_SYM_ROWS
    acts = {"add_dist_paired": (~sym1).int(), "add_dist_min": sym1.int()}
    wrappers = {"add_dist_paired": (add_dist.paired_kernel,
                                    add_dist.paired_plain, False),
                "add_dist_min": (add_dist.min_kernel, add_dist.min_plain,
                                 True)}
    args1 = pose_problem(rng_t, TRAIN_BATCH, NUM_POINTS, NUM_MESH)
    dist_times = {}
    for name, (kernel, plain, nearest) in wrappers.items():
        a = acts[name]
        k_ms = graph_ms(lambda: kernel(*args1, a))
        w_ms = cuda_ms(lambda: kernel(*args1, a), iters=50)
        p_ms = cuda_ms(lambda: plain(*args1, a), iters=3, warmup=1)
        rows = int(a.sum())
        bnd, by = add_dist_bound_ms(TRAIN_BATCH, NUM_POINTS, NUM_MESH, rows,
                                    nearest)
        dist_times[name] = (k_ms, w_ms, p_ms, bnd, by)
        log(f"[6] {name} (32, N=1000, M=500, {rows} rows active): kernel "
            f"{k_ms:.4f} ms on the card (graph replays), {w_ms:.4f} ms per "
            f"eager wrapper call, plain {p_ms:.4f} ms, bound {bnd:.5f} ms "
            f"({by}); card {card}")
    ones = torch.ones(TRAIN_BATCH, dtype=torch.int32, device="cuda")
    main2 = pose_problem(rng_t, TRAIN_BATCH, NUM_POINTS, REFINE_MESH)
    ref2 = pose_problem(rng_t, TRAIN_BATCH, 1, REFINE_MESH)
    for key, label, kernel, args, a, rows, nearest in (
            ("phase2_main",
             "add_dist_paired, phase-2 main loss (32, N=1000, M=2600)",
             add_dist.paired_kernel, main2, ones, TRAIN_BATCH, False),
            ("refiner", "add_dist_paired, refiner (32, N=1, M=2600)",
             add_dist.paired_kernel, ref2, acts["add_dist_paired"],
             TRAIN_BATCH - TRAIN_SYM_ROWS, False)):
        k_ms = graph_ms(lambda: kernel(*args, a))
        bnd, by = add_dist_bound_ms(TRAIN_BATCH, args[0].shape[1],
                                    REFINE_MESH, rows, nearest)
        split = add_dist.paired_split(TRAIN_BATCH, args[0].shape[1])
        dist_times[f"add_dist_paired_{key}"] = (k_ms, bnd, by, split)
        log(f"[6] {label}, {rows} rows active: kernel {k_ms:.4f} ms (graph "
            f"replays), bound {bnd:.5f} ms ({by}), {k_ms / bnd:.2f}x it, "
            f"split {split[0]} threads x {split[1]} hypotheses; card {card}")
    # the min kernel at the refiner shape, in five graph windows (its first
    # design read ~78 or ~106 us from call to call), with the active rows
    # first (as training has them) and spread over the batch (rows 0, 4,
    # ...), which puts the active work on other SMs
    spread = (torch.arange(TRAIN_BATCH, device="cuda") % 4 == 0).int()
    ref_read = {
        where: [graph_ms(lambda: add_dist.min_kernel(*ref2, a))
                for _ in range(5)]
        for where, a in (("first rows", acts["add_dist_min"]),
                         ("spread rows", spread))}
    ref_ms = float(np.mean(ref_read["first rows"]))
    ref_bnd, ref_by = add_dist_bound_ms(TRAIN_BATCH, 1, REFINE_MESH,
                                        TRAIN_SYM_ROWS, True)
    dist_times["add_dist_min_refiner"] = (ref_ms, ref_bnd, ref_by,
                                          ref_read)
    log(f"[6] add_dist_min, refiner (32, N=1, M=2600), {TRAIN_SYM_ROWS} rows "
        f"active, split "
        f"{knn.scan_split(TRAIN_BATCH, 1, REFINE_MESH, min_kernel=True)}: "
        f"kernel {ref_ms:.4f} ms (mean of 5 graph windows: first rows "
        f"{[round(x, 5) for x in ref_read['first rows']]}, spread rows "
        f"{[round(x, 5) for x in ref_read['spread rows']]}), bound "
        f"{ref_bnd:.5f} ms ({ref_by}), {ref_ms / ref_bnd:.2f}x it; card "
        f"{card}")

    # the 1-NN kernels at the bench_knn and phase-1 ADD-S shapes
    def points(*shape):
        return torch.from_numpy(rng_t.standard_normal(shape)
                                .astype(np.float32)).cuda()

    nn_times = {}
    for name, kernel, plain, q, r in (
            ("nn", knn.nn_kernel, knn.nearest_neighbor_plain,
             points(KNN_QUERIES, 3), points(KNN_REFS, 3)),
            ("nn_batched", knn.nn_batched_kernel,
             knn.nearest_neighbor_plain_batched,
             points(TRAIN_SYM_ROWS, NUM_POINTS * NUM_MESH, 3),
             points(TRAIN_SYM_ROWS, NUM_MESH, 3))):
        k_ms = graph_ms(lambda: kernel(q, r))
        w_ms = cuda_ms(lambda: kernel(q, r), iters=50)
        p_ms = cuda_ms(lambda: plain(q, r), iters=3, warmup=1)
        # the library's nearest neighbour is two calls (and returns the
        # distance, not its square): a yardstick, not a library_ms
        ref_ms = cuda_ms(lambda: torch.cdist(q, r).min(-1), iters=5,
                         warmup=1)
        bsz = q.shape[0] if q.dim() == 3 else 1
        bnd, by = nn_bound_ms(bsz, q.shape[-2], r.shape[-2])
        nn_times[name] = (k_ms, w_ms, p_ms, bnd, by, ref_ms)
        log(f"[6] {name} {tuple(q.shape)} vs {tuple(r.shape)}: kernel "
            f"{k_ms:.4f} ms on the card (graph replays), {w_ms:.4f} ms per "
            f"eager wrapper call, plain {p_ms:.4f} ms, torch.cdist + min "
            f"{ref_ms:.4f} ms, bound {bnd:.5f} ms ({by}); card {card}")

    # the redesigned search scans (kernels 2, 3, 4): time, bound, ratio
    # and launches x (time - bound) over the driven paths
    k_p1, _, _, b_p1, _ = dist_times["add_dist_min"]
    k_ref, b_ref = dist_times["add_dist_min_refiner"][:2]
    n_p1 = train_by_phase[1]["add_dist_min"]
    n_ref = train_by_phase[2]["add_dist_min"]
    n_search = path_launches["search"]["add_dist_min"]
    excess = {"add_dist_min": (n_p1 + n_search) * (k_p1 - b_p1)
              + n_ref * (k_ref - b_ref)}
    log(f"[6] redesigned add_dist_min: phase 1 {k_p1:.4f} ms / bound "
        f"{b_p1:.4f} = {k_p1 / b_p1:.2f}x; refiner {k_ref:.4f} ms / "
        f"{b_ref:.5f} = {k_ref / b_ref:.2f}x; launches phase 1 {n_p1}, "
        f"refiner {n_ref}, search {n_search}; launches x (time - bound) "
        f"{excess['add_dist_min']:.4f} ms; card {card}")
    # the redesigned paired kernel (kernel 1): phase 1 (and the search
    # path's hypothesis-sharded distance, also at the phase-1 shape), the
    # phase-2 main loss and the refiner iterations
    k_p1, _, _, b_p1, _ = dist_times["add_dist_paired"]
    k_main, b_main = dist_times["add_dist_paired_phase2_main"][:2]
    k_pref, b_pref = dist_times["add_dist_paired_refiner"][:2]
    n_p1 = train_by_phase[1]["add_dist_paired"]
    n_p2 = train_by_phase[2]["add_dist_paired"]
    n_main = n_p2 // (1 + REFINE_ITERS)
    n_search = path_launches["search"]["add_dist_paired"]
    excess["add_dist_paired"] = ((n_p1 + n_search) * (k_p1 - b_p1)
                                 + n_main * (k_main - b_main)
                                 + (n_p2 - n_main) * (k_pref - b_pref))
    split1 = add_dist.paired_split(TRAIN_BATCH, NUM_POINTS)
    log(f"[6] redesigned add_dist_paired: phase 1 {k_p1:.4f} ms / bound "
        f"{b_p1:.5f} = {k_p1 / b_p1:.2f}x, split {split1[0]} threads x "
        f"{split1[1]} hypotheses; phase-2 main loss {k_main:.4f} ms / "
        f"{b_main:.5f} = {k_main / b_main:.2f}x; refiner {k_pref:.4f} ms / "
        f"{b_pref:.5f} = {k_pref / b_pref:.2f}x; launches phase 1 {n_p1}, "
        f"phase-2 main loss {n_main}, refiner {n_p2 - n_main}, search "
        f"{n_search}; launches x (time - bound) "
        f"{excess['add_dist_paired']:.4f} ms; card {card}")
    n = path_launches["serving"]["adds_remap"]
    excess["adds_remap"] = n * (kernel_ms - bound_ms)
    log(f"[6] redesigned adds_remap: {kernel_ms:.4f} ms / bound "
        f"{bound_ms:.5f} = {kernel_ms / bound_ms:.2f}x, split {remap_split}; "
        f"{n} launches on the serving path; launches x (time - bound) "
        f"{excess['adds_remap']:.4f} ms; torch.cdist + argmin + gather (3 "
        f"calls) {remap_ref_ms:.4f} ms; card {card}")
    for name in ("nn", "nn_batched"):
        k_ms, _, _, bnd, _, _ = nn_times[name]
        n = path_launches["search"][name]
        excess[name] = n * (k_ms - bnd)
        log(f"[6] redesigned {name}: {k_ms:.4f} ms / bound {bnd:.5f} = "
            f"{k_ms / bnd:.2f}x; {n} launches on the search path; launches "
            f"x (time - bound) {excess[name]:.4f} ms; card {card}")

    # kernel 6 at the decoder's three phase-conv shapes at the serving
    # batch, and at the training batch (B=32: the 3 launches of every train
    # and data step)
    gen = torch.Generator("cuda").manual_seed(SEED)
    conv_times = conv_timings(phase_conv, BATCH, gen, card)
    conv_times_b32 = conv_timings(phase_conv, TRAIN_BATCH, gen, card)
    # and at the CLIs' batches: the training CLI's B=16 and eval_ycb's
    # largest frame bucket, B=8
    conv_times_small = {bsz: conv_timings(phase_conv, bsz, gen, card)
                        for bsz in (CLI_BATCH, 8)}
    # and at B=1 (one 192 px crop) and the three shapes the native-crop YCB
    # evaluation ([4i]) launched most
    conv_times_b1 = conv_timings(phase_conv, 1, gen, card)
    conv_times_native = conv_timings(phase_conv, None, gen, card, shapes={
        f"native (B={b}, {h}x{w}, {cin} -> {cout}), {n} launches in [4i]":
        (b, cin, cout, h, w)
        for (b, cin, cout, h, w), n in ycb["native_conv_shapes"][:3]})
    # the train-step benchmarks at their defaults (B=8, a quarter of the
    # rows symmetric; phase 2 at M=2600, K=2)
    from densefusion_tpu_torch.cli import benchmark
    bench_steps = {what: benchmark.main(["--what", what])
                   for what in ("train", "refine")}
    log(f"[6] cli/benchmark.py --what train: "
        f"{bench_steps['train']['train_ms_per_step']:.3f} ms per step, "
        f"{bench_steps['train']['train_frames_per_s']:.1f} frames/s; "
        f"--what refine: {bench_steps['refine']['refine_ms_per_step']:.3f} "
        f"ms per step, {bench_steps['refine']['refine_frames_per_s']:.1f} "
        f"frames/s (B=8, f32, host clock, synced per step); card {card}")

    faster = all(c["ms"] <= c["library_ms"] for c in conv_times.values())
    log(f"[6] phase_conv: kernel no slower than F.conv2d at all three "
        f"shapes: {faster}; \"auto\" on the card is "
        f"{phase_conv.auto_backend(torch.device('cuda'))!r}; card {card}")

    # 7. kernels line: "launches" is the count on the kernel's own path (the
    # slice that ported it), "launches_by_path" its count on every path
    def launches(name, path):
        return {"launches": path_launches[path][name],
                "launches_by_path": {p: c[name] for p, c in
                                     path_launches.items() if name in c}}

    kernels = [{
        "name": "adds_remap", "route": "cuda",
        "source": "densefusion_tpu_torch/csrc/adds_remap.cu",
        "replaces": "densefusion_tpu/ops/knn.py:303",
        **launches("adds_remap", "serving"),
        "max_abs_err": max_err["adds_remap"],
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "library_note": "no single PyTorch call: torch.cdist(q, r)"
                        ".argmin(-1) and a gather are three, timed as "
                        "reference_ms",
        "reference_ms": remap_ref_ms, "ratio": kernel_ms / bound_ms,
        "split": remap_split, "launches_x_excess_ms": excess["adds_remap"],
        "wrapper_ms": wrapper_ms, "parity": "ok", "build_s": build_s,
    }]
    for name, line in (("add_dist_paired", 116), ("add_dist_min", 221)):
        k_ms, w_ms, p_ms, bnd, by = dist_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "densefusion_tpu_torch/csrc/add_dist.cu",
            "replaces": f"densefusion_tpu/ops/add_dist.py:{line}",
            **launches(name, "training"), "max_abs_err": max_err[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes a per-"
                            "hypothesis mean ADD(-S) distance",
            "wrapper_ms": w_ms, "parity": "ok", "build_s": build_s,
        })
        if name == "add_dist_paired":
            kernels[-1].update({"launches_x_excess_ms": excess[name]})
            for key in ("phase2_main", "refiner"):
                s_ms, s_bnd, _, split = dist_times[f"add_dist_paired_{key}"]
                kernels[-1].update({f"{key}_ms": s_ms,
                                    f"{key}_bound_ms": s_bnd,
                                    f"{key}_split": list(split)})
        if name == "add_dist_min":
            ref_ms, ref_bnd, _, ref_read = dist_times["add_dist_min_refiner"]
            kernels[-1].update({
                "refiner_ms": ref_ms, "refiner_bound_ms": ref_bnd,
                "refiner_readings_ms": ref_read,
                "launches_x_excess_ms": excess[name]})
    for name, line in (("nn", 89), ("nn_batched", 211)):
        k_ms, w_ms, p_ms, bnd, by, ref_ms = nn_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "densefusion_tpu_torch/csrc/nn.cu",
            "replaces": f"densefusion_tpu/ops/knn.py:{line}",
            **launches(name, "search"), "max_abs_err": max_err[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None,
            "library_note": "no single PyTorch call: torch.cdist(q, r)"
                            ".min(-1) is two, timed as reference_ms",
            "reference_ms": ref_ms, "wrapper_ms": w_ms, "parity": "ok",
            "build_s": build_s, "launches_x_excess_ms": excess[name],
        })
    up1 = conv_times["up1"]
    kernels.append({
        "name": "phase_conv", "route": "cuda",
        "source": "densefusion_tpu_torch/csrc/phase_conv.cu",
        "replaces": "densefusion_tpu/ops/phase_conv.py:72",
        **launches("phase_conv", "decoder"),
        "launches_by_stage": decoder["by_stage"],
        "max_abs_err": max_err["phase_conv"],
        "max_rel_err": conv_rel_err, "ms": up1["ms"],
        "plain_ms": up1["plain_ms"], "bound_ms": up1["bound_ms"],
        "bound_by": up1["bound_by"], "bound_ffma_ms": up1["bound_ffma_ms"],
        "library_ms": up1["library_ms"],
        "kernel_over_library": up1["kernel_over_library"],
        "library_note": "F.conv2d on the same padded input, VALID, TF32 off",
        "shape": "up1 (B=64, 24x24, 1024 -> 1024)", "by_shape": conv_times,
        "by_shape_b32": conv_times_b32,
        "by_shape_b16": conv_times_small[CLI_BATCH],
        "by_shape_b8": conv_times_small[8],
        "by_shape_b1": conv_times_b1,
        "by_shape_native_crops": conv_times_native,
        "parity": "ok", "build_s": build_s,
    })
    up1_bf16 = bf16_conv["by_shape"][
        f"up1 (B={BATCH}, {DECODER_CONVS[0][1]}x{DECODER_CONVS[0][1]}, "
        f"{DECODER_CONVS[0][2]} -> {DECODER_CONVS[0][3]})"]
    kernels.append({
        "name": "phase_conv_bf16", "route": "cuda",
        "source": "densefusion_tpu_torch/csrc/phase_conv_bf16.cu",
        "replaces": "densefusion_tpu/ops/phase_conv.py:72",
        **launches("phase_conv_bf16", "bf16_serving"),
        "max_abs_err": max_err["phase_conv_bf16"],
        "max_ulps": max(c["max_ulps"]
                        for c in bf16_conv["by_shape"].values()),
        "ms": up1_bf16["ms"], "plain_ms": up1_bf16["plain_ms"],
        "bound_ms": up1_bf16["bound_ms"], "bound_by": up1_bf16["bound_by"],
        "library_ms": up1_bf16["library_ms"],
        "kernel_over_library": up1_bf16["kernel_over_library"],
        "library_nchw_ms": up1_bf16["library_nchw_ms"],
        "library_note": "F.conv2d in bf16 on the same channels-last padded "
                        "input, VALID (library_nchw_ms: on its NCHW copy)",
        "shape": "up1 (B=64, 24x24, 1024 -> 1024), bf16",
        "by_shape": bf16_conv["by_shape"], "parity": "ok",
        "build_s": build_s,
    })
    summary = {"pipeline_ms_b64": pipe_ms,
               "frames_per_s_b64": BATCH * 1e3 / pipe_ms,
               "estimate_batch_ms_b64": serve_ms,
               "estimate_frame_ms_median": frame_ms,
               "train_phase1_step_ms_b32": p1_ms,
               "train_phase1_samples_per_s_b32": TRAIN_BATCH * 1e3 / p1_ms,
               "train_phase2_step_ms_b32_m2600": p2_ms,
               "data_path": {k: data[k] for k in ("losses", "sym_rows",
                                                  "max_err", "generate_s")},
               "loader": loader_rates, "train_e2e": e2e,
               "host_library": {**host, "turns": host_turns},
               "cli_train": cli, "linemod_eval": lm, "ycb_eval": ycb,
               "cad": cad, "segnet": seg,
               "bench_steps": bench_steps,
               "trained_grad_reading": trained_grads,
               "bench_knn": search["bench"],
               "frames_per_s_b64_other_decoders": decoder_fps,
               "decoder_path_rel_errors": decoder["rel_errors"],
               "serving_cpu_agreement": agree,
               "bf16_serving": bf16_serve, "bf16_training": bf16_train,
               "bf16_cli": bf16_cli, "data_parallel": dp,
               "export": exported,
               "train_cpu_agreement": train_agree, "card": card}
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
