"""Work counted from shapes: the model's FLOPs, and the least time each of
the port's kernels could take on the card (its roofline bound).

Peaks are the NVIDIA H100 SXM data sheet's dense rates at its full 700 W
power limit; each configuration file names the peak its precision is held
to. The port computes in float32 with TF32 off, and the fastest rate at
which the card multiplies float32 operands at all is the TF32 tensor-core
rate, so both the model's share of the peak and kernel 6's bound count each
product once against it: no route (FFMA, 3xTF32, anything later) can read
over 100%. The distance and search kernels are pinned to CUDA-core float32
(their scores are rounded step by step), so their bounds use the float32
peak outside the tensor cores.
"""

from __future__ import annotations

import torch

PEAK_TF32_FLOPS = 494.7e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _bound_s(ops, nbytes, peak_flops, peak_bytes=PEAK_BYTES_PER_S):
    return max(ops / peak_flops, nbytes / peak_bytes)


def conv3x3_ops(b, h, w, cin, cout):
    """Operations of a 3x3 VALID convolution with h x w outputs: 2 per
    multiply-add, each product counted once."""
    return 2 * 9 * b * h * w * cin * cout


def conv3x3_bound_s(b, h, w, cin, cout, peak_flops=PEAK_TF32_FLOPS,
                    elem_bytes=4):
    """Least seconds for kernel 6 on a (B, Cin, h+2, w+2) padded map: its
    products at ``peak_flops``, or the padded input, the (3, 3, Cin, Cout)
    weight and the (B, Cout, h, w) output each moved once."""
    nbytes = elem_bytes * (b * (h + 2) * (w + 2) * cin + 9 * cin * cout
                           + b * h * w * cout)
    return _bound_s(conv3x3_ops(b, h, w, cin, cout), nbytes, peak_flops)


def decoder_convs(crop, b, widths=(1024, 256, 64, 64)):
    """The (B, h, w, Cin, Cout) of kernel 6's three launches in one PoseNet
    forward: each upsample stage as one half-resolution convolution with
    four phase kernels (Cout = 4 x the stage's width)."""
    sizes = (crop // 8, crop // 4, crop // 2)
    return [(b, s, s, cin, 4 * cout)
            for s, cin, cout in zip(sizes, widths[:-1], widths[1:])]


def add_dist_bound_s(b, n, m, active_rows, nearest):
    """Least seconds for one launch of a distance kernel (kernel 1, paired
    ADD; kernel 2, min ADD-S): ~60 float32 operations per (hypothesis,
    model point) pair of an active row, plus for ADD-S ~8 per (hypothesis,
    model point, target) triple and 5 per target; R, t, model, target and
    the row flags read once, the (B, N, 13) result written once."""
    ops = active_rows * n * m * 60
    if nearest:
        ops += active_rows * (n * m * m * 8 + 5 * m)
    nbytes = 4 * (b * n * 12 + 2 * b * m * 3 + b + b * n * 13)
    return _bound_s(ops, nbytes, PEAK_FP32_FLOPS)


def remap_bound_s(b, nq, nr, active_rows):
    """Least seconds for the ADD-S remap (kernel 5): ~8 float32 operations
    per (query, ref) pair of an active row and 5 per ref; inputs read and
    the (B, Q, 3) points and (B, Q) indices written once."""
    ops = active_rows * (8 * nq * nr + 5 * nr)
    nbytes = 4 * (3 * b * nq + 3 * b * nr + 4 * b * nq)
    return _bound_s(ops, nbytes, PEAK_FP32_FLOPS)


def nn_bound_s(b, nq, nr):
    """Least seconds for a 1-NN search (kernels 3 and 4)."""
    ops = b * (8 * nq * nr + 5 * nr + 6 * nq)
    nbytes = b * (12 * nq + 12 * nr + 12 * nq)
    return _bound_s(ops, nbytes, PEAK_FP32_FLOPS)


def _reference_nets(cfg):
    from perfbench.reference import model as ref

    with torch.device("meta"):
        return ref.posenet(cfg), ref.refiner(cfg)


def _inputs(cfg, batch):
    n, crop = cfg["num_points"], cfg["crop_size"]
    with torch.device("meta"):
        return (torch.empty(batch, crop, crop, 3), torch.empty(batch, n, 3),
                torch.zeros(batch, n, dtype=torch.long),
                torch.zeros(batch, dtype=torch.long))


def inference_flops(cfg, batch, refine_iters):
    """FLOPs of one pose of the plain reference at the cell's shapes,
    counted by ``torch.utils.flop_counter`` on meta tensors: a PoseNet
    forward (the embedding decoded densely over the crop, as DenseFusion
    defines it) and ``refine_iters`` refiner iterations. Only the
    networks' products are counted (the scoring's are not)."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference import model as ref

    posenet, refiner = _reference_nets(cfg)
    img, points, choose, obj = _inputs(cfg, batch)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        q, t, _, emb = ref.hypotheses(posenet.eval(), img, points, choose,
                                      obj)
        ref.refine(refiner.eval(), refine_iters, q[:, 0], t[:, 0], points,
                   emb, obj)
    return counter.get_total_flops() / batch


def pose_train_flops(cfg, batch):
    """FLOPs of one sample of a phase-1 step of the plain reference at the
    cell's shapes: the PoseNet forward and backward (the loss's products
    are not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    posenet, _ = _reference_nets(cfg)
    img, points, choose, obj = _inputs(cfg, batch)
    with FlopCounterMode(display=False) as counter:
        outs = posenet.eval()(img, points, choose, obj)
        torch.autograd.backward([o.sum() for o in outs[:3]])
    return counter.get_total_flops() / batch
