"""How far SegNet's float32 train-step gradients are from float64, and why.

Runs on the CPU (a minute or less): the full-width SegNet of
``chip_smoke.py`` [4k] at B=2, 96x128, 22 classes, on its seeded weights
and inputs, one train step in float32 and one in float64. Prints, as JSON:

* the float32 step's distance from the float64 one (loss, gradients as
  each tensor's largest difference over its largest, BN statistics), and
  the five worst tensors;
* how many 2x2 windows pool to another position in float32 than in
  float64, per encoder stage (a near-tie decided the other way moves an
  input pixel of the decoder stage that unpools it);
* the same distance with float32 forced onto float64's pool positions, and
  the pre-ReLU values whose sign differs between the two (a ReLU gate the
  other way passes or stops one gradient element).

    python examples/segnet_grad_precision.py [out.json]
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(out_path: str | None = None) -> dict:
    import densefusion_tpu_torch.models.segnet as segnet

    cs = _chip_smoke()
    rng = np.random.default_rng(cs.SEED + 9)
    variables = cs.seeded_segnet_variables(rng)
    b, h, w = cs.SEG_CARD_SHAPE
    x = torch.from_numpy(rng.standard_normal((b, 3, h, w)).astype(
        np.float32))
    label = torch.from_numpy(rng.integers(0, cs.SEG_CLASSES, (b, h, w)))

    pool, bn_forward = segnet.max_pool_argmax, segnet.BatchNorm2d.forward
    record = {"idx": [], "pre_relu": []}

    def recording_pool(t, window=2):
        p, i = pool(t, window)
        record["idx"].append(i)
        return p, i

    def recording_bn(self, t):
        y = bn_forward(self, t)
        record["pre_relu"].append(y.detach().double())
        return y

    def step(dtype):
        for v in record.values():
            v.clear()
        out = cs._seg_step_on(variables, x, label, "cpu", dtype)
        return out, list(record["idx"]), list(record["pre_relu"])

    segnet.max_pool_argmax = recording_pool
    segnet.BatchNorm2d.forward = recording_bn
    try:
        ref, idx64, pre64 = step(torch.float64)
        f32, idx32, _ = step(torch.float32)
        forced_idx = iter(idx64)

        def forced_pool(t, window=2):
            i = next(forced_idx)
            p = t.flatten(2).gather(2, i.flatten(2)).view(i.shape)
            record["idx"].append(i)
            return p, i

        segnet.max_pool_argmax = forced_pool
        forced, _, pre32 = step(torch.float32)
    finally:
        segnet.max_pool_argmax = pool
        segnet.BatchNorm2d.forward = bn_forward

    worst = sorted(((float((f32["grads"][n] - g).abs().max()
                           / g.abs().max()), n)
                    for n, g in ref["grads"].items()
                    if not cs._pre_bn_bias(n)), reverse=True)[:5]
    result = {
        "shape": [b, h, w], "classes": cs.SEG_CLASSES,
        "f32_vs_f64": cs._seg_step_errors(f32, ref),
        "worst_gradients": worst,
        "pool_flips_per_stage": [int((p != q).sum())
                                 for p, q in zip(idx32, idx64)],
        "windows_per_stage": [int(i.numel()) for i in idx64],
        "f32_on_f64_pool_positions_vs_f64": cs._seg_step_errors(forced, ref),
        "relu_sign_flips": int(sum(((a > 0) != (c > 0)).sum()
                                   for a, c in zip(pre32, pre64))),
        "pre_relu_values": int(sum(c.numel() for c in pre64)),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
