#!/usr/bin/env python3
"""How far float32 training gradients are from float64, on the card and on
the CPU: the yardstick for ``chip_smoke.py``'s card-vs-CPU gradient check.

    python3 examples/gpu_grad_precision.py [out.json]

One phase-1 loss and gradient (B=4, YCB width, dropout off) on the serving
phase's seeded weights and on the training path's weights after its phase-1
steps, as ``chip_smoke.py`` makes them. For each set of weights: the
card's and the CPU's float32 gradients against a CPU float64 reference,
and the card against the CPU, each as the largest per-parameter
``max|diff| / max|grad|`` with the parameter's name; the card-vs-CPU gap
again with ADD-S off; and how many ADD-S nearest-target choices differ
between the card and the CPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from densefusion_tpu_torch import compat  # noqa: E402
from densefusion_tpu_torch.ops import add_dist  # noqa: E402
from densefusion_tpu_torch.ops.knn import _nearest  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from densefusion_tpu_torch.device import resolve_device
    resolve_device("cuda")
    rng = np.random.default_rng(cs.SEED)
    # chip_smoke.py draws its remap cases before the serving weights
    from densefusion_tpu_torch.ops import knn
    cs.check_kernels(knn, rng)
    seeded = compat.posenet_state_dict_from_flax(
        cs.seeded_params(cs.posenet_param_shapes(cs.NUM_OBJ), rng))
    from densefusion_tpu_torch.ops import phase_conv
    state = cs.train_path(add_dist, phase_conv,
                          np.random.default_rng(cs.SEED + 2))[0]
    trained = {k: v.detach().cpu()
               for k, v in state.posenet.state_dict().items()}
    batch = cs.train_batch(np.random.default_rng(cs.SEED + 3), 4,
                           cs.NUM_MESH, "cpu")
    result = {"card": cs.card_line()}
    for name, weights in (("seeded", seeded), ("trained", trained)):
        ref = cs.phase1(weights, batch, "cpu", torch.float64)
        card = cs.phase1(weights, batch, "cuda", torch.float32)
        cpu = cs.phase1(weights, batch, "cpu", torch.float32)
        row = {"card_vs_f64": cs.worst(card[1], ref[1]),
               "cpu_vs_f64": cs.worst(cpu[1], ref[1]),
               "card_vs_cpu": cs.worst(card[1], cpu[1]),
               "loss_rel_card_vs_cpu": abs(card[0] - cpu[0]) / abs(cpu[0])}
        if name == "seeded":
            row["card_vs_cpu_adds_off"] = cs.worst(
                cs.phase1(weights, batch, "cuda", torch.float32, False)[1],
                cs.phase1(weights, batch, "cpu", torch.float32, False)[1])
            picks = []
            for _, _, R, t in (card, cpu):
                q = add_dist._transform(R.cpu(), t.cpu(),
                                        batch.model_points[:1])
                picks.append(_nearest(q.reshape(1, -1, 3),
                                      batch.target[:1])[1])
            row["adds_choices_differing"] = int((picks[0] != picks[1]).sum())
            row["adds_choices"] = int(picks[0].numel())
        result[name] = row
    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(text)


if __name__ == "__main__":
    main()
