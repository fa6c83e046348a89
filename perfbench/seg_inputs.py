"""What a SegNet run feeds both sides, made from ``--seed``: the network's
weights and the pool of batches, both drawn on the device. It imports
nothing of the port.

Weights are the port's initialisers (``init_segnet_``) drawn from the
run's weight stream: He-normal over fan-out for every convolution, zero
biases, BatchNorm scale 1 and shift 0, running mean 0 and variance 1.

A batch is ``rgb`` (B, 3, H, W) float32, seeded standard-normal noise,
which stands for frames in the loader's ImageNet normalisation (each
channel of a normalised frame has about unit spread), and ``label`` (B, H,
W) int64: over background class 0, 3-9 rectangles a frame of classes 1 to
``num_classes - 1``, each 8-30% of the frame's height and width, drawn in
turn so that later ones cover earlier ones, as objects occlude.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.inputs import INPUTS, WEIGHTS, stream


def segnet_weights(cfg, seed: int, device) -> dict:
    """A state_dict of the configuration's SegNet drawn on ``device``."""
    from perfbench.reference.segnet import segnet

    with torch.device("meta"):
        shapes = [(k, v.shape) for k, v in segnet(cfg).state_dict().items()]
    gen = torch.Generator(device=device).manual_seed(stream(seed, WEIGHTS))
    sd = {}
    for k, shape in shapes:
        if len(shape) == 4:
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            sd[k] = torch.randn(shape, generator=gen, device=device) * std
        elif k.startswith("bn") and k.endswith((".weight", ".running_var")):
            sd[k] = torch.ones(shape, device=device)
        else:
            sd[k] = torch.zeros(shape, device=device)
    return sd


def labels(rng, n_frames, h, w, num_classes) -> np.ndarray:
    """(n_frames, h, w) uint8 class maps: rectangles over class 0."""
    out = np.zeros((n_frames, h, w), np.uint8)
    for f in range(n_frames):
        for _ in range(rng.integers(3, 10)):
            rh = int(rng.uniform(0.08, 0.30) * h)
            rw = int(rng.uniform(0.08, 0.30) * w)
            y, x = rng.integers(0, h - rh + 1), rng.integers(0, w - rw + 1)
            out[f, y:y + rh, x:x + rw] = rng.integers(1, num_classes)
    return out


def make_pool(cfg, traffic, seed: int, device) -> list[dict]:
    """``traffic["pool"]`` batches of ``traffic["batch"]`` frames, each a
    dict of ``rgb`` and ``label`` on ``device``."""
    b, n = traffic["batch"], traffic["pool"]
    h, w = cfg["height"], cfg["width"]
    seed = stream(seed, INPUTS)
    gen = torch.Generator(device=device).manual_seed(seed)
    rgb = torch.randn(n, b, 3, h, w, generator=gen, device=device)
    lab = torch.as_tensor(labels(np.random.default_rng(seed), n * b, h, w,
                                 cfg["num_classes"]))
    lab = lab.to(device).long().view(n, b, h, w)
    return [{"rgb": rgb[i], "label": lab[i]} for i in range(n)]
