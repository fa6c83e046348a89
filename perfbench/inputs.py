"""What a run feeds both sides, made from ``--seed``: the networks' weights
and the pool of input batches. One general generator reads the cell's
configuration and traffic file; it imports nothing of the port.

Weights are drawn on the device in one ``torch.randn`` over every parameter
and scaled per parameter in three more calls, with the port's initialiser
scales: He-normal over fan-out for the 2-D convolutions, LeCun normal
truncated at two deviations for the point layers, variance 0.01 / fan_in
for each head's last layer, the identity quaternion added to the rotation
heads' biases, PReLU slopes 0.25. Two departures, both so that the
comparison with the reference reaches every layer: biases draw N(0, 0.01)
where the port starts them at 0, and the embedding's last convolution
(``final``) draws at variance 0.01 / fan_in, as the heads' last layers
do, where the port starts it at 0 (a zero ``final`` makes the embedding one
constant, and the CNN would not reach the poses; at He-normal scale the
BN-free trunk's large activations make log-softmax values of -200 and
confidences that saturate at 1 in whole blocks of points).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated to [-2, 2]
WEIGHTS, INPUTS, DROPOUT = 1, 2, 3  # streams derived from the seed


def stream(seed: int, which: int) -> int:
    """A 63-bit seed for one of the run's random streams."""
    return int(np.random.SeedSequence([seed, which])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def _rule(name: str, shape, last_heads):
    """(std, truncation in std units, offset) of one parameter."""
    if name.endswith("conv.2.weight"):                # PReLU slope
        return 0.0, math.inf, 0.25
    if name.endswith(".bias"):
        return 0.01, math.inf, 0.0
    fan_out = shape[0] * math.prod(shape[2:])
    fan_in = shape[1] * math.prod(shape[2:])
    last = name.endswith("final.0.weight") or name.split(".")[0] in last_heads
    if len(shape) == 4 and not last:                   # 2-D convolution
        return math.sqrt(2.0 / fan_out), math.inf, 0.0
    scale = 0.01 if last else 1.0
    return math.sqrt(scale / fan_in) / _TRUNC_STD, 2.0, 0.0


def make_weights(module: torch.nn.Module, seed: int, device, last_heads):
    """A state_dict for ``module`` (built on the meta device, or anywhere)
    drawn on ``device`` from ``seed``. ``last_heads`` names the head layers
    drawn at variance 0.01 / fan_in."""
    shapes = [(k, tuple(v.shape)) for k, v in module.state_dict().items()]
    rules = [_rule(k, s, last_heads) for k, s in shapes]
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    std, lim, off = (torch.repeat_interleave(
        torch.tensor([r[i] for r in rules], device=device,
                     dtype=torch.float32), counts) for i in range(3))
    flat = torch.minimum(torch.maximum(draw, -lim), lim) * std + off
    sd = {k: part.view(s) for (k, s), part in
          zip(shapes, flat.split(sizes))}
    for k in ("conv4_r.bias", "conv3_r.bias"):
        if k in sd:
            sd[k].view(-1, 4)[:, 0] += 1.0     # identity quaternion
    return sd


POSENET_LAST = ("conv4_r", "conv4_t", "conv4_c")
REFINER_LAST = ("conv3_r", "conv3_t")


def model_weights(cfg, seed: int, device):
    """(posenet state_dict, refiner state_dict) of the configuration."""
    from perfbench.reference import model as ref

    with torch.device("meta"):
        posenet, refiner = ref.posenet(cfg), ref.refiner(cfg)
    return (make_weights(posenet, stream(seed, WEIGHTS), device,
                         POSENET_LAST),
            make_weights(refiner, stream(seed, WEIGHTS) ^ 1, device,
                         REFINER_LAST))


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]).transpose(2, 0, 1)


def symmetric_rows(cfg, traffic) -> int | None:
    """Rows of each batch given symmetric objects where the traffic's
    ``objects`` is ``symmetric_first`` (the symmetric classes' share of the
    classes, rounded); None where the objects are drawn uniformly and the
    count varies by batch."""
    if traffic["objects"] != "symmetric_first":
        return None
    return round(traffic["batch"] * len(cfg["symmetric"]) / cfg["num_obj"])


def make_pool(cfg, traffic, seed: int):
    """``traffic["pool"]`` batches of ``traffic["batch"]`` detections as
    dicts of numpy arrays (the fields of the port's ``PoseSample``): 192 px
    crops of ImageNet-normalised noise, N points sampled from each object's
    model, posed and jittered by 2 mm as a back-projected cloud, N distinct
    crop pixels in ``choose``, M model points and their posed targets.
    The traffic's ``objects`` says how each batch's objects are drawn:
    ``uniform`` over the classes, or ``symmetric_first``, symmetric objects
    in the first :func:`symmetric_rows` rows and the others after. Every
    seed gives the same sizes."""
    rng = np.random.default_rng(stream(seed, INPUTS))
    n_obj, n, m = cfg["num_obj"], cfg["num_points"], cfg["num_mesh_points"]
    crop, b = cfg["crop_size"], traffic["batch"]
    # each object a jittered ellipsoid surface, 3-10 cm semi-axes
    axes = rng.uniform(0.03, 0.10, (n_obj, 1, 3))
    d = rng.standard_normal((n_obj, m, 3))
    models = (axes * d / np.linalg.norm(d, axis=2, keepdims=True)
              ).astype(np.float32)
    sym = np.zeros(n_obj, bool)
    sym[cfg["symmetric"]] = True
    if traffic["objects"] not in ("uniform", "symmetric_first"):
        raise ValueError(f"unknown objects {traffic['objects']!r}")
    k = symmetric_rows(cfg, traffic)
    pool = []
    for _ in range(traffic["pool"]):
        if k is not None:
            obj = np.concatenate([
                rng.choice(np.flatnonzero(sym), k),
                rng.choice(np.flatnonzero(~sym), b - k)])
        else:
            obj = rng.integers(0, n_obj, b)
        R = _rotations(rng, b)
        t = np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.15, 0.15, b),
                      rng.uniform(0.5, 1.2, b)], 1)
        model = models[obj]
        target = model @ R.transpose(0, 2, 1) + t[:, None]
        pick = rng.integers(0, m, (b, n))
        points = np.take_along_axis(target, pick[..., None], 1) \
            + rng.normal(0.0, 0.002, (b, n, 3))
        choose = np.stack([np.sort(rng.choice(crop * crop, n, replace=False))
                           for _ in range(b)])
        img = rng.random((b, crop, crop, 3), dtype=np.float32) * 4.0 - 2.0
        pool.append({
            "points": points.astype(np.float32),
            "choose": choose.astype(np.int32),
            "img": img,
            "target": target.astype(np.float32),
            "model_points": model,
            "obj_idx": obj.astype(np.int32),
            "sym": sym[obj],
            "valid": np.ones(b, bool)})
    return pool
