"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Both frameworks get the same weights: every JAX parameter is drawn from a
numpy seed at a realistic scale (flax's init zeroes PSPNet's final conv and
shrinks every fc4 by 0.01, which would hide most of the network), then
carried into the port through ``densefusion_tpu_torch.compat``.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

NUM_OBJ = 3
EMB = 32

# Keep torch from oversubscribing the cores the test workers share.
torch.set_num_threads(2)


def fill_params(tree, rng: np.random.Generator, conf_scale: float = 1.0):
    """Every leaf of a flax param tree (shapes only are read) -> numpy,
    drawn from ``rng``: kernels N(0, 1/fan_in) (He-ish, so activations stay
    O(1) through the BN-free trunk), biases N(0, 0.05^2), PReLU slopes near
    0.25. ``conf_scale`` widens the confidence head's last layer so the
    argmax-confidence hypothesis has a clear margin."""
    def fill(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        shape = tuple(leaf.shape)
        if names[-1] == "slope":
            return np.asarray(0.25 + 0.05 * rng.standard_normal(),
                              np.float32).reshape(shape)
        if names[-1] == "bias":
            return (0.05 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        w = rng.standard_normal(shape) / np.sqrt(fan_in)
        if "head_c" in names and "fc4" in names:
            w = w * conf_scale
        return w.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


def init_params(model, rng: np.random.Generator, *args,
                conf_scale: float = 1.0):
    """Shapes from ``model.init`` (traced, not run), values from ``rng``."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
    return fill_params(shapes, rng, conf_scale)


def posenet_inputs(rng: np.random.Generator, b: int, crop: int, n: int):
    img = rng.standard_normal((b, crop, crop, 3)).astype(np.float32)
    pts = (0.05 * rng.standard_normal((b, n, 3))
           + np.array([0.0, 0.0, 0.6])).astype(np.float32)
    choose = rng.integers(0, crop * crop, size=(b, n)).astype(np.int32)
    obj = rng.integers(0, NUM_OBJ, size=(b,)).astype(np.int32)
    return img, pts, choose, obj


def jnp_args(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_jax_checkpoint(path: str, rng: np.random.Generator, num_obj: int,
                        n: int, crop: int, cfg, refine_steps: int = 20000):
    """A JAX-written phase-2 checkpoint at ``path`` (refine gate fired,
    ``refine_steps`` refiner steps) with weights from ``rng``: JAX's
    parameter structures from ``jax.eval_shape``, every leaf drawn,
    confidences widened so the argmax hypothesis is clear. ``cfg`` is the
    JAX ``RunConfig`` saved beside it. Returns ``(pose_params,
    refine_params)``."""
    from densefusion_tpu.models import PoseNet, PoseRefineNet
    from densefusion_tpu.train import save_checkpoint
    from densefusion_tpu.train.state import (
        Curriculum, TrainState, make_optimizer,
    )

    img = jnp.zeros((1, crop, crop, 3))
    pts = jnp.zeros((1, n, 3))
    obj = jnp.zeros((1,), jnp.int32)
    pose = init_params(PoseNet(num_obj=num_obj, **cfg.decoder_flags()), rng,
                       img, pts, jnp.zeros((1, n), jnp.int32), obj,
                       conf_scale=8.0)
    ref = init_params(PoseRefineNet(num_obj=num_obj), rng, pts,
                      jnp.zeros((1, n, EMB)), obj)
    save_checkpoint(path, TrainState(
        step=jnp.int32(30000), params_pose=pose, params_refine=ref,
        opt_state=make_optimizer(1e-4).init(ref), rng=jax.random.key(0)),
        Curriculum(refine_started=True, refine_steps=refine_steps), cfg)
    return pose, ref
