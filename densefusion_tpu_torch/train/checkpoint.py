"""Checkpoints in the JAX package's format (counterpart of
``densefusion_tpu/train/checkpoint.py``): either package reads the other's.

A checkpoint is a directory:

* ``state.msgpack``: flax's msgpack of the train state, top-level ``step``,
  ``params_pose``, ``params_refine``, ``opt_state`` and ``rng``, the
  parameters and Adam's moments in flax's layouts under flax's paths
  (:mod:`densefusion_tpu_torch.compat`), encoded by
  :mod:`densefusion_tpu_torch.train.msgpack`;
* ``curriculum.json`` and ``config.json`` (the ``RunConfig``).

It is written into ``path + ".tmp"`` and swapped in, so a crash never leaves
half a checkpoint.

``rng`` is the JAX PRNG key's data (threefry, a ``(2,)`` uint32 array):
the port writes back the key it read, or ``[0, seed]`` (the key data of
``jax.random.key(seed)``) for a state it created. The port's own dropout
generator is kept under the extra top-level key ``torch_generator`` (its
``get_state()``), which JAX's loader ignores. A checkpoint without it (one
the JAX package wrote) seeds the generator from ``rng``:
``(hi << 32 | lo) + 1``, which for a fresh key ``[0, seed]`` is
``create_train_state``'s own ``seed + 1``.

The optimizer state's structure depends on the phase (phase 2 optimizes the
refiner; ``grad_accum`` wraps Adam in ``optax.MultiSteps``), so a resume
reads the curriculum first (:func:`peek_curriculum`), builds the phase's
step (which makes its optimizer), then loads with ``restore_opt=True``.
Consumers that need only the parameters (evaluation, serving) pass
``restore_opt=False`` and load any phase.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings

import numpy as np
import torch

from densefusion_tpu_torch import compat
from densefusion_tpu_torch.train import msgpack
from densefusion_tpu_torch.train.state import Curriculum, TrainState

REFINE_MATURITY_STEPS = 10_000
"""Refine-step count below which iterative refinement is empirically risky:
the JAX package measured refinement degrading accuracy below it (a
3240-step refiner turned a 0.48 per-pixel LineMOD rate into 0.31 refined).
Consumers warn below it, they don't clamp."""


def _phase_kind(state: TrainState) -> str:
    """Which module ``state.optimizer`` steps: ``"pose"`` or ``"refine"``."""
    owned = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for kind, module in (("pose", state.posenet), ("refine", state.refiner)):
        if owned == {id(p) for p in module.parameters()}:
            return kind
    raise ValueError("the optimizer steps neither the PoseNet's nor the "
                     "refiner's parameters")


def _opt_state_tree(state: TrainState) -> dict:
    kind = _phase_kind(state)
    module = state.posenet if kind == "pose" else state.refiner
    if state.accum is None:
        return compat.adam_to_optax(state.optimizer, module, kind)
    return compat.multisteps_to_optax(state.optimizer, module, kind,
                                      state.accum)


def _state_tree(state: TrainState) -> dict:
    """The train state as the JAX package's ``TrainState`` state dict (plus
    ``torch_generator``), numpy leaves, ready for :func:`msgpack.pack`."""
    return {
        "step": np.asarray(state.step, np.int32),
        "params_pose": compat.posenet_params_from_state_dict(
            state.posenet.state_dict()),
        "params_refine": compat.refiner_params_from_state_dict(
            state.refiner.state_dict()),
        "opt_state": _opt_state_tree(state),
        "rng": np.asarray(state.rng_key, np.uint32),
        "torch_generator": state.generator.get_state().numpy(),
    }


def save_checkpoint(path: str, state: TrainState, curriculum: Curriculum,
                    config=None) -> None:
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
        f.write(msgpack.pack(_state_tree(state)))
    with open(os.path.join(tmp, "curriculum.json"), "w") as f:
        json.dump(curriculum.to_dict(), f, indent=2)
    if config is not None:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            f.write(config.to_json())
    # atomic-ish swap so a crash never leaves a half-written checkpoint
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def peek_config(path: str):
    """A checkpoint's ``RunConfig`` without touching the array state (None
    when it has no config sidecar); evaluation and serving build their
    models with its ``decoder_flags()``."""
    from densefusion_tpu_torch.utils.config import RunConfig

    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        return RunConfig.from_json(f.read())


def _read_curriculum_dict(path: str):
    """The curriculum sidecar as a dict; None when it is missing or not a
    JSON object."""
    try:
        with open(os.path.join(path, "curriculum.json")) as f:
            d = json.load(f)
    except (FileNotFoundError, ValueError, TypeError):
        return None
    return d if isinstance(d, dict) else None


def refiner_is_trained(path: str) -> bool:
    """Whether a checkpoint's refiner has ever been trained.

    Phase-1 checkpoints carry a freshly initialized refiner, and refining
    with it destroys the estimate. A checkpoint saved on the epoch the
    refine gate flipped has ``refine_started=True`` but ``refine_steps ==
    0``: still untrained. Checkpoints without a readable curriculum
    sidecar, and sidecars without the counter, are assumed trained."""
    d = _read_curriculum_dict(path)
    if d is None:
        return True
    if not d.get("refine_started", False):
        return False
    return bool(d.get("refine_steps", 1))


def refine_step_count(path: str):
    """The sidecar's refine-step counter: ``0`` when the refine phase never
    started, ``None`` when unknowable (no or unreadable sidecar, or one
    without the counter)."""
    d = _read_curriculum_dict(path)
    if d is None:
        return None
    if not d.get("refine_started", False):
        return 0
    v = d.get("refine_steps")
    return int(v) if v is not None else None


def clamp_refine_iters(path: str, iterations: int, logger=None) -> int:
    """The untrained-refiner guard of every checkpoint consumer: returns
    ``iterations`` when the checkpoint's refiner has been trained, else
    warns and returns 0. A trained but immature refiner (fewer than
    :data:`REFINE_MATURITY_STEPS` steps) warns without clamping. Warnings
    go to ``logger.warning`` when a logger is given."""
    def emit(msg):
        if logger is not None:
            logger.warning(msg)
        else:
            warnings.warn(msg)

    if iterations and not refiner_is_trained(path):
        emit(f"checkpoint {path!r} is phase-1 (curriculum refine gate "
             "never fired or no refine step has run): its bundled refiner "
             "is UNTRAINED — running 0 refinement iterations")
        return 0
    steps = refine_step_count(path)
    if iterations and steps is not None and 0 < steps < REFINE_MATURITY_STEPS:
        emit(f"checkpoint {path!r} has an IMMATURE refiner ({steps} refine "
             f"steps < {REFINE_MATURITY_STEPS}): at this maturity iterative "
             "refinement has measurably DEGRADED accuracy — compare against "
             "--iterations 0 / refine_iters=0 before trusting refined "
             "numbers")
    return iterations


def peek_curriculum(path: str) -> Curriculum:
    """A checkpoint's curriculum without touching the array state: read it
    to build the phase's optimizer before loading."""
    with open(os.path.join(path, "curriculum.json")) as f:
        return Curriculum.from_dict(json.load(f))


def _restore_generator(gen: torch.Generator, raw: dict) -> None:
    saved = raw.get("torch_generator")
    if saved is not None and saved.size == gen.get_state().numel():
        gen.set_state(torch.from_numpy(np.array(saved, np.uint8)))
        return
    if saved is not None:
        warnings.warn("the checkpoint's dropout generator state is for "
                      "another device type; seeding it from rng instead")
    hi, lo = (int(x) for x in np.asarray(raw["rng"], np.uint32))
    gen.manual_seed((hi << 32 | lo) + 1)


def load_state_dicts(path: str) -> tuple[dict, dict]:
    """A checkpoint's parameters only, as ``(posenet_state_dict,
    refiner_state_dict)`` under the reference's names: what evaluation and
    serving load, whatever the checkpoint's phase."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        raw = msgpack.unpack(f.read())
    return (compat.posenet_state_dict_from_flax(raw["params_pose"]),
            compat.refiner_state_dict_from_flax(raw["params_refine"]))


def load_models(path: str, num_obj: int, cfg):
    """``(PoseNet, PoseRefineNet)`` for ``num_obj`` objects, built with
    ``cfg.decoder_flags()`` and holding a checkpoint's parameters: what the
    evaluation CLIs run (no train state is built)."""
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet

    posenet_state, refiner_state = load_state_dicts(path)
    posenet = PoseNet(num_obj, **cfg.decoder_flags())
    refiner = PoseRefineNet(num_obj)
    posenet.load_state_dict(posenet_state, strict=True)
    refiner.load_state_dict(refiner_state, strict=True)
    return posenet, refiner


def load_checkpoint(path: str, state: TrainState, restore_opt: bool = True):
    """Restore a checkpoint into ``state`` in place -> ``(state,
    curriculum, config_json | None)``.

    Parameters, ``step``, ``rng`` and the dropout generator always restore.
    With ``restore_opt=True`` the optimizer state restores into
    ``state.optimizer`` (and ``state.accum`` under ``grad_accum``), which
    must be the checkpoint's phase: build it with :func:`peek_curriculum`
    first; a mismatch raises ``ValueError``. Moments match parameters by
    name, and go to the parameters' device."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        raw = msgpack.unpack(f.read())
    if restore_opt:
        kind = _phase_kind(state)
        module = state.posenet if kind == "pose" else state.refiner
        try:
            if state.accum is None:
                compat.adam_from_optax(state.optimizer, module, kind,
                                       raw["opt_state"])
            else:
                compat.multisteps_from_optax(state.optimizer, module, kind,
                                             state.accum, raw["opt_state"])
        except KeyError as e:
            raise ValueError(
                f"optimizer state in {path!r} does not match the template "
                f"(checkpoint phase/grad_accum differs — build the template "
                f"with peek_curriculum(), or pass restore_opt=False if you "
                f"only need parameters): {e}") from e
    state.posenet.load_state_dict(
        compat.posenet_state_dict_from_flax(raw["params_pose"]), strict=True)
    state.refiner.load_state_dict(
        compat.refiner_state_dict_from_flax(raw["params_refine"]),
        strict=True)
    state.step = int(np.asarray(raw["step"]))
    state.rng_key = np.array(raw["rng"], np.uint32)
    _restore_generator(state.generator, raw)
    curriculum = peek_curriculum(path)
    cfg_path = os.path.join(path, "config.json")
    config_json = None
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config_json = f.read()
    return state, curriculum, config_json
