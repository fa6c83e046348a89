"""Weights and optimizer state carried between the JAX package and the port.

Converts the JAX package's parameter trees — nested dicts of numpy arrays
``{"params": {...}}``, as ``jax.tree.map(np.asarray, variables)`` gives them
— into state_dicts under the reference's torch names
(``cnn.model.module.feats.conv1.weight``, ``conv1_r.weight``, ...), which
the port's modules load with ``load_state_dict(strict=True)``. A reference
``.pth`` has the same names, so it loads the same way. The inverse
(``*_params_from_state_dict``) gives back the tree the JAX package's
``create_train_state`` makes, keys sorted at every level as ``jax.jit``
returns them.

Layout transforms (the inverse of the JAX package's importer):

* flax Conv ``(kh, kw, in, out)`` -> Conv2d ``(out, in, kh, kw)``
* Dense ``(in, out)`` -> Conv1d k=1 ``(out, in, 1)`` or Linear ``(out, in)``
* PReLU scalar slope -> ``(1,)``

SegNet (:class:`~densefusion_tpu_torch.models.SegNet`) has two trees,
``{"params", "batch_stats"}``: its BN scale / shift are ``bn*.weight`` /
``.bias`` and its statistics ``bn*.running_mean`` / ``.running_var``
(no ``num_batches_tracked``, which the reference's torch 0.4.1 lacks).

Optimizer state: torch Adam's per-parameter ``exp_avg`` / ``exp_avg_sq`` /
``step`` are optax ``adam``'s ``mu`` / ``nu`` / ``count`` (the same update,
``tests/test_torch_train.py``), each moment under its parameter's flax path
and layout. ``flax.serialization`` writes ``optax.adam``'s
``(ScaleByAdamState, EmptyState)`` as ``{"0": {"count", "mu", "nu"},
"1": {}}``, and ``optax.MultiSteps`` around it as ``{"mini_step",
"gradient_step", "inner_opt_state", "acc_grads", "skip_state"}``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from densefusion_tpu_torch.models.resnet import Bottleneck, RESNET_SPECS


def _conv2d(w):
    return np.transpose(w, (3, 2, 0, 1))          # HWIO -> OIHW


def _conv1d(w):
    return np.transpose(w, (1, 0))[:, :, None]


def _linear(w):
    return np.transpose(w, (1, 0))


def _bias(w):
    return w


def _prelu(w):
    return np.reshape(w, (1,))


# torch layout -> flax layout, for each transform above
_INVERSE = {
    _conv2d: lambda w: np.transpose(w, (2, 3, 1, 0)),   # OIHW -> HWIO
    _conv1d: lambda w: np.transpose(w[:, :, 0], (1, 0)),
    _linear: lambda w: np.transpose(w, (1, 0)),
    _bias: lambda w: w,
    _prelu: lambda w: np.reshape(w, ()),
}


# ---------------------------------------------------------------------------
# Key maps: flax param path (tuple under ["params"]) -> (torch key, transform)
# ---------------------------------------------------------------------------

def _trunk_map(prefix: str, variant: str) -> dict:
    """Every trunk of ``RESNET_SPECS``: a Bottleneck block has conv1..3
    (``densefusion_tpu/compat.py:115-131``)."""
    block, depths = RESNET_SPECS[variant]
    convs = ("conv1", "conv2", "conv3") if block is Bottleneck \
        else ("conv1", "conv2")
    m = {("trunk", "stem", "kernel"): (f"{prefix}conv1.weight", _conv2d)}
    for s, depth in enumerate(depths):
        for b in range(depth):
            t = f"{prefix}layer{s + 1}.{b}."
            blk = f"stage{s + 1}_block{b}"
            for c in convs:
                m[("trunk", blk, c, "kernel")] = (t + f"{c}.weight", _conv2d)
            # only blocks that change stride or width have a projection;
            # the export walks the tree, so unused entries are never read
            m[("trunk", blk, "proj", "kernel")] = \
                (t + "downsample.0.weight", _conv2d)
    return m


def _pspnet_map(prefix: str, variant: str, sizes=(1, 2, 3, 6)) -> dict:
    m = {(("cnn",) + k): v
         for k, v in _trunk_map(prefix + "feats.", variant).items()}
    for i, size in enumerate(sizes):
        m[("cnn", "psp", f"prior_{size}", "kernel")] = \
            (f"{prefix}psp.stages.{i}.1.weight", _conv2d)
    m[("cnn", "psp", "bottleneck", "kernel")] = \
        (f"{prefix}psp.bottleneck.weight", _conv2d)
    m[("cnn", "psp", "bottleneck", "bias")] = \
        (f"{prefix}psp.bottleneck.bias", _bias)
    for ours, theirs in (("up1", "up_1"), ("up2", "up_2")):
        m[("cnn", ours, "conv", "kernel")] = \
            (f"{prefix}{theirs}.conv.1.weight", _conv2d)
        m[("cnn", ours, "conv", "bias")] = \
            (f"{prefix}{theirs}.conv.1.bias", _bias)
        m[("cnn", ours, "prelu", "slope")] = \
            (f"{prefix}{theirs}.conv.2.weight", _prelu)
    m[("cnn", "up3_conv", "kernel")] = (f"{prefix}up_3.conv.1.weight", _conv2d)
    m[("cnn", "up3_conv", "bias")] = (f"{prefix}up_3.conv.1.bias", _bias)
    m[("cnn", "up3_prelu", "slope")] = (f"{prefix}up_3.conv.2.weight", _prelu)
    m[("cnn", "final", "kernel")] = (f"{prefix}final.0.weight", _conv2d)
    m[("cnn", "final", "bias")] = (f"{prefix}final.0.bias", _bias)
    return m


def _fusion_map(prefix: str = "feat.") -> dict:
    pairs = {"geo1": "conv1", "geo2": "conv2", "col1": "e_conv1",
             "col2": "e_conv2", "mix1": "conv5", "mix2": "conv6"}
    m = {}
    for ours, theirs in pairs.items():
        m[("fusion", ours, "kernel")] = (f"{prefix}{theirs}.weight", _conv1d)
        m[("fusion", ours, "bias")] = (f"{prefix}{theirs}.bias", _bias)
    return m


def _posenet_head_map() -> dict:
    m = {}
    for letter, head in (("r", "head_r"), ("t", "head_t"), ("c", "head_c")):
        for i in range(1, 5):
            m[(head, f"fc{i}", "kernel")] = \
                (f"conv{i}_{letter}.weight", _conv1d)
            m[(head, f"fc{i}", "bias")] = (f"conv{i}_{letter}.bias", _bias)
    return m


def _refiner_head_map() -> dict:
    m = {}
    for letter, head in (("r", "head_r"), ("t", "head_t")):
        for i in range(1, 4):
            m[(f"{head}_fc{i}", "kernel")] = \
                (f"conv{i}_{letter}.weight", _linear)
            m[(f"{head}_fc{i}", "bias")] = (f"conv{i}_{letter}.bias", _bias)
    return m


def _leaves(tree: Mapping, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _export(params: Mapping, mapping: dict) -> dict[str, torch.Tensor]:
    out = {}
    for path, leaf in _leaves(params["params"]):
        if path not in mapping:
            raise KeyError(f"no torch mapping for flax param {'/'.join(path)}")
        key, transform = mapping[path]
        value = transform(np.asarray(leaf, np.float32))
        # a writable copy: leaves read from a checkpoint are read-only views
        out[key] = torch.from_numpy(np.array(value, order="C"))
    return out


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float32)


def _import(named: Mapping, mapping: dict) -> dict:
    """torch-named tensors -> ``{"params": tree}`` under ``mapping``'s flax
    paths, in flax's layouts; a name with no flax path raises."""
    inverse = {key: (path, _INVERSE[transform])
               for path, (key, transform) in mapping.items()}
    flat = {}
    for key, value in named.items():
        if key not in inverse:
            raise KeyError(f"no flax path for torch key {key!r}")
        path, transform = inverse[key]
        flat[path] = np.array(transform(_to_numpy(value)), order="C")
    tree: dict = {}
    for path in sorted(flat):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[path]
    return {"params": tree}


def _posenet_map(variant: str = "resnet18",
                 prefix: str = "cnn.model.module.") -> dict:
    return {**_pspnet_map(prefix, variant), **_fusion_map("feat."),
            **_posenet_head_map()}


def _refiner_map() -> dict:
    return {**_fusion_map("feat."), **_refiner_head_map()}


def posenet_state_dict_from_flax(params: Mapping, variant: str = "resnet18",
                                 prefix: str = "cnn.model.module."
                                 ) -> dict[str, torch.Tensor]:
    """JAX ``PoseNet`` params -> the reference ``PoseNet`` state_dict names."""
    return _export(params, _posenet_map(variant, prefix))


def refiner_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``PoseRefineNet`` params -> the reference ``PoseRefineNet``
    state_dict names."""
    return _export(params, _refiner_map())


def posenet_params_from_state_dict(state_dict: Mapping,
                                   variant: str = "resnet18",
                                   prefix: str = "cnn.model.module.") -> dict:
    """The port's (or a reference) ``PoseNet`` state_dict -> the JAX
    ``PoseNet`` params ``{"params": ...}`` of numpy arrays."""
    return _import(state_dict, _posenet_map(variant, prefix))


def refiner_params_from_state_dict(state_dict: Mapping) -> dict:
    """``PoseRefineNet`` state_dict -> the JAX ``PoseRefineNet`` params."""
    return _import(state_dict, _refiner_map())


# ---------------------------------------------------------------------------
# SegNet (vanilla_segmentation/segnet.py:6-121)
# ---------------------------------------------------------------------------

SEGNET_ENC_COUNTS = (2, 2, 3, 3, 3)   # conv layers per VGG16 pooling stage


def _segnet_maps(enc_counts=SEGNET_ENC_COUNTS) -> tuple[dict, dict]:
    """(params map, batch_stats map) of SegNet: flax ``enc{s}_{i}`` is
    ``conv{s}{i}`` / ``bn{s}{i}``; flax decoder stage s unpools encoder
    stage t = 6 - s, and its i-th conv is ``conv{t}{j}d`` / ``bn{t}{j}d``
    with j counted down from that stage's count (the reference applies them
    in descending order, ``vanilla_segmentation/segnet.py:100-117``); the
    last conv of stage 1 is the classifier ``conv11d``, without BN."""
    pmap: dict = {}
    smap: dict = {}

    def add(flax_name: str, torch_name: str) -> None:
        conv, bn = f"conv{torch_name}", f"bn{torch_name}"
        pmap[(flax_name, "conv", "kernel")] = (conv + ".weight", _conv2d)
        pmap[(flax_name, "conv", "bias")] = (conv + ".bias", _bias)
        pmap[(flax_name, "bn", "scale")] = (bn + ".weight", _bias)
        pmap[(flax_name, "bn", "bias")] = (bn + ".bias", _bias)
        smap[(flax_name, "bn", "mean")] = (bn + ".running_mean", _bias)
        smap[(flax_name, "bn", "var")] = (bn + ".running_var", _bias)

    for s, n in enumerate(enc_counts, start=1):
        for i in range(1, n + 1):
            add(f"enc{s}_{i}", f"{s}{i}")
    for s in range(1, len(enc_counts) + 1):
        t = len(enc_counts) + 1 - s
        n = enc_counts[t - 1]
        for i in range(1, (n if t > 1 else n - 1) + 1):
            add(f"dec{s}_{i}", f"{t}{n - i + 1}d")
    pmap[("classifier", "kernel")] = ("conv11d.weight", _conv2d)
    pmap[("classifier", "bias")] = ("conv11d.bias", _bias)
    return pmap, smap


def segnet_state_dict_from_flax(variables: Mapping,
                                enc_counts=SEGNET_ENC_COUNTS
                                ) -> dict[str, torch.Tensor]:
    """JAX ``SegNet`` variables ``{"params", "batch_stats"}`` -> the
    reference ``SegNet`` state_dict names, running statistics included."""
    pmap, smap = _segnet_maps(enc_counts)
    out = _export({"params": variables["params"]}, pmap)
    out.update(_export({"params": variables["batch_stats"]}, smap))
    return out


def segnet_variables_from_state_dict(state_dict: Mapping,
                                     enc_counts=SEGNET_ENC_COUNTS) -> dict:
    """A ``SegNet`` state_dict (the port's, or a reference one; its
    ``num_batches_tracked`` entries are dropped) -> the JAX variables
    ``{"params": ..., "batch_stats": ...}`` of numpy arrays, keys sorted."""
    pmap, smap = _segnet_maps(enc_counts)
    stats_keys = {key for key, _ in smap.values()}
    params, stats = {}, {}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        (stats if key in stats_keys else params)[key] = value
    return {"params": _import(params, pmap)["params"],
            "batch_stats": _import(stats, smap)["params"]}


# ---------------------------------------------------------------------------
# Optimizer state: torch Adam <-> optax adam / MultiSteps
# ---------------------------------------------------------------------------

def _key_map(kind: str, module) -> dict:
    """The params key map of ``kind`` for ``module``: ``"pose"`` (the
    PoseNet's trunk variant), ``"refine"``, or ``"segnet"`` (its map
    follows the module's stage counts)."""
    if kind == "segnet":
        return _segnet_maps(module.enc_counts)[0]
    if kind == "pose":
        return _posenet_map(module.cnn_variant)
    return _refiner_map()


def _moments(named: Mapping, kind: str, module) -> dict:
    """Moments by torch name -> optax's tree: under ``"params"`` for the
    pose phases (whose optax state mirrors the whole variables dict), bare
    for SegNet (whose mirrors ``variables["params"]``)."""
    tree = _import(named, _key_map(kind, module))
    return tree["params"] if kind == "segnet" else tree


def _moment_tensors(tree: Mapping, kind: str, module) -> dict:
    """The inverse of :func:`_moments`, on the parameters' devices."""
    if kind == "segnet":
        tree = {"params": tree}
    return _named_tensors(tree, _key_map(kind, module), module)


def adam_to_optax(optimizer: torch.optim.Optimizer, module, kind: str
                  ) -> dict:
    """A torch Adam over ``module``'s parameters -> optax adam's state as
    flax serializes it. ``count`` is the largest per-parameter ``step`` (a
    parameter Adam has not stepped has zero moments, which optax's update
    leaves at zero too). ``kind``: ``"pose"``, ``"refine"`` or
    ``"segnet"``."""
    mu, nu, count = {}, {}, 0
    for name, p in module.named_parameters():
        st = optimizer.state.get(p, {})
        if "exp_avg" in st:
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
            count = max(count, int(st["step"]))
        else:
            mu[name] = nu[name] = torch.zeros_like(p)
    return {"0": {"count": np.asarray(count, np.int32),
                  "mu": _moments(mu, kind, module),
                  "nu": _moments(nu, kind, module)},
            "1": {}}


def _named_tensors(tree: Mapping, mapping: dict, module) -> dict:
    """A flax tree -> {torch name: tensor} for exactly ``module``'s
    parameters, on their devices; raises on a missing or extra leaf."""
    named = _export(tree, mapping)
    params = dict(module.named_parameters())
    if set(named) != set(params):
        raise KeyError(f"flax tree has {sorted(set(named) - set(params))} "
                       f"beyond and lacks {sorted(set(params) - set(named))} "
                       "of the module's parameters")
    return {k: v.to(params[k].device) for k, v in named.items()}


def adam_from_optax(optimizer: torch.optim.Optimizer, module, kind: str,
                    opt_state: Mapping) -> None:
    """Load optax adam's serialized state into ``optimizer`` (a torch Adam
    over ``module``), matching moments to parameters by name through the
    key map, never by position. Raises ``KeyError`` when the tree is not
    adam's over this module."""
    if set(opt_state) != {"0", "1"} or set(opt_state["0"]) != {
            "count", "mu", "nu"}:
        raise KeyError(f"not optax adam's state: keys {sorted(opt_state)}")
    mu = _moment_tensors(opt_state["0"]["mu"], kind, module)
    nu = _moment_tensors(opt_state["0"]["nu"], kind, module)
    step = float(np.asarray(opt_state["0"]["count"]))
    optimizer.state.clear()
    for name, p in module.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(step),
                              "exp_avg": mu[name], "exp_avg_sq": nu[name]}


def multisteps_to_optax(optimizer, module, kind: str, accum) -> dict:
    """``optax.MultiSteps(adam)``'s state from the torch Adam and the
    step's :class:`~densefusion_tpu_torch.train.state.GradAccum`."""
    named = dict(zip((n for n, _ in module.named_parameters()), accum.acc))
    return {"mini_step": np.asarray(accum.mini_step, np.int32),
            "gradient_step": np.asarray(accum.gradient_step, np.int32),
            "inner_opt_state": adam_to_optax(optimizer, module, kind),
            "acc_grads": _import(named, _key_map(kind, module)),
            "skip_state": {}}


def multisteps_from_optax(optimizer, module, kind: str, accum,
                          opt_state: Mapping) -> None:
    """Load ``optax.MultiSteps(adam)``'s serialized state into the torch
    Adam and ``accum`` (its counters and accumulated gradients)."""
    want = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
            "skip_state"}
    if set(opt_state) != want:
        raise KeyError(f"not optax MultiSteps' state: keys "
                       f"{sorted(opt_state)}")
    adam_from_optax(optimizer, module, kind, opt_state["inner_opt_state"])
    acc = _named_tensors(opt_state["acc_grads"], _key_map(kind, module),
                         module)
    for a, (name, _) in zip(accum.acc, module.named_parameters()):
        a.copy_(acc[name])
    accum.mini_step = int(np.asarray(opt_state["mini_step"]))
    accum.gradient_step = int(np.asarray(opt_state["gradient_step"]))
