"""Weights and optimizer state carried between the JAX package and the port.

Converts the JAX package's parameter trees — nested dicts of numpy arrays
``{"params": {...}}``, as ``jax.tree.map(np.asarray, variables)`` gives them
— into state_dicts under the reference's torch names
(``cnn.model.module.feats.conv1.weight``, ``conv1_r.weight``, ...), which
the port's modules load with ``load_state_dict(strict=True)``. The inverse
(``*_params_from_state_dict``) gives back the tree the JAX package's
``create_train_state`` makes, keys sorted at every level as ``jax.jit``
returns them.

A reference ``.pth`` (``torch.save(model.state_dict())``) uses the same
names but does not load strictly as it is: a ``PoseNet`` file carries the
PSPNet's dead aux classifier (``cnn.model.module.classifier.*``,
``lib/pspnet.py:58-62``) and may put the CNN under ``cnn.model.`` or
``cnn.`` instead; a modern-torch ``SegNet`` file carries
``num_batches_tracked``. :func:`import_torch_checkpoint` and
:func:`import_segnet_checkpoint` (``densefusion_tpu/compat.py:311-365,
479-494``) rename, skip and check such a file into a checkpoint of the
port, and :func:`export_torch_checkpoint` / :func:`export_segnet_checkpoint`
write one back.

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

# where the port's PoseNet keeps its CNN, as the reference saves it
# (ModifiedResnet wraps PSPNet in DataParallel, lib/network.py:27-37)
_PREFIX = "cnn.model.module."


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
                 prefix: str = _PREFIX) -> dict:
    return {**_pspnet_map(prefix, variant), **_fusion_map("feat."),
            **_posenet_head_map()}


def _refiner_map() -> dict:
    return {**_fusion_map("feat."), **_refiner_head_map()}


def posenet_state_dict_from_flax(params: Mapping, variant: str = "resnet18",
                                 prefix: str = _PREFIX
                                 ) -> dict[str, torch.Tensor]:
    """JAX ``PoseNet`` params -> the reference ``PoseNet`` state_dict names."""
    return _export(params, _posenet_map(variant, prefix))


def refiner_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``PoseRefineNet`` params -> the reference ``PoseRefineNet``
    state_dict names."""
    return _export(params, _refiner_map())


def posenet_params_from_state_dict(state_dict: Mapping,
                                   variant: str = "resnet18",
                                   prefix: str = _PREFIX) -> dict:
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


# ---------------------------------------------------------------------------
# Reference .pth files (densefusion_tpu/compat.py:101-108,202-207,311-365,
# 366-408,479-554)
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` state_dict, on the CPU. Read with ``weights_only=True``
    only: a file that needs more than tensors and containers is refused,
    since unpickling anything else can run its code (the JAX package falls
    back to a full unpickle)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in sd.items()}


def _detect_cnn_prefix(sd: Mapping) -> str:
    for p in (_PREFIX, "cnn.model.", "cnn."):
        if any(k.startswith(p + "feats.") for k in sd):
            return p
    raise ValueError("state_dict has no recognizable PSPNet keys "
                     "(expected cnn.model.module.feats.*)")


def _from_reference(sd: Mapping, module, ignore_prefixes: tuple = ()
                    ) -> dict[str, torch.Tensor]:
    """``sd`` checked against ``module``'s state_dict: every key the module
    has must be there with its shape, and every other key must lie under
    ``ignore_prefixes``. Returns the module's keys as float32 CPU tensors,
    ready for ``load_state_dict(strict=True)``."""
    out = {}
    for key, want in module.state_dict().items():
        if key not in sd:
            raise KeyError(f"torch state_dict missing {key}")
        value = torch.as_tensor(sd[key]).detach().to("cpu", torch.float32)
        if value.shape != want.shape:
            raise ValueError(f"shape mismatch for {key}: torch gives "
                             f"{tuple(value.shape)}, the port expects "
                             f"{tuple(want.shape)}")
        out[key] = value.contiguous()
    leftovers = [k for k in sd if k not in out
                 and not k.startswith(tuple(ignore_prefixes))]
    if leftovers:
        raise ValueError(f"unconsumed torch keys (first 10): {leftovers[:10]}")
    return out


def posenet_state_dict_from_torch(sd: Mapping, num_obj: int,
                                  variant: str = "resnet18"
                                  ) -> dict[str, torch.Tensor]:
    """A reference ``PoseNet.state_dict()`` (``lib/network.py:70-132``),
    its CNN under any of the three prefixes -> the port's ``PoseNet``
    state_dict; the aux classifier is skipped."""
    from densefusion_tpu_torch.models import PoseNet

    prefix = _detect_cnn_prefix(sd)
    renamed = {_PREFIX + k[len(prefix):] if k.startswith(prefix) else k: v
               for k, v in sd.items()}
    return _from_reference(renamed, PoseNet(num_obj, cnn_variant=variant),
                           ignore_prefixes=(_PREFIX + "classifier.",))


def refiner_state_dict_from_torch(sd: Mapping, num_obj: int
                                  ) -> dict[str, torch.Tensor]:
    """A reference ``PoseRefineNet.state_dict()`` (``lib/network.py:
    170-206``), checked against the port's ``PoseRefineNet``."""
    from densefusion_tpu_torch.models import PoseRefineNet

    return _from_reference(sd, PoseRefineNet(num_obj))


def import_torch_checkpoint(pose_pth: str, out_path: str, num_obj: int,
                            refine_pth: str | None = None,
                            variant: str = "resnet18",
                            dataset: str = "ycb",
                            num_points: int = 1000,
                            crop_size: int = 192) -> None:
    """Convert reference ``.pth`` checkpoint(s) into a checkpoint directory
    of the port (the JAX package's format): the config at
    ``decoder="torch"`` (the reference's align-corners decoder,
    ``lib/pspnet.py:31``), a fresh optimizer, and the curriculum
    fast-forwarded when a refiner is given (``refine_started``,
    ``decay_started``, ``refine_steps=1``: the imported refiner is trained),
    mirroring the reference's resume (``tools/train.py:83-97``). The state is
    built on the CPU: nothing is computed."""
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train.checkpoint import save_checkpoint
    from densefusion_tpu_torch.train.state import (
        Curriculum, create_train_state,
    )
    from densefusion_tpu_torch.utils.config import RunConfig

    cfg = RunConfig.preset(dataset, num_points=num_points,
                           crop_size=crop_size, decoder="torch")
    posenet = PoseNet(num_obj, cnn_variant=variant, **cfg.decoder_flags())
    refiner = PoseRefineNet(num_obj)
    state = create_train_state(posenet, refiner, cfg.lr, seed=0,
                               device="cpu")
    posenet.load_state_dict(posenet_state_dict_from_torch(
        load_torch_state_dict(pose_pth), num_obj, variant), strict=True)
    cur = Curriculum()
    if refine_pth is not None:
        refiner.load_state_dict(refiner_state_dict_from_torch(
            load_torch_state_dict(refine_pth), num_obj), strict=True)
        cur.refine_started = True
        cur.decay_started = True
        # the reference's published refiner is trained: mark it so the
        # consumers' untrained-refiner guard (clamp_refine_iters) keeps
        # refinement on
        cur.refine_steps = 1
    save_checkpoint(out_path, state, cur, cfg)


def export_torch_checkpoint(ckpt_path: str, pose_out: str,
                            refine_out: str | None = None,
                            variant: str = "resnet18") -> dict:
    """A checkpoint directory (either package's) -> reference ``.pth``
    file(s), loadable by the reference's ``PoseNet`` / ``PoseRefineNet``
    with ``strict=False`` (the aux classifier is not written). Shapes are
    checked against models built from the checkpoint's own
    ``config.json``, which is returned as a dict."""
    import json

    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train import msgpack

    with open(f"{ckpt_path}/config.json") as f:
        cfg = json.load(f)
    with open(f"{ckpt_path}/state.msgpack", "rb") as f:
        raw = msgpack.unpack(f.read())
    pose = posenet_state_dict_from_flax(raw["params_pose"], variant)
    PoseNet(cfg["num_objects"], cnn_variant=variant).load_state_dict(
        pose, strict=True)
    torch.save(pose, pose_out)
    if refine_out is not None:
        refine = refiner_state_dict_from_flax(raw["params_refine"])
        PoseRefineNet(cfg["num_objects"]).load_state_dict(refine,
                                                          strict=True)
        torch.save(refine, refine_out)
    return cfg


def segnet_state_dict_from_torch(sd: Mapping, num_classes: int = 22
                                 ) -> dict[str, torch.Tensor]:
    """A reference ``SegNet.state_dict()`` (``vanilla_segmentation/
    segnet.py:6-121``) -> the port's ``SegNet`` state_dict; its
    ``num_batches_tracked`` entries (a modern-torch save has them, the
    reference's torch 0.4.1 none) are dropped."""
    from densefusion_tpu_torch.models import SegNet

    return _from_reference(
        {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")},
        SegNet(num_classes=num_classes))


def import_segnet_checkpoint(segnet_pth: str, out_msgpack: str,
                             num_classes: int = 22) -> None:
    """A reference ``.pth`` SegNet (``vanilla_segmentation/train.py:80,
    103-106``) -> a ``segnet_best.msgpack`` that ``cli.segment`` of either
    package reads."""
    import os

    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import save_segnet

    net = SegNet(num_classes=num_classes)
    net.load_state_dict(segnet_state_dict_from_torch(
        load_torch_state_dict(segnet_pth), num_classes), strict=True)
    os.makedirs(os.path.dirname(out_msgpack) or ".", exist_ok=True)
    save_segnet(out_msgpack, net)


def export_segnet_checkpoint(msgpack_path: str, out_pth: str,
                             num_classes: int = 22) -> None:
    """A ``segnet_best.msgpack`` -> a reference ``torch.save(state_dict())``
    file that ``vanilla_segmentation/segnet.py`` loads (no
    ``num_batches_tracked``)."""
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import load_segnet

    net = load_segnet(msgpack_path, SegNet(num_classes=num_classes))
    torch.save({k: v.detach().clone() for k, v in net.state_dict().items()},
               out_pth)
