"""Weights carried across from the JAX package.

Converts the JAX package's parameter trees — nested dicts of numpy arrays
``{"params": {...}}``, as ``jax.tree.map(np.asarray, variables)`` gives them
— into state_dicts under the reference's torch names
(``cnn.model.module.feats.conv1.weight``, ``conv1_r.weight``, ...), which
the port's modules load with ``load_state_dict(strict=True)``. A reference
``.pth`` has the same names, so it loads the same way.

Layout transforms (the inverse of the JAX package's importer):

* flax Conv ``(kh, kw, in, out)`` -> Conv2d ``(out, in, kh, kw)``
* Dense ``(in, out)`` -> Conv1d k=1 ``(out, in, 1)`` or Linear ``(out, in)``
* PReLU scalar slope -> ``(1,)``
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from densefusion_tpu_torch.models.resnet import RESNET_DEPTHS


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


# ---------------------------------------------------------------------------
# Key maps: flax param path (tuple under ["params"]) -> (torch key, transform)
# ---------------------------------------------------------------------------

def _trunk_map(prefix: str, variant: str) -> dict:
    m = {("trunk", "stem", "kernel"): (f"{prefix}conv1.weight", _conv2d)}
    for s, depth in enumerate(RESNET_DEPTHS[variant]):
        for b in range(depth):
            t = f"{prefix}layer{s + 1}.{b}."
            blk = f"stage{s + 1}_block{b}"
            for c in ("conv1", "conv2"):
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
        out[key] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def posenet_state_dict_from_flax(params: Mapping, variant: str = "resnet18",
                                 prefix: str = "cnn.model.module."
                                 ) -> dict[str, torch.Tensor]:
    """JAX ``PoseNet`` params -> the reference ``PoseNet`` state_dict names."""
    mapping = {**_pspnet_map(prefix, variant), **_fusion_map("feat."),
               **_posenet_head_map()}
    return _export(params, mapping)


def refiner_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``PoseRefineNet`` params -> the reference ``PoseRefineNet``
    state_dict names."""
    return _export(params, {**_fusion_map("feat."), **_refiner_head_map()})
