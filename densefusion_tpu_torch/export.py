"""Deployment export: checkpoint -> a ``torch.export`` inference artifact
(counterpart of ``densefusion_tpu/export.py``).

Packages the whole estimate + refine program (PoseNet forward, argmax-
confidence selection, K refiner iterations unrolled: the graph of
:meth:`densefusion_tpu_torch.eval.InferencePipeline._infer`) at a fixed
batch, with the checkpoint's parameters as the program's state, as
``torch.export.save`` bytes (a ``.pt2`` archive) for one device.

Kernel 6 stays one node of the program: on the card the fused decoder's
three phase convolutions are ``torch.ops.densefusion_tpu_torch.phase_conv3x3``
(:mod:`densefusion_tpu_torch.ops.phase_conv`), whose CUDA implementation
launches ``csrc/phase_conv.cu`` (or ``csrc/phase_conv_bf16.cu`` with
``bf16=True``). So, unlike the JAX artifact, which loads with jax alone,
loading needs this package importable (it registers the op before the
archive is read) and its kernels built from ``csrc/`` at first launch; it
does not need ``densefusion_tpu_torch.models``. Loading also sets the
port's float32 policy (TF32 off for matmuls and cuDNN), which a fresh
process would otherwise leave on for cuDNN's convolutions.

Example::

    from densefusion_tpu_torch.export import export_inference, load_exported
    blob = export_inference("trained_models/linemod/checkpoint_best_refine",
                            batch=8)
    open("posenet_b8.pt2", "wb").write(blob)
    ...
    fn = load_exported(open("posenet_b8.pt2", "rb").read())
    quat, trans, conf = fn(img, points, choose, obj)
"""

from __future__ import annotations

import io
import json
import os

import torch
from torch import nn

from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.eval.pipeline import (
    InferencePipeline, pipeline_inputs,
)
# registers torch.ops.densefusion_tpu_torch.phase_conv3x3, which an artifact
# exported on the card calls: torch.export.load needs it registered first
from densefusion_tpu_torch.ops import phase_conv  # noqa: F401

META = "densefusion_tpu_torch.json"
"""The archive's extra file that records how the program was exported."""


class _Program(nn.Module):
    """The pipeline's ``_infer`` as a module whose submodules are the
    networks, so ``torch.export`` lifts their weights into the program."""

    def __init__(self, pipe):
        super().__init__()
        self.posenet, self.refiner = pipe.posenet, pipe.refiner
        self.pipe = pipe

    def forward(self, img, points, choose, obj):
        return self.pipe._infer(img, points, choose, obj)


def export_inference(ckpt_path: str, batch: int, refine_iters: int = 2,
                     bf16: bool = False, device=None) -> bytes:
    """Serialize the inference program for a fixed batch size on one
    device (``None`` means CUDA): ``torch.export.save`` bytes of the
    ``ExportedProgram``, with the metadata :func:`read_meta` returns as an
    extra file. Models are built as ``PoseEstimator.from_checkpoint``
    builds them: the checkpoint's ``config.json`` (object count, crop size,
    cloud size, decoder), its parameters, and ``refine_iters`` clamped to 0
    for an untrained refiner."""
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
    from densefusion_tpu_torch.train.checkpoint import (
        clamp_refine_iters, load_state_dicts,
    )
    from densefusion_tpu_torch.utils.config import RunConfig

    with open(os.path.join(ckpt_path, "config.json")) as f:
        cfg = RunConfig.from_json(f.read())
    refine_iters = clamp_refine_iters(ckpt_path, refine_iters)
    dtype = torch.bfloat16 if bf16 else None
    posenet = PoseNet(cfg.num_objects, dtype=dtype, **cfg.decoder_flags())
    refiner = PoseRefineNet(cfg.num_objects, dtype=dtype)
    pose_state, refine_state = load_state_dicts(ckpt_path)
    posenet.load_state_dict(pose_state, strict=True)
    refiner.load_state_dict(refine_state, strict=True)
    pipe = InferencePipeline(posenet, refiner, refine_iters=refine_iters,
                             device=device)
    b, c, n = batch, cfg.crop_size, cfg.num_points
    args = pipeline_inputs(torch.zeros((b, c, c, 3)), torch.zeros((b, n, 3)),
                           torch.zeros((b, n), dtype=torch.int64),
                           torch.zeros((b,), dtype=torch.int64), pipe.device)
    with torch.no_grad():
        program = torch.export.export(_Program(pipe), args)
    meta = {"device": pipe.device.type, "batch": b, "crop_size": c,
            "num_points": n, "num_objects": cfg.num_objects,
            "refine_iters": refine_iters, "bf16": bf16,
            "decoder": cfg.decoder}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META: json.dumps(meta)})
    return buf.getvalue()


def read_meta(blob: bytes) -> dict:
    """The metadata an artifact was saved with (device, batch, shapes,
    refine iterations, bf16, decoder)."""
    import zipfile

    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        for name in z.namelist():
            if name.endswith("extra/" + META):
                return json.loads(z.read(name))
    raise ValueError(f"not an artifact of this package: no {META}")


def load_exported(blob: bytes, device=None):
    """Deserialize an artifact -> ``fn(img, points, choose, obj) -> (quat,
    trans, conf)`` on ``device`` (``None`` means CUDA), which must be the
    device type it was exported for. Inputs may be numpy arrays or tensors
    of the exported batch; outputs are tensors on the device. Sets the
    port's float32 policy first (TF32 off on the card); imports nothing of
    ``densefusion_tpu_torch.models``."""
    dev = resolve_device(device)
    meta = read_meta(blob)
    if meta["device"] != dev.type:
        raise ValueError(f"the artifact was exported for {meta['device']}, "
                         f"not {dev.type}: export it again with "
                         f"device={dev.type!r}")
    module = torch.export.load(io.BytesIO(blob)).module()

    def fn(img, points, choose, obj):
        with torch.no_grad():
            return module(*pipeline_inputs(img, points, choose, obj, dev))

    return fn
