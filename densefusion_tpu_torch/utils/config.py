"""Typed run configuration (counterpart of
``densefusion_tpu/utils/config.py``): the same fields, defaults, presets
and JSON form, so a config written by a JAX run loads here and round-trips
to the same dict.

Some fields ask for options the port does not run yet; :func:`check_ported`
is how the port's consumers refuse them instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class RunConfig:
    # dataset
    dataset: str = "linemod"          # ycb | linemod | cad
    dataset_root: str = ""
    num_objects: int = 13
    num_points: int = 500             # cloud points per crop
    num_mesh_points: int = 500        # model points (YCB refine: 2600)
    refine_mesh_points: int = 500
    crop_size: int = 192
    sym_list: tuple[int, ...] = ()
    # subset of dataset object ids (empty = the dataset's full list);
    # linemod/cad only. num_objects must equal len(objlist) when set.
    objlist: tuple[int, ...] = ()
    # optimization
    batch_size: int = 8
    grad_accum: int = 1               # accumulation on top of batch_size
    lr: float = 1e-4
    lr_rate: float = 0.1
    w: float = 0.015
    w_rate: float = 0.1
    decay_margin: float = 0.03
    refine_margin: float = 0.02
    noise_trans: float = 0.03
    refine_iters: int = 2
    nepoch: int = 500
    repeat_epoch: int = 1
    # runtime
    seed: int = 0
    out_dir: str = "trained_models"
    log_dir: str = "experiments/logs"
    checkpoint_every_steps: int = 1000
    # restart guard: when > 0 and the process RSS exceeds this many GiB at
    # a checkpoint boundary, the trainer saves and restarts itself with
    # --resume; 0 disables it
    rss_restart_gb: float = 0.0
    num_workers: int = 4
    # "process": fork workers + shared-memory sample ring (linux only);
    # "thread": GIL-sharing pool (safe everywhere)
    worker_mode: str = "process"
    knn_backend: str = "auto"
    bf16_compute: bool = False
    # CNN decoder: "fused" = phase-conv stages, replicate borders,
    # half-pixel resizes; "dense" = resize + conv, zero borders,
    # half-pixel; "torch" = the reference's align_corners=True resizes and
    # zero borders
    decoder: str = "fused"
    # recompute the CNN in the backward pass to cut peak activation memory
    remat_cnn: bool = False

    def decoder_flags(self) -> dict:
        """PoseNet/PSPNet constructor kwargs for this config's ``decoder``
        mode (see the field comment)."""
        if self.decoder not in ("fused", "dense", "torch"):
            raise ValueError(f"unknown decoder mode {self.decoder!r} "
                             "(expected fused | dense | torch)")
        return {"fused_decoder": self.decoder == "fused",
                "align_corners": self.decoder == "torch"}

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        d = json.loads(text)
        d["sym_list"] = tuple(d.get("sym_list", ()))
        d["objlist"] = tuple(d.get("objlist", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def preset(cls, dataset: str, **overrides: Any) -> "RunConfig":
        cfg = dict(DATASET_PRESETS[dataset])
        cfg.update(overrides)
        return cls(dataset=dataset, **cfg)


# Per-dataset constants (the reference's tools/train.py and dataset classes).
DATASET_PRESETS: dict[str, dict] = {
    "ycb": dict(num_objects=21, num_points=1000, num_mesh_points=500,
                refine_mesh_points=2600, repeat_epoch=1,
                sym_list=(12, 15, 18, 19, 20)),
    "linemod": dict(num_objects=13, num_points=500, num_mesh_points=500,
                    refine_mesh_points=500, repeat_epoch=20,
                    sym_list=(7, 8)),
    "cad": dict(num_objects=5, num_points=500, num_mesh_points=500,
                refine_mesh_points=500, repeat_epoch=1, sym_list=()),
}


KNN_BACKENDS = ("auto", "pallas", "xla")


def check_ported(cfg: RunConfig, device=None) -> None:
    """Raise ``NotImplementedError`` for a field value whose option the port
    does not run yet, naming the ROADMAP.md section that queues it.
    ``bf16_compute`` and ``remat_cnn`` run (the ``Trainer`` builds its
    networks from them).

    ``knn_backend`` keeps its JAX meaning as far as the port has one: on the
    CPU every value runs the plain versions (the JAX test configs use
    ``"xla"``); on CUDA (``device`` None or a CUDA device) ``"auto"`` and
    ``"pallas"`` run the Hopper kernels, and ``"xla"``, which asks for the
    plain path on the accelerator, is refused: a wrapper takes its plain
    version only for CPU tensors."""
    if cfg.knn_backend not in KNN_BACKENDS:
        raise ValueError(f"unknown knn_backend {cfg.knn_backend!r} "
                         f"(expected one of {KNN_BACKENDS})")
    on_cuda = device is None or str(device).startswith("cuda")
    if on_cuda and cfg.knn_backend == "xla":
        raise NotImplementedError(
            "knn_backend='xla' (the plain search on the accelerator) has no "
            "counterpart on CUDA, where the port runs its kernels (ROADMAP.md "
            "Rules of the port); use 'auto', or device='cpu'")
