"""Training driver: the epoch loop and the two-phase curriculum (counterpart
of ``densefusion_tpu/train/loop.py``).

Kept from the JAX trainer: a train / test cycle per epoch with
average-distance selection, the best / current checkpoint policy, periodic
'current' checkpoints, the lr / w decay at ``decay_margin`` with a fresh
Adam, the refiner phase at ``refine_margin`` with the datasets rebuilt (YCB
mesh points 500 -> 2600), a ``(repetition, batch)`` data cursor so a resume
replays the exact tail of an epoch, a STOP file, and the RSS guard that asks
``cli.train`` to exec-restart.

Batches go to the device through :func:`densefusion_tpu_torch.data.
to_device`. Nothing in an epoch waits for the card except its log points:
the running distance stays on the device until then.

Data parallelism (``shard_batch=``, the JAX trainer's hook, from
:func:`densefusion_tpu_torch.parallel.make_shard_batch_fn`): one process
per rank, each loading and stepping on its rows of every global batch of
``cfg.batch_size``. The ranks start from rank 0's parameters, sum the test
epoch's distances so every rank takes the same curriculum gate, and stop
or restart together; only rank 0 writes checkpoints, metrics and the log
file, and the others wait for each checkpoint at a barrier.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from densefusion_tpu_torch.data import (
    BatchLoader, CADDataset, LineModDataset, PrefetchIterator, YCBDataset,
    to_device,
)
from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
from densefusion_tpu_torch.parallel.sharding import replicate
from densefusion_tpu_torch.train.checkpoint import (
    load_checkpoint, peek_curriculum, save_checkpoint,
)
from densefusion_tpu_torch.train.state import Curriculum, create_train_state
from densefusion_tpu_torch.train.steps import (
    make_eval_step, make_pose_train_step, make_refine_train_step,
)
from densefusion_tpu_torch.utils.config import RunConfig, check_ported
from densefusion_tpu_torch.utils.logging import MetricsWriter, setup_logger


class RestartRequested(Exception):
    """Raised (and handled inside :meth:`Trainer.run`) when the process RSS
    crosses ``cfg.rss_restart_gb``: the trainer stops with a fresh
    'current' checkpoint and sets ``trainer.restart_requested`` so its
    driver (``cli.train``) can exec-restart with ``--resume``."""


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS"):
                    return int(ln.split()[1]) / 1048576.0
    except OSError:
        pass
    return 0.0


class _NoMetrics:
    """The metrics stream of a rank that writes no files."""

    def write(self, **record) -> None:
        pass


def build_dataset(cfg: RunConfig, mode: str, refine: bool):
    """Dataset factory (``tools/train.py:99-114``): YCB, LineMOD or CAD."""
    common = dict(root=cfg.dataset_root, mode=mode,
                  num_points=cfg.num_points, crop_size=cfg.crop_size,
                  refine=refine, seed=cfg.seed,
                  noise_trans=cfg.noise_trans if mode == "train" else 0.0,
                  add_noise=(mode == "train"))
    if cfg.dataset == "ycb":
        return YCBDataset(**common)
    mesh = cfg.refine_mesh_points if refine else cfg.num_mesh_points
    if cfg.dataset == "linemod":
        return LineModDataset(num_mesh_points=mesh,
                              objlist=list(cfg.objlist) or None, **common)
    if cfg.dataset == "cad":
        if cfg.objlist:
            common["objlist"] = list(cfg.objlist)
        return CADDataset(num_mesh_points=mesh, **common)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


class Trainer:
    """The curriculum trainer on ``device`` (``None`` means CUDA, which
    must be present; ``"cpu"`` for the CPU). Options the port lacks are
    refused by ``check_ported`` here, before any work. ``cfg.bf16_compute``
    builds both networks with bf16 compute and ``cfg.remat_cnn`` the PoseNet
    with its CNN recomputed in the backward pass
    (``densefusion_tpu/train/loop.py:85-91``); parameters, gradients, Adam
    state and checkpoints stay float32. ``shard_batch`` makes it one rank of
    a data-parallel run (module docstring); ``device`` is then the rank's
    card (``"cuda"``: the current one) or the CPU under gloo."""

    def __init__(self, cfg: RunConfig, posenet: Optional[PoseNet] = None,
                 refiner: Optional[PoseRefineNet] = None,
                 dataset_factory: Callable = build_dataset, device=None,
                 shard_batch: Optional[Callable] = None):
        check_ported(cfg, device)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sharding = None
        if shard_batch is not None:
            self.sharding = getattr(shard_batch, "sharding", None)
            if self.sharding is None:
                raise ValueError("shard_batch must come from "
                                 "parallel.make_shard_batch_fn")
            if cfg.batch_size % self.sharding.size:
                raise ValueError(
                    f"batch_size {cfg.batch_size} does not split over "
                    f"{self.sharding.size} ranks")
        # rank 0 of the data axis (or the one process) writes the files
        self.writer = self.sharding is None or self.sharding.index == 0
        dtype = torch.bfloat16 if cfg.bf16_compute else None
        self.posenet = posenet or PoseNet(num_obj=cfg.num_objects,
                                          dtype=dtype,
                                          remat_cnn=cfg.remat_cnn,
                                          **cfg.decoder_flags())
        self.refiner = refiner or PoseRefineNet(num_obj=cfg.num_objects,
                                                dtype=dtype)
        self.dataset_factory = dataset_factory
        self.curriculum = Curriculum(lr=cfg.lr, w=cfg.w)
        self.state = None
        self.restart_requested = False
        if self.writer:
            self.metrics = MetricsWriter(
                os.path.join(cfg.log_dir, "metrics.jsonl"))
            self.logger = setup_logger(
                "train", os.path.join(cfg.log_dir, "train_log.txt"))
        else:
            self.metrics = _NoMetrics()
            self.logger = setup_logger("train", None, level=logging.WARNING)
        self._use_adds = bool(cfg.sym_list)

    # -- setup ------------------------------------------------------------

    def setup(self, resume: str | None = None) -> None:
        cfg = self.cfg
        if resume:
            # read the curriculum FIRST so the step's optimizer is the
            # checkpoint's phase; its moments load into that optimizer
            self.curriculum = peek_curriculum(resume)
        self._build_data(refine=self.curriculum.refine_started)
        self.state = create_train_state(self.posenet, self.refiner,
                                        self.curriculum.lr, cfg.seed,
                                        self.device)
        self._rebuild_steps()
        if resume:
            self.state, self.curriculum, _ = load_checkpoint(
                resume, self.state, restore_opt=True)
            self.logger.info(f"resumed from {resume} at epoch "
                             f"{self.curriculum.epoch}")
        if self.sharding is not None:
            replicate([*self.posenet.parameters(), *self.posenet.buffers(),
                       *self.refiner.parameters(), *self.refiner.buffers()],
                      self.sharding, in_place=True)

    def param_digest(self) -> str:
        """SHA-256 of both networks' parameters and buffers, in
        ``state_dict`` order: equal on data-parallel ranks in lockstep."""
        h = hashlib.sha256()
        for module in (self.posenet, self.refiner):
            for v in module.state_dict().values():
                h.update(v.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` of this process, or of any rank of a data-parallel run
        (a collective: every rank calls it at the same point)."""
        if self.sharding is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.sharding.group)
        return bool(t.item())

    def _build_data(self, refine: bool) -> None:
        cfg = self.cfg
        # the phase rebuild changes sample shapes (YCB mesh 500 -> 2600):
        # retire the old loaders' fork workers before the shapes move
        self.close()
        self.train_ds = self.dataset_factory(cfg, "train", refine)
        self.test_ds = self.dataset_factory(cfg, "test", refine)
        shard = None if self.sharding is None \
            else (self.sharding.index, self.sharding.size)
        self.train_loader = BatchLoader(
            self.train_ds, cfg.batch_size, shuffle=True,
            num_workers=cfg.num_workers, seed=cfg.seed,
            worker_mode=cfg.worker_mode, shard=shard)
        self.test_loader = BatchLoader(
            self.test_ds, cfg.batch_size, shuffle=False,
            num_workers=cfg.num_workers, drop_last=False, seed=cfg.seed,
            worker_mode=cfg.worker_mode, shard=shard)

    def _rebuild_steps(self) -> None:
        """The current phase's steps; each train step makes a fresh Adam
        over its module at the curriculum's learning rate."""
        cfg, cur = self.cfg, self.curriculum
        self.state.optimizer.param_groups[0]["lr"] = cur.lr
        if cur.refine_started:
            self.train_step = make_refine_train_step(
                self.state, cfg.refine_iters, cfg.grad_accum, self.sharding)
        else:
            self.train_step = make_pose_train_step(
                self.state, self._use_adds, cfg.grad_accum, self.sharding)
        self.eval_step = make_eval_step(
            self.state, cfg.refine_iters if cur.refine_started else 0,
            self._use_adds)

    # -- epochs -----------------------------------------------------------

    def train_epoch(self) -> float:
        cfg, cur = self.cfg, self.curriculum
        t0 = time.time()
        dis_sum = None       # on the device; read only at log points
        count, wait = 0, 0.0
        # resume exactly where the checkpoint left off: (repetition, batch)
        first_rep = cur.rep_in_epoch
        for rep in range(first_rep, cfg.repeat_epoch):
            cur.rep_in_epoch = rep
            start = cur.batch_in_epoch if rep == first_rep else 0
            cur.batch_in_epoch = start
            it = PrefetchIterator(
                self.train_loader.epoch(cur.epoch * cfg.repeat_epoch + rep,
                                        start_batch=start))
            while True:
                t_wait = time.perf_counter()
                batch = next(it, None)
                wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                m = self.train_step(to_device(batch, self.device), cur.w)
                cur.batch_in_epoch += 1
                if cur.refine_started:
                    cur.refine_steps += 1
                dis_sum = m["dis"] if dis_sum is None else dis_sum + m["dis"]
                count += 1
                if count % 50 == 0:
                    self.logger.info(
                        f"epoch {cur.epoch} batch {count} "
                        f"avg_dis {float(dis_sum) / count:.5f} "
                        f"({time.time() - t0:.1f}s)")
                if count % cfg.checkpoint_every_steps == 0:
                    self._save("current")
                    self._check_rss()
            cur.batch_in_epoch = 0
        cur.rep_in_epoch = 0
        avg = float(dis_sum) / count if count else 0.0
        self.metrics.write(kind="train_epoch", epoch=cur.epoch, avg_dis=avg,
                           seconds=time.time() - t0, phase=self._phase(),
                           steps=count, input_wait_s=wait)
        return avg

    def test_epoch(self) -> float:
        cur = self.curriculum
        t0 = time.time()
        # on the device; per-batch float32 sums added in float64
        dis_sum = torch.zeros((), dtype=torch.float64, device=self.device)
        count = torch.zeros((), dtype=torch.float64, device=self.device)
        for batch in PrefetchIterator(self.test_loader.epoch(0)):
            dis, valid = self.eval_step(to_device(batch, self.device), cur.w)
            dis_sum += (dis * valid).sum()
            count += valid.sum()
        if self.sharding is not None:
            # the whole test split's average: every rank takes the same gate
            both = torch.stack([dis_sum, count])
            dist.all_reduce(both, group=self.sharding.group)
            dis_sum, count = both[0], both[1]
        count = int(count)
        if count == 0:
            # an empty or all-invalid test split must not read as a perfect
            # score: 0.0 would fire the curriculum gates
            self.logger.warning(
                f"epoch {cur.epoch} TEST had no valid samples; "
                "skipping best/curriculum updates")
            return float("inf")
        avg = float(dis_sum) / count
        self.metrics.write(kind="test_epoch", epoch=cur.epoch, avg_dis=avg,
                           seconds=time.time() - t0, phase=self._phase())
        self.logger.info(f"epoch {cur.epoch} TEST avg_dis {avg:.5f}")
        return avg

    def _phase(self) -> str:
        return "refine" if self.curriculum.refine_started else "pose"

    def close(self) -> None:
        """Shut down the loaders' fork workers. Call it before an
        exec-restart: ``os.execv`` runs no atexit handler or ``__del__``
        and would orphan them."""
        for name in ("train_loader", "test_loader"):
            loader = getattr(self, name, None)
            if loader is not None:
                loader.close()

    def _save(self, tag: str) -> None:
        """Rank 0 writes the checkpoint; the other ranks wait for it."""
        if self.writer:
            path = os.path.join(self.cfg.out_dir, f"checkpoint_{tag}")
            save_checkpoint(path, self.state, self.curriculum, self.cfg)
        if self.sharding is not None:
            dist.barrier(group=self.sharding.group)

    def _check_rss(self) -> None:
        """The RSS guard (``cfg.rss_restart_gb``), called right after a
        'current' save so a restart resumes at most
        ``checkpoint_every_steps`` steps back. Data-parallel ranks restart
        together when any one crosses the limit."""
        limit = self.cfg.rss_restart_gb
        if not limit:
            return
        rss = _rss_gb()
        if rss > limit:
            self.logger.warning(
                f"process RSS {rss:.1f} GiB > rss_restart_gb={limit}: "
                "requesting exec-restart (state just saved to "
                "checkpoint_current)")
        if self._any_rank(rss > limit):
            raise RestartRequested()

    # -- curriculum -------------------------------------------------------

    def run(self, max_epochs: int | None = None) -> None:
        """Train epochs 1..cfg.nepoch inclusive (``nepoch`` is the number
        of epochs trained; resuming does not extend the run).
        ``max_epochs`` caps the epochs this call adds."""
        cfg, cur = self.cfg, self.curriculum
        end_epoch = cfg.nepoch + 1
        if max_epochs is not None:
            end_epoch = min(end_epoch, cur.epoch + max_epochs)
        while cur.epoch < end_epoch:
            try:
                self.train_epoch()
            except RestartRequested:
                # 'current' was saved by the step-cadence save just before
                self.restart_requested = True
                return
            test_dis = self.test_epoch()

            if test_dis <= cur.best_test:
                cur.best_test = test_dis
                self._save("best_" + self._phase())
                self.logger.info(
                    f"epoch {cur.epoch} BEST {self._phase()} model saved "
                    f"(dis {test_dis:.5f})")

            # lr / w decay gate (tools/train.py:219-223), with a fresh Adam
            if cur.best_test < cfg.decay_margin and not cur.decay_started:
                cur.decay_started = True
                cur.lr *= cfg.lr_rate
                cur.w *= cfg.w_rate
                self._rebuild_steps()
                self.logger.info(f"decay triggered: lr={cur.lr} w={cur.w}")

            # refiner phase gate (tools/train.py:225-251)
            if cur.best_test < cfg.refine_margin and not cur.refine_started:
                cur.refine_started = True
                cur.best_test = float("inf")
                self._build_data(refine=True)
                self._rebuild_steps()
                self.logger.info("refinement phase started")

            cur.epoch += 1
            # the end-of-epoch resume point (the step cadence may never
            # fire on a small dataset)
            self._save("current")
            try:
                self._check_rss()
            except RestartRequested:
                self.restart_requested = True
                return

            # `touch <out_dir>/STOP` ends the run at this epoch boundary
            # with best / current saved; the marker is consumed so a resume
            # into the same out_dir does not stop at once
            # (data-parallel ranks stop together when any one sees it)
            stop_file = os.path.join(cfg.out_dir, "STOP")
            if self._any_rank(os.path.exists(stop_file)):
                self.logger.info(
                    f"stop requested ({stop_file}); ending at epoch "
                    f"{cur.epoch - 1} — resume with --resume "
                    f"{os.path.join(cfg.out_dir, 'checkpoint_current')}")
                if self.writer:
                    try:
                        os.remove(stop_file)
                    except OSError:
                        pass
                break
