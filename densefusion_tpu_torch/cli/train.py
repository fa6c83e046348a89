"""Pose-estimation training CLI (counterpart of
``densefusion_tpu/cli/train.py``: the same options and defaults, plus
``--device``).

Example::

    python -m densefusion_tpu_torch.cli.train --dataset ycb \\
        --dataset_root /data/YCB_Video_Dataset --batch_size 8

Runs on the card unless given ``--device cpu``. Checkpoints go to
``<out_dir>/<dataset>/checkpoint_{best_pose,best_refine,current}`` in the JAX
package's format. ``--bf16`` trains with bf16 compute (float32 parameters,
Adam state and checkpoints) and ``--remat_cnn`` recomputes the CNN in the
backward pass. ``--trace_dir`` writes a ``torch.profiler`` trace of the
run (``utils/profiling.py`` ``trace_context``); the port's spans
(``train.step`` and its forward, loss, backward and optimizer, the
model's ``posenet.cnn`` and ``posenet.fusion``) show in it as ranges and
are kept in memory (``utils/profiling.py`` ``spans``) while it runs.

``--data_parallel`` runs one rank per process, started by a launcher that
sets ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (NCCL on
the cards; gloo with ``--device cpu``); ``--batch_size`` is the global
batch, which the world size must divide::

    torchrun --nproc_per_node=<cards> -m densefusion_tpu_torch.cli.train \\
        --data_parallel --dataset ycb --dataset_root /data/YCB_Video_Dataset
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="linemod",
                   choices=["ycb", "linemod", "cad"])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--worker_mode", default="process",
                   choices=["process", "thread"],
                   help="loader workers: fork processes + shared-memory "
                        "sample ring (linux) or a thread pool")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_rate", type=float, default=0.1)
    p.add_argument("--w", type=float, default=0.015)
    p.add_argument("--w_rate", type=float, default=0.1)
    p.add_argument("--decay_margin", type=float, default=0.03)
    p.add_argument("--refine_margin", type=float, default=0.02)
    p.add_argument("--noise_trans", type=float, default=0.03)
    p.add_argument("--iteration", type=int, default=2,
                   help="refinement iterations")
    p.add_argument("--nepoch", type=int, default=500)
    p.add_argument("--repeat_epoch", type=int, default=None,
                   help="override the dataset preset's per-epoch repeat count")
    p.add_argument("--num_objects", type=int, default=None,
                   help="override the dataset preset's object count (e.g. a "
                        "synthetic YCB-format root with fewer classes)")
    p.add_argument("--crop_size", type=int, default=192)
    p.add_argument("--num_points", type=int, default=None,
                   help="override the dataset preset's cloud size")
    p.add_argument("--objlist", type=int, nargs="*", default=None,
                   help="train on a subset of dataset object ids "
                        "(linemod/cad); heads are sized to the subset")
    p.add_argument("--resume", default="",
                   help="checkpoint directory to resume from")
    p.add_argument("--rss_restart_gb", type=float, default=48.0,
                   help="save + exec-restart (with --resume) when process "
                        "RSS exceeds this many GiB; 0 disables")
    p.add_argument("--out_dir", default="trained_models")
    p.add_argument("--log_dir", default="experiments/logs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", action="store_true",
                   help="shard batches over all ranks of a launcher "
                        "(torchrun: one process per card)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (float32 parameters and outputs)")
    p.add_argument("--remat_cnn", action="store_true",
                   help="recompute the CNN in backward (lower peak "
                        "activation memory)")
    p.add_argument("--trace_dir", default=None,
                   help="capture a torch.profiler trace (TensorBoard) of "
                        "the run")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from densefusion_tpu_torch.train import Trainer
    from densefusion_tpu_torch.utils.config import RunConfig, check_ported
    from densefusion_tpu_torch.utils.profiling import trace_context

    overrides = {}
    if args.repeat_epoch is not None:
        overrides["repeat_epoch"] = args.repeat_epoch
    if args.num_objects is not None:
        overrides["num_objects"] = args.num_objects
    if args.num_points is not None:
        overrides["num_points"] = args.num_points
    if args.objlist:
        overrides["objlist"] = tuple(args.objlist)
        overrides.setdefault("num_objects", len(args.objlist))
        if args.dataset == "linemod":
            # sym_list = POSITIONS of eggbox/glue within the subset
            from densefusion_tpu_torch.data.linemod import LINEMOD_SYM_IDS
            overrides["sym_list"] = tuple(
                args.objlist.index(i) for i in LINEMOD_SYM_IDS
                if i in args.objlist)
    cfg = RunConfig.preset(
        args.dataset,
        **overrides,
        dataset_root=args.dataset_root, batch_size=args.batch_size,
        grad_accum=args.grad_accum, num_workers=args.workers,
        worker_mode=args.worker_mode, lr=args.lr,
        lr_rate=args.lr_rate, w=args.w, w_rate=args.w_rate,
        decay_margin=args.decay_margin, refine_margin=args.refine_margin,
        noise_trans=args.noise_trans, refine_iters=args.iteration,
        nepoch=args.nepoch, crop_size=args.crop_size, seed=args.seed,
        rss_restart_gb=args.rss_restart_gb,
        bf16_compute=args.bf16,
        remat_cnn=args.remat_cnn,
        out_dir=f"{args.out_dir}/{args.dataset}",
        log_dir=f"{args.log_dir}/{args.dataset}",
    )
    check_ported(cfg, args.device)

    if not os.path.isdir(args.dataset_root):
        raise SystemExit(
            f"error: dataset root not found: {args.dataset_root!r} "
            f"(expected the layout described in docs/DATA.md)")

    shard_batch, own_group = None, False
    if args.data_parallel:
        import torch.distributed as dist

        from densefusion_tpu_torch.parallel import (
            initialize_distributed, make_mesh, make_shard_batch_fn,
        )
        own_group = not dist.is_initialized()
        initialize_distributed(device=args.device)
        shard_batch = make_shard_batch_fn(make_mesh(device=args.device))

    trainer = Trainer(cfg, device=args.device, shard_batch=shard_batch)
    try:
        trainer.setup(resume=args.resume or None)
        with trace_context(args.trace_dir):
            trainer.run()
        if shard_batch is not None:
            # every rank's parameters, for the check that the ranks agree
            print(f"rank {shard_batch.sharding.index} of "
                  f"{shard_batch.sharding.size}: parameters sha256 "
                  f"{trainer.param_digest()}", flush=True)
    finally:
        trainer.close()   # the loaders' fork workers; the state stays
        if own_group:
            dist.destroy_process_group()

    if trainer.restart_requested:
        # RSS-guard exec-restart: the same interpreter and argv, resuming
        # from the checkpoint saved just before the check fired. exec (not
        # fork) so the whole address space returns to the OS. Only when argv
        # came from the command line: an embedding caller (tests, scripts)
        # gets the flag to act on instead.
        current = os.path.join(cfg.out_dir, "checkpoint_current")
        if argv is not None:
            print(f"rss_restart_gb exceeded; state saved to {current} — "
                  "embedded call, not exec-restarting", flush=True)
            return trainer
        cmd = list(sys.argv)
        if "--resume" in cmd:
            cmd[cmd.index("--resume") + 1] = current
        else:
            cmd += ["--resume", current]
        print(f"exec-restarting: {' '.join(cmd)}", flush=True)
        from densefusion_tpu_torch.utils.restart import reexec_self
        reexec_self(cmd)
    return trainer


if __name__ == "__main__":
    main()
