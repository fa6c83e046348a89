"""SegNet training CLI (counterpart of ``densefusion_tpu/cli/train_seg.py``:
the same options, defaults and files, plus ``--device``).

``--format ycb`` (default) trains the reference's 22-class YCB-Video
segmenter from ``-color.png`` / ``-label.png`` frames. ``--format linemod``
trains one multi-object segmenter over a Linemod_preprocessed tree (labels
are the raw object ids) whose masks, written by ``cli.segment
--binary_class <obj>``, are the ``segnet_results/`` that
``LineModDataset(mode="eval")`` and ``cli.eval_linemod --mode eval`` read.

Example::

    python -m densefusion_tpu_torch.cli.train_seg --format linemod \\
        --dataset_root /data/Linemod_preprocessed --out_dir segnet

Runs on the card unless given ``--device cpu``. Each epoch writes
``segnet_latest.msgpack`` (parameters, BN statistics, Adam, epoch, best
test loss) and, when the test loss improves, ``segnet_best.msgpack``, both
in the JAX trainer's format: a run of either package resumes the other's
(``--resume``). Each epoch appends a ``seg_epoch`` record to
``<log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--format", default="ycb", choices=["ycb", "linemod"],
                   dest="fmt")
    p.add_argument("--objlist", type=int, nargs="*", default=None,
                   help="linemod format: subset of object ids (default all)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: 3 (ycb, the reference recipe), 8 (linemod)")
    p.add_argument("--n_epochs", type=int, default=600)
    p.add_argument("--lr", type=float, default=None,
                   help="default: 1e-4 (ycb, the reference's recipe at its "
                        "600-epoch budget), 5e-4 (linemod: 1e-4 stays all-"
                        "background at short budgets)")
    p.add_argument("--fg_weight", type=float, default=None,
                   help="CE weight on foreground pixels. Default: 1.0 for "
                        "ycb (the reference's unweighted CE), 30.0 for "
                        "linemod, whose objects cover a few %% of the frame")
    p.add_argument("--workers", type=int, default=4,
                   help="loader threads")
    p.add_argument("--num_classes", type=int, default=None,
                   help="default: 22 for ycb, max(objlist)+1 for linemod")
    p.add_argument("--out_dir", default="trained_models/segnet")
    p.add_argument("--log_dir", default="experiments/logs/segnet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from <out_dir>/segnet_latest.msgpack")
    p.add_argument("--rss_restart_gb", type=float, default=48.0,
                   help="exec-restart with --resume when the process's RSS "
                        "exceeds this many GiB at an epoch boundary (the "
                        "state is saved first); 0 disables")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def resolve_recipe_defaults(args):
    """Format-aware recipe defaults: the reference's lr 1e-4 and unweighted
    CE assume its 600-epoch YCB budget; the LineMOD segmenter takes lr
    5e-4, fg_weight 30 and batch 8 to learn foreground at short budgets.
    Explicit flags win."""
    if args.fmt == "linemod":
        defaults = dict(batch_size=8, lr=5e-4, fg_weight=30.0)
    else:
        defaults = dict(batch_size=3, lr=1e-4, fg_weight=1.0)
    for k, v in defaults.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    return args


def _rss_gb() -> float | None:
    try:
        with open("/proc/self/status") as f:
            return next(int(ln.split()[1]) / 1048576.0 for ln in f
                        if ln.startswith("VmRSS"))
    except (OSError, StopIteration):
        return None


def main(argv=None) -> dict:
    """Train; returns ``{"epochs": the seg_epoch records of this run (each
    with its wall seconds), "state": the SegTrainState}``."""
    args = resolve_recipe_defaults(build_parser().parse_args(argv))
    import numpy as np
    import torch

    from densefusion_tpu_torch.data import (
        BatchLoader, LinemodSegDataset, PrefetchIterator, SegDataset,
        collate_seg, seg_to_device,
    )
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import (
        create_seg_train_state, load_seg_latest, make_seg_eval_step,
        make_seg_train_step, save_seg_latest, save_segnet,
    )
    from densefusion_tpu_torch.utils.logging import MetricsWriter, setup_logger

    if args.fmt == "linemod":
        train_ds = LinemodSegDataset(args.dataset_root, "train",
                                     objlist=args.objlist, seed=args.seed)
        test_ds = LinemodSegDataset(args.dataset_root, "test",
                                    objlist=args.objlist, seed=args.seed)
        num_classes = args.num_classes or train_ds.num_classes
    else:
        train_ds = SegDataset(args.dataset_root, "train", seed=args.seed)
        test_ds = SegDataset(args.dataset_root, "test", seed=args.seed)
        num_classes = args.num_classes or 22
    state = create_seg_train_state(SegNet(num_classes=num_classes),
                                   lr=args.lr, seed=args.seed,
                                   device=args.device)
    dev = next(state.segnet.parameters()).device
    os.makedirs(args.out_dir, exist_ok=True)
    logger = setup_logger("train_seg",
                          os.path.join(args.log_dir, "train_log.txt"))
    metrics = MetricsWriter(os.path.join(args.log_dir, "metrics.jsonl"))
    train_loader = BatchLoader(train_ds, args.batch_size,
                               collate_fn=collate_seg,
                               num_workers=args.workers, seed=args.seed)
    test_loader = BatchLoader(test_ds, args.batch_size, shuffle=False,
                              collate_fn=collate_seg, drop_last=False,
                              num_workers=args.workers)
    train_step = make_seg_train_step(state, fg_weight=args.fg_weight)
    eval_step = make_seg_eval_step(state.segnet, fg_weight=args.fg_weight)

    latest_path = os.path.join(args.out_dir, "segnet_latest.msgpack")
    best, start_epoch = float(np.inf), 1
    if args.resume and os.path.exists(latest_path):
        epoch, best = load_seg_latest(latest_path, state)
        start_epoch = epoch + 1
        logger.info(f"resumed from {latest_path} at epoch {start_epoch} "
                    f"(best {best:.4f})")

    def check_rss_restart(epoch):
        """The leak guard of cli.train; this epoch's state is already in
        segnet_latest.msgpack when it fires. An embedded call (argv given)
        is never restarted."""
        if not args.rss_restart_gb or argv is not None:
            return
        rss_gb = _rss_gb()
        if rss_gb is None or rss_gb <= args.rss_restart_gb:
            return
        logger.warning(f"process RSS {rss_gb:.1f} GiB > rss_restart_gb="
                       f"{args.rss_restart_gb}: exec-restarting with "
                       f"--resume at epoch {epoch + 1}")
        cmd = list(sys.argv)
        if "--resume" not in cmd:
            cmd.append("--resume")
        from densefusion_tpu_torch.utils.restart import reexec_self
        reexec_self(cmd)

    records = []
    for epoch in range(start_epoch, args.n_epochs + 1):
        t0 = time.perf_counter()
        losses = []
        for batch in PrefetchIterator(train_loader.epoch(epoch)):
            losses.append(train_step(*seg_to_device(batch, dev)))
        test_metrics = []
        for batch in PrefetchIterator(test_loader.epoch(0)):
            test_metrics.append(torch.stack(
                eval_step(*seg_to_device(batch, dev))))
        # one sync per epoch; float32 means, as the JAX CLI takes them
        tr = (float(np.mean(torch.stack(losses).cpu().numpy()))
              if losses else float("nan"))
        te, acc, iou = (float(np.mean(col)) for col in np.ascontiguousarray(
            torch.stack(test_metrics).cpu().numpy().T))
        seconds = time.perf_counter() - t0
        logger.info(f"epoch {epoch} train {tr:.4f} test {te:.4f} "
                    f"pix-acc {acc:.4f} fg-iou {iou:.4f} ({seconds:.2f} s)")
        record = dict(kind="seg_epoch", epoch=epoch, train_loss=tr,
                      test_loss=te, pixel_acc=acc, fg_iou=iou,
                      seconds=seconds)
        metrics.write(**record)
        records.append(record)
        if te < best:  # the reference's best-checkpoint policy
            best = te
            save_segnet(os.path.join(args.out_dir, "segnet_best.msgpack"),
                        state.segnet)
            logger.info(f"epoch {epoch} BEST saved ({te:.4f})")
        save_seg_latest(latest_path, state, epoch, best)
        check_rss_restart(epoch)
    return {"epochs": records, "state": state}


if __name__ == "__main__":
    main()
