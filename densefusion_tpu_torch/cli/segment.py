"""Segmentation inference CLI (counterpart of
``densefusion_tpu/cli/segment.py``): run a trained SegNet over frames and
write label PNGs.

It fills the role of the reference's precomputed ``segnet_results/`` masks,
which LineMOD's eval mode reads (``datasets/linemod/dataset.py:57-58``):
with ``--binary_class`` the output is a 255/0 mask for one class, named
``{stem}_label.png`` as ``LineModDataset(mode="eval")`` reads it;
otherwise the argmax label map is written (YCB-style).

Example::

    python -m densefusion_tpu_torch.cli.segment \\
        --checkpoint trained_models/segnet/segnet_best.msgpack \\
        --images '/data/lm/data/01/rgb/*.png' \\
        --out_dir /data/lm/segnet_results/01_label --binary_class 1

Runs on the card unless given ``--device cpu``; reads the JAX trainer's
``segnet_best.msgpack`` as well as the port's.
"""

from __future__ import annotations

import argparse
import glob
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="segnet_best.msgpack from cli.train_seg")
    p.add_argument("--images", required=True,
                   help="glob of input RGB frames")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_classes", type=int, default=22)
    p.add_argument("--binary_class", type=int, default=None,
                   help="write a 255/0 mask for this class id instead of the "
                        "full label map")
    p.add_argument("--class_vs_bg", action="store_true",
                   help="with --binary_class: mask where the class's logit "
                        "beats background's (instead of the full argmax): "
                        "the query when the sequence's object is known, as "
                        "in the LineMOD protocol (one object per test "
                        "sequence), so pixels contested only between this "
                        "object and background do not go to a third class")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--list", dest="list_file", default=None,
                   help="text file of frame ids; only globbed images whose "
                        "basename stem matches an id (as-is or %%04d) are "
                        "segmented")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> int:
    """Write the label maps; returns how many were written."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.class_vs_bg and args.binary_class is None:
        p.error("--class_vs_bg requires --binary_class (it selects WHICH "
                "class's logit is compared against background)")
    import numpy as np
    import torch
    from PIL import Image

    from densefusion_tpu_torch.data.schema import normalize_image
    from densefusion_tpu_torch.device import resolve_device
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import load_segnet

    dev = resolve_device(args.device)
    paths = sorted(glob.glob(args.images))
    if args.list_file:
        with open(args.list_file) as f:
            ids = {ln.strip() for ln in f if ln.strip()}
        ids |= {f"{int(i):04d}" for i in ids if i.isdigit()}
        paths = [p_ for p_ in paths
                 if os.path.splitext(os.path.basename(p_))[0] in ids]
    if not paths:
        raise SystemExit(f"no images match {args.images!r}")
    os.makedirs(args.out_dir, exist_ok=True)

    segnet = load_segnet(args.checkpoint,
                         SegNet(num_classes=args.num_classes)).to(dev).eval()

    @torch.no_grad()
    def predict(rgb: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(rgb, device=dev).permute(0, 3, 1, 2)
        logits = segnet(x.contiguous())
        if args.class_vs_bg:
            # where p(class) > p(background); other classes do not vote
            return (logits[:, args.binary_class] > logits[:, 0]).cpu().numpy()
        return logits.argmax(1).cpu().numpy()

    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        rgb = np.stack([normalize_image(np.array(Image.open(p_))[..., :3])
                        for p_ in chunk])
        for p_, lab in zip(chunk, predict(rgb)):
            stem = os.path.splitext(os.path.basename(p_))[0]
            if args.binary_class is not None:
                hit = lab if lab.dtype == bool else (lab == args.binary_class)
                out = (hit * 255).astype(np.uint8)
            else:
                out = lab.astype(np.uint8)
            Image.fromarray(out).save(
                os.path.join(args.out_dir, f"{stem}_label.png"))
    print(f"wrote {len(paths)} label maps to {args.out_dir}")
    return len(paths)


if __name__ == "__main__":
    main()
