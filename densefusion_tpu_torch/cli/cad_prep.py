"""Standalone customCAD dataset prep tools for a real Unity dump
(counterpart of ``densefusion_tpu/cli/cad_prep.py``; host-side, no device).

Capability parity with ``datasets/customCAD/mask_generator.py`` and
``train_test_generator.py``:

* ``masks`` — for every ``data/<obj>/depth/*.png``, write a 65535-valued
  uint16 bounding-box-rectangle mask of the non-background pixels
  (background = the depth image's max value; ``mask_generator.py:21-33``)
  into ``data/<obj>/mask/``, named by the file's trailing 8 characters.
* ``split`` — shuffle each object's frame numbers (parsed between ``_`` and
  ``.`` like the reference) into train.txt / test.txt at ``train_percent``
  (``train_test_generator.py:27-35``), seedable for reproducibility.

Example::

    python -m densefusion_tpu_torch.cli.cad_prep masks --root dataset_processed
    python -m densefusion_tpu_torch.cli.cad_prep split --root dataset_processed \
        --train_percent 80 --seed 0
"""

from __future__ import annotations

import argparse
import os


def generate_masks(root: str) -> int:
    """Returns the number of masks written."""
    import numpy as np
    from PIL import Image

    data_dir = os.path.join(root, "data")
    count = 0
    for obj_dir in sorted(os.listdir(data_dir)):
        depth_dir = os.path.join(data_dir, obj_dir, "depth")
        mask_dir = os.path.join(data_dir, obj_dir, "mask")
        if not os.path.isdir(depth_dir):
            continue
        os.makedirs(mask_dir, exist_ok=True)
        for image_file in sorted(os.listdir(depth_dir)):
            with Image.open(os.path.join(depth_dir, image_file)) as im:
                img = np.array(im)
            fg = np.where(img != img.max())
            if np.sum(fg) > 0:
                bbox = np.array([[fg[0].min(), fg[1].min()],
                                 [fg[0].max(), fg[1].max()]])
            else:
                bbox = np.zeros((2, 2), np.int64)
            mask = np.zeros(img.shape, np.uint16)
            # exclusive upper edge, as the reference slices (quirk kept)
            mask[bbox[0][0]:bbox[1][0], bbox[0][1]:bbox[1][1]] = 65535
            out_name = image_file[-8:]  # mask_generator.py:30
            Image.fromarray(mask).save(os.path.join(mask_dir, out_name))
            count += 1
    return count


def generate_split(root: str, train_percent: float = 80.0,
                   seed: int | None = None) -> dict:
    """Returns {obj_dir: (n_train, n_test)}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "data")
    out = {}
    for obj_dir in sorted(os.listdir(data_dir)):
        depth_dir = os.path.join(data_dir, obj_dir, "depth")
        if not os.path.isdir(depth_dir):
            continue
        files = list(os.listdir(depth_dir))
        nums = [int(x[x.find("_") + 1:x.find(".")]) for x in files]
        order = rng.permutation(len(nums))
        nums = [nums[i] for i in order]
        n_train = int(len(nums) / 100.0 * train_percent)
        base = os.path.join(data_dir, obj_dir)
        with open(os.path.join(base, "train.txt"), "w") as f:
            f.writelines(f"{n}\n" for n in nums[:n_train])
        with open(os.path.join(base, "test.txt"), "w") as f:
            f.writelines(f"{n}\n" for n in nums[n_train:])
        out[obj_dir] = (n_train, len(nums) - n_train)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("masks", help="bbox-rectangle masks from depth")
    pm.add_argument("--root", required=True)
    ps = sub.add_parser("split", help="train/test frame-number split")
    ps.add_argument("--root", required=True)
    ps.add_argument("--train_percent", type=float, default=80.0)
    ps.add_argument("--seed", type=int, default=None)
    pa = sub.add_parser("all", help="masks then split "
                                    "(the reference's prep_dataset.py)")
    pa.add_argument("--root", required=True)
    pa.add_argument("--train_percent", type=float, default=80.0)
    pa.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    if args.cmd in ("masks", "all"):
        n = generate_masks(args.root)
        print(f"wrote {n} masks")
        if args.cmd == "masks":
            return n
    result = generate_split(args.root, args.train_percent, args.seed)
    for obj_dir, (n_tr, n_te) in result.items():
        print(f"{obj_dir}: {n_tr} train / {n_te} test")
    return result


if __name__ == "__main__":
    main()
