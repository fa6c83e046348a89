"""Export a checkpoint's inference program as a ``torch.export`` artifact
(counterpart of ``densefusion_tpu/cli/export_stablehlo.py``; the artifact
is a ``.pt2`` archive, not StableHLO, hence the name).

The artifact holds the whole estimate + refine program with the
parameters as its state, for one device (``--device`` takes the place of
the JAX CLI's ``--platforms``) and a fixed batch (export several for a
size ladder). On the card the decoder's phase convolutions are the
registered op that launches kernel 6, so loading it
(``densefusion_tpu_torch.export.load_exported``) needs this package and
its kernels' sources; see ``densefusion_tpu_torch/export.py``.

Example::

    python -m densefusion_tpu_torch.cli.export_program \\
        --checkpoint trained_models/linemod/checkpoint_best_refine \\
        --batch 8 --out posenet_b8.pt2
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iterations", type=int, default=2,
                   help="refinement iterations baked into the graph")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default=None,
                   help="the artifact's device: cuda (the default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from densefusion_tpu_torch.export import export_inference

    if not os.path.isdir(args.checkpoint):
        raise SystemExit(
            f"error: checkpoint directory not found: {args.checkpoint!r}")
    blob = export_inference(args.checkpoint, batch=args.batch,
                            refine_iters=args.iterations, bf16=args.bf16,
                            device=args.device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported -> {args.out} ({len(blob) / 2 ** 20:.1f} MiB, "
          f"batch={args.batch}, iterations={args.iterations})")


if __name__ == "__main__":
    main()
