"""Where a YCB training sample's host time goes: assemble the samples of a
synthetic 21-class YCB root (the data path of ``chip_smoke.py`` [4f]: N=1000,
192 px crops, noise on) in one process under ``cProfile``, after one warm
epoch, and print the mean ms per sample and each top function's share,
once through the host library (``densefusion_tpu_torch.native``, the
readers' default) and once with it switched off (the numpy plain path).

    python examples/data_profile.py [out.json]

Host-only (no card needed). The profiler's per-call cost inflates Python-
heavy functions against numpy's and the library's, so the shares rank the
costs; the mean is measured again with the profiler off.
"""

from __future__ import annotations

import contextlib
import cProfile
import json
import os
import pstats
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@contextlib.contextmanager
def host_library(on: bool):
    """The readers' host library on (as built) or off (``native._load``
    finds none, so every call site takes its numpy plain version)."""
    from densefusion_tpu_torch import native

    real = native._load
    if not on:
        native._load = lambda: None
    try:
        yield
    finally:
        native._load = real


def profile_reader(root: str) -> dict:
    """Mean warm ms per sample over two epochs, then the top functions of
    two more epochs under ``cProfile``, on a fresh reader of ``root``."""
    from densefusion_tpu_torch.data import YCBDataset

    ds = YCBDataset(root, "train", num_points=1000, crop_size=192)
    for i in range(len(ds)):        # warm the decoded-frame cache
        ds[i]
    t0 = time.perf_counter()
    for epoch in (1, 2):
        ds.set_epoch(epoch)
        for i in range(len(ds)):
            ds[i]
    n = 2 * len(ds)
    ms = 1e3 * (time.perf_counter() - t0) / n
    prof = cProfile.Profile()
    prof.enable()
    for epoch in (3, 4):
        ds.set_epoch(epoch)
        for i in range(len(ds)):
            ds[i]
    prof.disable()
    stats = pstats.Stats(prof)
    total = stats.total_tt
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][3])[:12]
    rows = [{"function": f"{os.path.basename(f)}:{line}({name})",
             "cumulative_share": ct / total, "own_share": tt / total}
            for (f, line, name), (_, _, tt, ct, _) in top]
    return {"ms_per_sample_warm": ms, "samples": n, "profiled_s": total,
            "top_by_cumulative": rows}


def main(out_path: str | None = None) -> dict:
    from densefusion_tpu_torch import native
    from densefusion_tpu_torch.data import generate_ycb_style_dataset

    with tempfile.TemporaryDirectory(prefix="ycb_profile_") as root:
        generate_ycb_style_dataset(root, n_classes=21, n_real=16, n_syn=16,
                                   n_test=1, seed=0)
        native.available()          # build (first use) before timing
        result = {}
        for name, on in (("library", True), ("numpy", False)):
            with host_library(on):
                result[name] = profile_reader(root)
    print(json.dumps(result, indent=2))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
