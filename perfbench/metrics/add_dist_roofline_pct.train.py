"""Kernels 1 and 2 (``csrc/add_dist.cu``: ``paired_dist``, then
``min_partial`` and its ``finalize``) in the traced segment of a training
cell: their summed bound over their summed device time. Each phase-1 step
launches the paired kernel over the rows without symmetry and the min
kernel over the symmetric ones, whose number the traffic fixes
(``objects: symmetric_first``)."""

from perfbench import counts, inputs
from perfbench.metrics_common import roofline_pct


def read(run):
    cfg, b = run.config, run.traffic["batch"]
    k = inputs.symmetric_rows(cfg, run.traffic)
    if run.trace is None or k is None:
        return None
    n, m = cfg["num_points"], cfg["num_mesh_points"]
    step = (counts.add_dist_bound_s(b, n, m, b - k, nearest=False)
            + counts.add_dist_bound_s(b, n, m, k, nearest=True))
    launches = run.trace.kernels(
        r"\b(paired_dist|min_partial)\b|namespace\)::finalize\b")
    return roofline_pct(launches, [step], per=r"\bpaired_dist\b")
