"""What several metric readers share."""

from __future__ import annotations

import re

from perfbench.harness import busy_s


def idle_pct(run):
    """100 x (1 - busy / length) of the traced segment."""
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - busy_s((s, e) for _, s, e in t.device)
                    / t.window_s)


def mfu_pct(run):
    """100 x the window's model FLOPs per second over the peak."""
    if run.flops_per_unit is None or not run.window.units:
        return None
    rate = run.flops_per_unit * run.window.units / run.window.seconds
    return 100.0 * rate / run.config["peak_flops"]


def roofline_pct(launches, bounds_s, per=None):
    """100 x the launches' summed bound over their summed device time.
    ``bounds_s`` is the bound of one group of launches (one forward's
    three, or one step's); the groups are counted as the launches matching
    ``per``, or as len(launches) / len(bounds_s) when ``per`` is None. A
    segment whose launches do not fall into whole groups gives nothing."""
    if not launches:
        return None
    if per is None:
        groups, rest = divmod(len(launches), len(bounds_s))
        if rest:
            return None
    else:
        groups = sum(1 for name, _, _ in launches if re.search(per, name))
    device_s = sum(e - s for _, s, e in launches) / 1e6
    return 100.0 * groups * sum(bounds_s) / device_s
