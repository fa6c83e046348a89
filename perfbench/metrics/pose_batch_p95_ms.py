"""The 95th percentile of the requests' times, call to numpy poses (or
distances) on the host, over every request counted in the window."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
