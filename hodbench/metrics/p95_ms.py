"""``p95_ms``: the 95th percentile, over every request submitted in the
window, of the time from ``submit`` until its client has the answer
(linear interpolation between order statistics)."""
import numpy as np


def read(ctx):
    if ctx.latencies.size == 0:
        return None
    return float(np.percentile(ctx.latencies, 95)) * 1e3
