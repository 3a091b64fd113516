"""The median of every request's latency in the window (host clock, call to numpy result)."""

import numpy as np


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return 1e3 * float(np.percentile(ctx["latencies_s"], 50))
