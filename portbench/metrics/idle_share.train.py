"""Share of a profiled span of train calls in which the device ran nothing:
1 - (union of device activity) / span, from the profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or not ctx["trace_ok"] or tr.span_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.span_s)
