"""The fold-conv kernels' least time (the larger of bytes over the memory
rate and valid-tap operations over the compute type's peak, at the periods
each traced call selected) over their device time in the profiled span."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["trace_ok"] or ctx["fold_device_s"] <= 0:
        return None
    return 100.0 * ctx["fold_least_s"] / ctx["fold_device_s"]
