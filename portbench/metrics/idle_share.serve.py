"""Share of a request's time in which the device ran nothing: 1 - (the
device's busy seconds a request, the union of its activity over a profiled
span of serve calls) / (the seconds a request took in the untraced window).
The profiler stretches the host's part of a traced request, so the span's
own length is not the denominator."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "serve" or not ctx["trace_ok"]:
        return None
    return 100.0 * (1.0 - tr.busy_s / ctx["traced_units"] / ctx["request_mean_s"])
