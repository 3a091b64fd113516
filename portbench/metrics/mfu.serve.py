"""Model FLOPs of a request's forward over the window's seconds a request,
against the H100's dense peak of the configuration's compute type."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return 100.0 * ctx["flops_per_unit"] / ctx["request_mean_s"] / ctx["peak_flops"]
