"""The Forecaster's host share: the median request minus the median
``Engine.forward`` on the same prepared inputs, in interleaved pairs."""


def read(ctx):
    if ctx["kind"] != "serve" or "host_s" not in ctx:
        return None
    return 1e3 * ctx["host_s"]
