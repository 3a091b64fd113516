"""Training windows completed over the window's seconds (host clock, ending in a synchronise)."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["train_windows"] / ctx["window_s"]
