"""``torch.cuda.max_memory_allocated()`` over the window (peak stats reset as it opens)."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30
