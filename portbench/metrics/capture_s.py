"""Seconds of the timed entry's first call in set-up (warm-up and graph
capture, host clock ending in a synchronise)."""


def read(ctx):
    return ctx["capture_s"]
