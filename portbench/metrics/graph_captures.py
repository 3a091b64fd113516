"""Graphs the program captured from its process start (``graphs.capture_stats``,
every kind), read at the end of the run: set-up captures each timed entry's
graph once, and neither the window, the trace nor the check captures again."""

from portbench.harness import regions


def read(ctx):
    totals = regions.capture_totals()
    return None if totals is None else totals[0]
