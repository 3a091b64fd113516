"""Seconds of the program's graph captures (``graphs.capture_stats``, warm-up
included, each on a host clock that ends in a synchronise), read at the end
of the run; part of ``capture_s``, which also holds the first call's host work."""

from portbench.harness import regions


def read(ctx):
    totals = regions.capture_totals()
    return None if totals is None else totals[1]
