"""The program's own tracing (``flow_timesnet_tpu_torch/tracing.py``), read
from a built cell after its window: the capture counters of ``graphs.py``,
the device regions that survive graph replay, the ``Forecaster``'s stage
spans, and a profiled span with tracing on whose idle gaps are put down to
the innermost program span around them.

:func:`capture_totals` is what the readers ``graph_captures`` and
``graph_capture_s`` read. :func:`measure` turns tracing on for a warm call
(the marked graphs' capture, outside anything measured), then times
``traced_steps`` / ``traced_requests`` more units with the regions and spans
cleared and the profiler off, then profiles as many again, and turns
tracing off. ``tools/trace_regions.py`` runs it on a cell. A program without
the tracing module or the counters (one older than them) gives None and
``{}``: nothing here raises for their absence.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

from portbench.harness import trace

PROGRAM = ("flow_timesnet_tpu_torch.graphs", "flow_timesnet_tpu_torch.tracing")


def _program():
    """``(graphs, tracing)`` of the program, or None where it has no tracing."""

    import importlib

    try:
        graphs, tracing = (importlib.import_module(name) for name in PROGRAM)
    except ImportError:
        return None
    if not hasattr(graphs, "capture_stats") or not hasattr(tracing, "regions"):
        return None
    return graphs, tracing


def capture_totals() -> Optional[Tuple[int, float]]:
    """Graphs the program captured since its process started, and their
    seconds (warm-up included), over every kind; None without the counters."""

    found = _program()
    if found is None:
        return None
    stats = found[0].capture_stats().values()
    return sum(n for n, _ in stats), sum(s for _, s in stats)


def _units(cell) -> Tuple[int, Callable[[], None]]:
    """The traced span's units (steps or requests) and a call that runs
    them, ending in a synchronise."""

    run = cell.run
    if run.ctx["kind"] == "train":
        n = int(run.traffic["traced_steps"])

        def call():
            cell.call(cell.plan.take(n))
            run.sync()
    else:
        n = int(run.traffic["traced_requests"])

        def call():
            for _ in range(n):
                _, h, s = cell.request()
                cell.fc.forecast(h, dates=s)
            run.sync()
    return n, call


def _profiled(run, call) -> list:
    """Chrome trace events of ``call()`` under the profiler, inside the
    span ``trace.SPAN``, as ``trace.record`` takes them (the card's
    activities where the run has a card)."""

    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if run.device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    run.sync()
    with profile(activities=activities) as prof:
        with record_function(trace.SPAN):
            call()
            run.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def idle_by_span(events: list, names) -> Dict[str, float]:
    """Seconds the device ran nothing inside the span ``trace.SPAN``, by the
    innermost program span (a ``user_annotation`` named in ``names``) that
    covers the middle of each gap, ``outside`` where none does."""

    span = next(e for e in events if e.get("name") == trace.SPAN
                and e.get("cat") == "user_annotation")
    lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                    for e in events if e.get("ph") == "X" and e.get("cat") in trace._DEVICE
                    and lo <= float(e["ts"]) <= hi)
    program = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
               if e.get("cat") == "user_annotation" and e.get("name") in names]
    out: Dict[str, float] = defaultdict(float)
    at = lo
    for a, b in device + [(hi, hi)]:
        if a > at:
            mid = 0.5 * (at + a)
            around = [(e - s, n) for s, e, n in program if s <= mid <= e]
            out[min(around)[1] if around else "outside"] += (a - at) * 1e-6
        at = max(at, min(b, hi))
    return dict(out)


def measure(cell) -> dict:
    """Tracing on for one warm call, one timed call of the traced span's
    units and one profiled one; tracing off after, whatever happens. What
    it read, for ``run.ctx``; ``{}`` where the program has no tracing."""

    found = _program()
    if found is None:
        return {}
    _, tracing = found
    run, torch = cell.run, cell.run.torch
    out = {}
    totals = capture_totals()
    out["graph_captures"], out["graph_capture_s"] = totals
    units, call = _units(cell)
    device = (torch.device("cpu") if run.device == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    tracing.enable()
    try:
        call()  # the marked graphs' capture
        tracing.clear_regions()
        tracing.clear()
        t0 = time.perf_counter()
        call()
        out["traced_unit_s"] = (time.perf_counter() - t0) / units
        out["regions"] = tracing.regions(device)
        spans = tracing.spans()
        tracing.clear_regions()
        events = _profiled(run, call)
        out["profiled_regions"] = tracing.regions(device)
        names = {s.name for s in tracing.spans()}
    finally:
        tracing.enable(False)
        tracing.clear()
        tracing.clear_regions()
    out["region_units"] = units
    out["traced_trace"] = trace.reduce(events)
    out["idle_by_span"] = idle_by_span(events, names)
    if run.ctx["kind"] == "serve":
        out["forecaster_host_s"] = statistics.median(_host_of_requests(spans))
    return out


def _host_of_requests(spans) -> list:
    """Each ``forecast`` span's seconds less its ``engine.replay`` and
    ``forecast.fetch`` children: the ``Forecaster``'s own host work."""

    child = defaultdict(float)
    for s in spans:
        if s.name in ("engine.replay", "forecast.fetch"):
            child[s.parent] += s.end_ns - s.start_ns
    return [1e-9 * (s.end_ns - s.start_ns - child[s.id]) for s in spans if s.name == "forecast"]


def report(ctx: dict, file=sys.stderr) -> None:
    """The regions a unit and the idle seconds by program span, on ``file``."""

    n = ctx["region_units"]
    tr = ctx["traced_trace"]
    print(f"regions: profiled span {tr.span_s:.6f} s, device busy {tr.busy_s:.6f} s "
          f"over {n} units", file=file)
    for name, (count, s) in sorted(ctx["profiled_regions"].items()):
        print(f"region {name}: {count / n:g} a unit, {1e3 * s / n:.4f} ms a unit", file=file)
    for name, s in sorted(ctx["idle_by_span"].items(), key=lambda kv: -kv[1]):
        print(f"idle under {name}: {1e3 * s:.4f} ms ({1e3 * s / n:.4f} a unit)", file=file)
