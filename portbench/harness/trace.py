"""Device time from ``torch.profiler`` over a short span, read from its
Chrome trace.

The span is a ``record_function`` range around the traced calls, which
ends in a synchronise. Device activity is every ``kernel``, ``gpu_memcpy``
and ``gpu_memset`` record; busy time is the union of their intervals inside
the span. An idle gap is a stretch of the span with no device activity,
named by the innermost host record (a CUDA runtime call or an operator)
that covers its middle, or ``host`` where none does.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

SPAN = "portbench.span"
TRIES = 3  # profiled spans, each half as long as the last, before the trace is given up
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cuda_runtime", "cuda_driver", "cpu_op")


@dataclass
class Trace:
    span_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]  # the ten largest, by name
    idle_gaps: List[Tuple[str, float]]  # the ten largest, by what the host was doing
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # name -> (count, s)

    def matching(self, part: str, leave_out: str = "\0") -> Tuple[int, float]:
        """Count and seconds of the kernels whose names hold ``part`` and not ``leave_out``."""

        hits = [v for k, v in self.kernels.items() if part in k and leave_out not in k]
        return sum(c for c, _ in hits), sum(s for _, s in hits)


def record(torch, run) -> Trace:
    """Profile ``run()`` (which the span wraps, with a synchronise at its end)."""

    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            run()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events)


def reduce(events: list) -> Trace:
    """A :class:`Trace` from Chrome trace events (times in microseconds)."""

    spans = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("the trace holds no span")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                    for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE
                    and lo <= float(e["ts"]) <= hi)
    kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for a, b, name in device:
        kernels[name][0] += 1
        kernels[name][1] += (b - a) * 1e-6
    merged = []
    for a, b, _ in device:
        b = min(b, hi)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in _HOST]
    starts = np.asarray([float(e["ts"]) for e in host])
    ends = starts + np.asarray([float(e.get("dur", 0.0)) for e in host])
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for a, b in merged for x in (a, b)] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        covering = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = (host[covering[np.argmin(ends[covering] - starts[covering])]]["name"]
                if covering.size else "host")
        gaps[name] += (b - a) * 1e-6
    top = sorted(((k, v[1]) for k, v in kernels.items()), key=lambda kv: -kv[1])[:10]
    return Trace(span_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, device_ops=top,
                 idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
                 kernels={k: (v[0], v[1]) for k, v in kernels.items()})
