"""The port's tracing: device regions that survive CUDA-graph replay, host
spans on the profiler's clock, and ``train.profile_dir``'s profiled epoch.

Tracing is off by default (:func:`enable` turns it on). Off, :func:`region`
and :func:`span` return one shared object that does nothing, no mark is
launched or captured, and the program captures and runs what it runs
untraced. ``engine.py`` keys every graph by the tracing state, so a marked
graph and an unmarked one never share a key.

**Regions** (:func:`region`) time stretches of device work from inside a
step. On the card a region launches a one-thread mark kernel at its start
and at its end (``csrc/tap_conv_mma.cu::region_mark_kernel``), which reads
the card's nanosecond clock; the end mark adds the time since the start to
the region's nanosecond cell and 1 to its count. The cells are int64, three
a region, in one buffer per device made before any capture, as the
fold-conv kernels' run cells are (``ops/cuda_fold.py``). Captured into a
graph, the marks run on every replay, which no host code sees. On the CPU
the same cells take ``time.perf_counter_ns()``. :func:`regions` reads them
(one wait for the card), :func:`clear_regions` zeroes them in stream order.
A region's time runs from the end of the work before its start mark to the
end of its last kernel, so it holds the launch gaps inside it.

| Region | Where | Count |
|---|---|---|
| ``step.gather`` | the resident step's plan row and window gather | 1 a step |
| ``step.forward`` | ``Engine._loss``: model, mask, NB-NLL | 1 a step |
| ``step.backward`` | ``loss.backward()`` (and the group's sum) | 1 a step |
| ``step.optimizer`` | AdamW with its clip, and the EMA | 1 a step |
| ``model.forward`` | the served forward of ``Engine.forward`` / ``rollout`` | 1 a request |
| ``pointwise.fwd`` | each ``ops/fold.py::pointwise_conv``, remat's too | 16 a layer (3 branches) |
| ``pointwise.bwd`` | the backward of each ``pointwise_conv`` | as the forward, once |

Regions of one name never overlap; the pointwise ones lie inside a
``step.*`` region or ``model.forward``.

**Spans** (:func:`span`) time host stages: name, start and end
(``perf_counter_ns``), the enclosing span's id and a request id that every
span under one root shares (a ``Forecaster.forecast`` call, a training
chunk). They go to a ring of the last :data:`SPAN_RING` spans
(:func:`spans`, :func:`clear`). Under a running ``torch.profiler`` a span
also opens ``record_function(name)``, so it lands in the Chrome trace as a
``user_annotation`` on the clock of the device's kernel records.

**Counters**: ``graphs.capture_stats()`` counts captures by kind, and
``ops/fold.py::pointwise_runs()`` the 1x1 convs by route (tensor cores or
float32) and direction, both always on.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from .ops import _build

_enabled = False

SOURCE = "tap_conv_mma.cu"  # the library that holds the mark kernel
REGION_SLOTS = 64  # regions a device's buffer holds
_CELLS = 3  # of a region: the last start, nanoseconds summed, count
_slots: Dict[str, int] = {}  # region name -> its slot
_buffers: Dict[torch.device, object] = {}  # int64 cells on a card, a list on the CPU

SPAN_RING = 65536  # spans kept, newest last


def enabled() -> bool:
    """Whether tracing is on."""

    return _enabled


def enable(on: bool = True) -> None:
    """Turn tracing on (or off with ``on=False``). Graphs captured in the
    other state are not replayed in this one: ``engine.py`` captures the
    marked variant of each once, and drops them when tracing turns off."""

    global _enabled
    _enabled = bool(on)


class _Noop:
    """What :func:`region` and :func:`span` return with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _Noop()


# -- device regions ------------------------------------------------------------


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _slot(name: str) -> int:
    slot = _slots.setdefault(name, len(_slots))
    if slot >= REGION_SLOTS:
        raise RuntimeError(f"more than {REGION_SLOTS} tracing regions")
    return slot


def _buffer(device: torch.device):
    """The cells of ``device``, made on first use; a graph holds their
    address, so on a card they must predate any capture."""

    buf = _buffers.get(device)
    if buf is None:
        if device.type != "cuda":
            buf = [0] * (REGION_SLOTS * _CELLS)
        else:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the tracing cells are made by an eager mark, "
                                   "before any CUDA graph capture")
            with torch.inference_mode(False):  # a normal tensor, which clear_regions may zero
                buf = torch.zeros(REGION_SLOTS * _CELLS, dtype=torch.int64, device=device)
        _buffers[device] = buf
    return buf


@functools.cache
def _mark_fn():
    fn = _build.load(SOURCE).region_mark
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def _mark(device: torch.device, slot: int, end: bool) -> None:
    """One mark of the region at ``slot`` on ``device``: its start, or its end."""

    buf = _buffer(device)
    at = slot * _CELLS
    if device.type != "cuda":
        now = time.perf_counter_ns()
        if end:
            buf[at + 1] += now - buf[at]
            buf[at + 2] += 1
        else:
            buf[at] = now
        return
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _mark_fn()(buf.data_ptr() + 8 * at, int(end), stream)
    if err != 0:
        raise RuntimeError(f"region_mark launch failed with cudaError_t {err}")


class _Region:
    __slots__ = ("device", "slot")

    def __init__(self, name: str, device) -> None:
        self.device = _device(device)
        self.slot = _slot(name)

    def __enter__(self):
        _mark(self.device, self.slot, False)
        return self

    def __exit__(self, *exc) -> None:
        _mark(self.device, self.slot, True)


def region(name: str, device):
    """A device region named ``name`` on ``device`` (a context manager);
    with tracing off, the shared no-op."""

    if not _enabled:
        return _NOOP
    return _Region(name, device)


def regions(device) -> Dict[str, Tuple[int, float]]:
    """``{name: (count, seconds)}`` of every region that ended on ``device``
    since :func:`clear_regions`. Waits for the card."""

    device = _device(device)
    buf = _buffers.get(device)
    if buf is None:
        return {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        buf = buf.tolist()
    out = {}
    for name, slot in _slots.items():
        count = buf[slot * _CELLS + 2]
        if count:
            out[name] = (int(count), 1e-9 * buf[slot * _CELLS + 1])
    return out


def clear_regions() -> None:
    """Zero every device's cells, in stream order on a card."""

    for device, buf in _buffers.items():
        if device.type == "cuda":
            buf.zero_()
        else:
            buf[:] = [0] * len(buf)


# -- host spans -------------------------------------------------------------------


class Span(NamedTuple):
    """One closed span: ``parent`` is 0 for a root, ``request`` the root's id."""

    id: int
    parent: int
    request: int
    name: str
    start_ns: int
    end_ns: int


_ring: deque = deque(maxlen=SPAN_RING)
_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's open spans


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "request", "start", "annotation")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else 0
        self.request = stack[-1].request if stack else self.id
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        _open.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _ring.append(Span(self.id, self.parent, self.request, self.name, self.start, end))


def span(name: str):
    """A host span named ``name`` (a context manager); with tracing off,
    the shared no-op."""

    if not _enabled:
        return _NOOP
    return _OpenSpan(name)


def spans() -> List[Span]:
    """The spans in the ring, oldest first."""

    return list(_ring)


def clear() -> None:
    """Empty the ring of spans."""

    _ring.clear()


# -- train.profile_dir ------------------------------------------------------------


class EpochTrace:
    """``train.profile_dir``: a ``torch.profiler`` trace of one epoch (the
    CPU's activities and, on the card, CUDA's), run with tracing on, so the
    Chrome trace holds the program's spans and the mark kernels."""

    def __init__(self) -> None:
        self.prof = None
        self.device: Optional[torch.device] = None
        self._was_on = False

    def start(self, device: torch.device) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._was_on = _enabled
        enable()
        clear_regions()
        clear()
        self.device = device
        self.prof = profile(activities=activities)
        self.prof.start()

    def step_regions(self) -> str:
        """The traced epoch's region totals in ms a step (steps: the count of
        ``step.forward``; ``pointwise`` sums both directions), for its log
        line; empty outside a traced epoch. Waits for the card."""

        if self.prof is None:
            return ""
        found = regions(self.device)
        steps = found.get("step.forward", (0, 0.0))[0]
        if not steps:
            return ""
        ms = {name: 1e3 * s / steps for name, (_, s) in found.items()
              if name.startswith("step.")}
        ms["pointwise"] = 1e3 * sum(found.get(f"pointwise.{d}", (0, 0.0))[1]
                                    for d in ("fwd", "bwd")) / steps
        return " regions_ms_a_step=" + ",".join(f"{k}:{v:.3f}" for k, v in ms.items())

    def stop(self, path: Optional[str] = None) -> Optional[str]:
        """Stop a running trace and, given ``path``, write it there as a
        Chrome trace (returns ``path`` where written); tracing goes back to
        its state before :meth:`start`."""

        prof, self.prof = self.prof, None
        if prof is None:
            return None
        prof.stop()
        enable(self._was_on)
        if path is None:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        prof.export_chrome_trace(path)
        return path
