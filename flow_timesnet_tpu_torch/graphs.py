"""CUDA graphs of the port's served request, training step and resident
epoch step: the card's counterpart of the JAX package's compiled programs.

:func:`capture` runs a body a few times on a side stream (cuBLAS and cuFFT
workspaces, the frozen path's cached geometries and DFT basis, the
kernels' libraries come into being there; one stream a card for every
capture, as cuBLAS keeps a workspace for each stream it has run on for the
life of the process), puts back in place whatever
state the body changes (parameters, Adam moments and step counts, EMA,
counters, the generators' states), so that warming up moves nothing, and
then captures the body once into the engine's memory pool. Each
:meth:`Captured.replay` launches the whole body with one host call.

A graph holds pointers, not names: the tensors it reads and writes must
stay where they were at capture. Callers copy their inputs into static
buffers, clone the outputs out before the next replay, and capture anew
for another ``TrainState``. Explicit ``torch.Generator``\\ s that the body
draws from (dropout) are registered with the graph, so each replay draws
the next numbers, as an eager call would.

The fold-conv launch counters of ``ops/cuda_fold.py`` count where a wrapper
launches its kernel: the warm-up calls and the capture count, a replay
(which runs no Python) does not. What a replay runs on the card, the
kernels count themselves (``cuda_fold.kernel_runs``).

:func:`capture_stats` counts the captures of each kind (``forward``,
``rollout``, ``step``, ``epoch``, ``eval``: the first element of the
engine's key) and their seconds, warm-up included, on a host clock that
ends in a synchronise; always on, they cost one clock pair a capture and
nothing a replay. With tracing on (``tracing.py``) a capture is the span
``graphs.capture``, with ``graphs.warmup`` and ``graphs.record`` inside it.
"""

from __future__ import annotations

import functools
import time
from collections import Counter
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import tracing

WARMUP_CALLS = 3  # eager calls on a side stream before a capture

_captures: Counter = Counter()  # kind -> captures since the process started
_capture_seconds: Counter = Counter()  # kind -> their seconds


class Captured:
    """One captured body: its static ``inputs`` (buffers a replay's inputs
    are copied into) and its static ``outputs``, which every replay
    overwrites. ``pins`` keeps alive the objects whose tensors the graph
    reads (and whose ``id`` may key it)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Sequence[Optional[torch.Tensor]],
                 outputs: Any, pins: Tuple[Any, ...]) -> None:
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.pins = pins

    def replay(self, inputs: Iterable[Optional[torch.Tensor]] = ()) -> Any:
        """Copy ``inputs`` (if given) into the static buffers and replay."""

        for buf, t in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(t)
        self.graph.replay()
        return self.outputs


@functools.cache
def _warmup_stream(device: int) -> torch.cuda.Stream:
    """The side stream every warm-up on card ``device`` runs on."""

    return torch.cuda.Stream(device)


def capture(body: Callable[[], Any], pool, *, kind: str,
            inputs: Sequence[Optional[torch.Tensor]] = (),
            state: Iterable[torch.Tensor] = (),
            generators: Sequence[Optional[torch.Generator]] = (),
            pins: Tuple[Any, ...] = ()) -> Captured:
    """Warm ``body`` up, restore ``state`` and the ``generators``, capture it.

    ``kind``: what :func:`capture_stats` counts it as; ``inputs``: the
    static buffers the body reads (see :func:`static_copies`); ``state``:
    every tensor the body updates in place (it is copied before the warm-up
    and copied back after it); ``generators``: those it draws from (None
    entries are skipped). A failure in the warm-up or the capture raises;
    nothing runs the body eagerly in its place.
    """

    t0 = time.perf_counter()
    with tracing.span("graphs.capture"):
        state = list(state)
        gens = [g for g in generators if g is not None]
        saved = [t.detach().clone() for t in state]
        gen_states = [g.get_state() for g in gens]
        side = _warmup_stream(torch.cuda.current_device())
        side.wait_stream(torch.cuda.current_stream())
        with tracing.span("graphs.warmup"), torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                body()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        for g, s in zip(gens, gen_states):
            g.set_state(s)

        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        # the outer stream context puts the caller's stream back even where a
        # failed capture leaves ``torch.cuda.graph``'s own context open
        with tracing.span("graphs.record"), torch.cuda.stream(torch.cuda.current_stream()):
            with torch.cuda.graph(graph, pool=pool):
                outputs = body()
        torch.cuda.synchronize()
    _captures[kind] += 1
    _capture_seconds[kind] += time.perf_counter() - t0
    return Captured(graph, inputs, outputs, pins)


def capture_stats() -> Dict[str, Tuple[int, float]]:
    """``{kind: (captures, seconds)}`` since the process started."""

    return {kind: (n, _capture_seconds[kind]) for kind, n in _captures.items()}


def signature(tensors: Iterable[Optional[torch.Tensor]]) -> Tuple:
    """What a graph's static buffers fix: each tensor's shape, dtype and
    device, or None where it is absent."""

    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in tensors)


def static_copies(tensors: Iterable[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
    """Static input buffers: a copy of each tensor (None stays None)."""

    return [None if t is None else t.detach().clone() for t in tensors]
