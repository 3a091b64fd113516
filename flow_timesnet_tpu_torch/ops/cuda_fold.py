"""Fold convolution on the card: the wrappers around ``csrc/tap_conv_fwd.cu``,
``csrc/tap_conv_bwd.cu`` and ``csrc/tap_conv_mma.cu``, and the autograd
Function that joins them.

Counterpart of ``flow_timesnet_tpu/ops/pallas_fold.py::tap_conv_pallas`` and
of the custom VJP of ``flow_timesnet_tpu/ops/fold.py::tap_conv``.
:func:`tap_conv` runs :class:`TapConv`: on a CUDA tensor its forward is the
forward kernel and its backward the dh-adjoint and dW kernels (or a launch
raises); on a CPU tensor both are the plain versions of ``ops/fold.py``.
:func:`dense_fold_conv`, the frozen-period path's exact-extent conv, runs
the same Function and kernels on ``make_dense_geometry``'s one-period
geometry, with the JAX dense form's bf16 rounding.
Each kernel has two routes, chosen by dtype, and neither gives way to the
other: bf16 runs on the tensor cores (``tap_conv_mma.cu`` for the forward
and dh, ``tap_conv_dw_mma`` for dW), float32 on the CUDA cores, whose
float32 FMAs keep the products exact. Every kernel has a launch plan,
mirrored here constant for constant (:func:`fold_mma_plan`,
:func:`dw_mma_plan`, :func:`fwd_f32_plan`, :func:`dh_f32_plan`,
:func:`dw_f32_plan`), so that the CPU tests can model the kernel's cuts and
a shape a kernel cannot take raises before its launch.
Autograd never differentiates the plain version's gathers, whose transpose
would be the scatter the JAX package's custom VJP avoids. ``chip_smoke.py``
holds each kernel against its plain version on the card, and the CPU tests
hold the plain versions against the JAX package.

The kernels are built with ``nvcc`` at their first launch (see
``ops/_build.py``); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build
from .fold import FoldGeometry
from .fold import tap_conv as tap_conv_plain
from .fold import tap_conv_dh as tap_conv_dh_plain
from .fold import tap_weight_grad as tap_weight_grad_plain

SOURCE = "tap_conv_fwd.cu"
SOURCE_BWD = "tap_conv_bwd.cu"
SOURCE_MMA = "tap_conv_mma.cu"

# Launches of each kernel, keyed by kernel size ("3x3", ...). Only the CUDA
# path counts; the plain versions never do.
launches: Counter = Counter()  # forward, either route
launches_mma: Counter = Counter()  # forward, the bf16 tensor-core route
launches_dh: Counter = Counter()  # dh adjoint, either route
launches_dh_mma: Counter = Counter()  # dh adjoint, the bf16 tensor-core route
launches_dw: Counter = Counter()  # weight gradient, either route
launches_dw_mma: Counter = Counter()  # weight gradient, the bf16 tensor-core route

# Runs of each kernel on the card, counted by the kernels themselves: every
# launch adds 1 to its cell when it runs (``csrc/run_count.cuh``), so the
# replays of a CUDA graph count too, which no wrapper sees (the counters
# above count where a wrapper launches). One int32 cell per kernel, route and
# kernel size, in one buffer per device; reading them waits for the card.
RUN_KINDS = ("fwd_mma", "fwd_f32", "dh_mma", "dh_f32", "dw_mma", "dw_f32")
_RUN_CELLS = 256
_run_slots: Dict[Tuple[str, str], int] = {}  # (kind, "3x3") -> its cell
_run_buffers: Dict[torch.device, torch.Tensor] = {}


def _run_cell(device: torch.device, kind: str, kh: int, kw: int) -> int:
    """The address of the run cell of ``kind`` at ``kh`` x ``kw`` on ``device``."""

    slot = _run_slots.setdefault((kind, f"{kh}x{kw}"), len(_run_slots))
    if slot >= _RUN_CELLS:
        raise RuntimeError(f"more than {_RUN_CELLS} kernel run cells")
    buf = _run_buffers.get(device)
    if buf is None:  # a graph holds the cells' address: they must predate any capture
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the kernel run cells are made by an eager launch, "
                               "before any CUDA graph capture")
        with torch.inference_mode(False):  # a normal tensor, which clear_kernel_runs may zero
            buf = torch.zeros(_RUN_CELLS, dtype=torch.int32, device=device)
        _run_buffers[device] = buf
    return buf.data_ptr() + 4 * slot


def _cuda_device(device) -> torch.device:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.index is not None else torch.device("cuda", 0)


def kernel_runs(device=None) -> Dict[str, Dict[str, int]]:
    """The launches each kernel ran on ``device`` (default: the current
    card) since :func:`clear_kernel_runs`, as the kernels counted them:
    ``{kind: {"3x3": n, ...}}`` for every kind of ``RUN_KINDS``. Waits for
    the card."""

    out: Dict[str, Dict[str, int]] = {kind: {} for kind in RUN_KINDS}
    buf = _run_buffers.get(_cuda_device(device))
    if buf is not None:
        cells = buf.tolist()
        for (kind, size), slot in _run_slots.items():
            if cells[slot]:
                out[kind][size] = cells[slot]
    return out


def clear_kernel_runs(device=None) -> None:
    """Zero the run cells of ``device`` (default: the current card), in
    stream order."""

    buf = _run_buffers.get(_cuda_device(device))
    if buf is not None:
        buf.zero_()


_P, _I = ctypes.c_void_p, ctypes.c_int
_INVALID_VALUE = 1  # cudaErrorInvalidValue: what a kernel returns for a shape it cannot take

# The plan of the bf16 dW kernel, constant for constant as in
# csrc/tap_conv_bwd.cu (dw_mma_plan); a card test holds the two together.
MMA_ROWS = 16  # rows of a sequence per mma k-step
MMA_WARP_TILE = 32  # a warp's dW tile: 32 ci x 32 co
MMA_ROW_PAD = 8  # bf16 elements added to each staged row
MMA_MAX_WARPS = 16  # one warp per tap of a kernel row
MMA_STAGES = 4  # staged items in a block's ring of buffers
MMA_BAND_ROWS = (64, 32, 16)  # band 1: rows of an item, preferred first
MMA_TARGET_WARPS = 8 * 132  # pass 1: about 8 warps per SM of an H100 in all
MAX_SMEM_BYTES = 232448  # the most shared memory one block may use


class DwMmaPlan(NamedTuple):
    """How ``tap_conv_dw_mma`` cuts one call, in the order its C plan reports.
    An item is ``rt`` rows of ct of one sequence."""

    lp_pad: int  # Lp rounded up to whole items
    pad: int  # (kh // 2) * p_max + kw // 2: zero rows on each side of a staged sequence
    rt: int  # rows of ct an item multiplies: lp_pad (band 0) or 64, 32, 16 (band 1)
    band: int  # 0: an item is a whole sequence between pad zero rows; 1: a row tile
    buf_rows: int  # rows of h an item stages: lp_pad + 2 * pad (band 0), rt + kw - 1 (band 1)
    tiles: int  # 32 x 32 channel tiles of dW
    chunks_per_k: int  # chunks of each candidate's items
    per_chunk: int  # items of a chunk (the last one may hold fewer)
    warps: int  # warps of a block: one per tap of a kernel row
    smem: int  # dynamic shared memory of a block, bytes
    chunks: int  # K * chunks_per_k

    def scratch_elems(self, kh: int, kw: int, cin: int, cout: int) -> int:
        """float32 partials pass 1 writes: one [kh, kw, Cin, Cout] per chunk."""

        return self.chunks * kh * kw * cin * cout


@functools.lru_cache(maxsize=64)  # a training step asks for the same few plans each time
def dw_mma_plan(K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int,
                p_max: int) -> DwMmaPlan:
    """The launch plan of the bf16 dW kernel, or a ``RuntimeError`` through
    :func:`_raise_on` for a shape it cannot take (the kernel refuses the same
    shapes with ``cudaErrorInvalidValue``).

    A block (kernel row dc, channel tile, chunk) stages its items into a
    ring of ``MMA_STAGES`` buffers, rows padded by ``MMA_ROW_PAD`` elements.
    Band 0, where that ring fits in ``MAX_SMEM_BYTES``: an item is a whole
    sequence of ct (``rt = lp_pad``, whole 16-row k-steps), its h staged
    between ``pad = (kh // 2) * p_max + kw // 2`` zero rows on each side,
    beside the block's B-fragment masks (8 bytes a lane, warp and k-step)
    and its row/col table. Band 1, else: an item is ``rt`` rows of one
    sequence, the first of ``MMA_BAND_ROWS`` that fits, and the block's one
    kernel row reads one band of ``rt + kw - 1`` rows of h, beside the
    item's (row, col) table. Chunks never straddle two candidates, and hold
    as many items as about ``MMA_TARGET_WARPS`` warps in all leave to each.
    """

    shape = f"K={K}, B={B}, Lp={Lp}, Cin={cin}, Cout={cout}, {kh}x{kw}, p_max={p_max}"
    why = None
    if min(K, B, Lp, cin, cout, kh, kw) <= 0 or kh % 2 == 0 or kw % 2 == 0:
        why = "every extent must be positive and the kernel size odd"
    elif cin % 16 or cout % 8:
        why = "Cin must be a multiple of 16 and Cout a multiple of 8 (the mma tile)"
    elif kw > MMA_MAX_WARPS:
        why = f"at most {MMA_MAX_WARPS} taps in a kernel row (one warp each)"
    elif not 1 <= p_max <= Lp:
        why = "p_max must lie in [1, Lp]"
    if why is not None:
        _raise_on(_INVALID_VALUE, "tap_conv_dw_mma", f"{shape}: {why}")
    lp16 = -(-Lp // MMA_ROWS) * MMA_ROWS
    pad = (kh // 2) * p_max + kw // 2
    si, so = cin + MMA_ROW_PAD, cout + MMA_ROW_PAD
    smem = (2 * MMA_STAGES * ((lp16 + 2 * pad) * si + lp16 * so)
            + 8 * kw * (lp16 // MMA_ROWS) * 32 + 2 * 4 * lp16)
    if smem <= MAX_SMEM_BYTES:
        band, rt, lp_pad, buf_rows = 0, lp16, lp16, lp16 + 2 * pad
    else:
        band = None
        for rt in MMA_BAND_ROWS:
            smem = 2 * MMA_STAGES * ((rt + kw - 1) * si + rt * so) + 8 * MMA_STAGES * rt
            if smem <= MAX_SMEM_BYTES:
                band, lp_pad, buf_rows = 1, -(-Lp // rt) * rt, rt + kw - 1
                break
        if band is None:
            _raise_on(_INVALID_VALUE, "tap_conv_dw_mma",
                      f"{shape}: a block would need {smem} bytes of shared memory at "
                      f"{MMA_BAND_ROWS[-1]} rows an item, above {MAX_SMEM_BYTES}")
    tiles = -(-cin // MMA_WARP_TILE) * -(-cout // MMA_WARP_TILE)
    items = B * (lp_pad // rt)
    want = max(1, MMA_TARGET_WARPS // (kh * tiles * kw))  # chunks in all
    per_k = min(items, -(-want // K))
    per_chunk = -(-items // per_k)
    chunks_per_k = -(-items // per_chunk)
    if K * chunks_per_k > 65535 or items > 0x7FFFFFFF:
        _raise_on(_INVALID_VALUE, "tap_conv_dw_mma", f"{shape}: more than 65535 chunks")
    return DwMmaPlan(lp_pad, pad, rt, band, buf_rows, tiles, chunks_per_k, per_chunk, kw, smem,
                     K * chunks_per_k)


# The plan of the bf16 forward and dh template, constant for constant as in
# csrc/tap_conv_mma.cu (fold_mma_plan); a card test holds the two together.
FOLD_MAX_WARPS = 16  # warps of a block
FOLD_MAX_GROUPS = 15  # a group syncs on one of the named barriers 1-15
FOLD_STAGES = 2  # a ring of staged items per group, where a group has more than one
FOLD_TILES = (32, 16, 8)  # output channels of a block's tile, preferred first
FOLD_ROW_TILES = (64, 32, 16)  # output rows of an item, preferred first
SMEM_PER_SM = 233472  # shared memory of one SM of an H100
SMEM_RESERVED = 1024  # what the runtime keeps of it per block
WARPS_PER_SM = 64
REGS_PER_SM = 65536
REGS_CAP = REGS_PER_SM // (FOLD_MAX_WARPS * 32)  # the kernel's __launch_bounds__(512, 1)
SMS = 132  # SMs of an H100 SXM: the chunks fill one wave of blocks


def row_stride(cols: int) -> int:
    """bf16 elements of a staged row of ``cols`` channels: 8 more when the row
    holds an even number of 16-byte vectors, so that the 8 rows an ldmatrix
    matrix reads start in 8 distinct 16-byte bank groups."""

    return cols + (8 if (cols // 8) % 2 == 0 else 0)


class FoldMmaPlan(NamedTuple):
    """How ``tap_conv_fwd_mma`` / ``tap_conv_dh_mma`` cut one call, in the
    order the C plan reports. An item is ``rt`` output rows of one sequence."""

    lp_pad: int  # Lp rounded up to whole items
    pad: int  # (kh // 2) * p_max + kw // 2: the largest |dc * p + dj|
    rt: int  # output rows of an item (16, 32 or 64)
    band: int  # 1: an item is staged as kh bands of rt + kw - 1 rows; 0: one window
    buf_rows: int  # rows of a staged item
    nt: int  # output channels of a block's tile (32, 16 or 8)
    tiles: int  # channel tiles: ceil(Cy / nt)
    groups: int  # items a block multiplies at once, rt // 16 warps each
    warps: int  # warps of a block
    stages: int  # staged items per group: 1 (every group has at most one) or FOLD_STAGES
    chunks_per_k: int  # chunks of each candidate's items
    per_chunk: int  # items of a chunk (the last one may hold fewer)
    chunks: int  # K * chunks_per_k
    smem: int  # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=64)  # a request or a step asks for the same few plans each time
def fold_mma_plan(sign: int, K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int,
                  p_max: int) -> FoldMmaPlan:
    """The launch plan of the bf16 forward (``sign=+1``) or dh (``sign=-1``)
    kernel, or a ``RuntimeError`` through :func:`_raise_on` for a shape it
    cannot take (the kernel refuses the same shapes with ``cudaErrorInvalidValue``).

    X (h or ct) has ``cx`` channels, the output ``cy``. A block stages its
    tile of W, ``kh * kw`` taps of [ci][co] rows (forward: Cin rows of ``nt``
    columns; dh: ``nt`` rows of Cout columns), and ``groups`` rings of
    ``stages`` items. An item is one window of ``rt + 2 * pad`` rows or,
    where that is more, ``kh`` bands of ``rt + kw - 1`` rows. The plan takes
    the first tile, then item height, then the most groups, that fit in
    ``MAX_SMEM_BYTES``; the chunks never straddle two candidates and fill one
    wave of resident blocks. One staged item per group where that leaves
    each group at most one item, else a ring of ``FOLD_STAGES``.
    """

    name = "tap_conv_fwd_mma" if sign > 0 else "tap_conv_dh_mma"
    shape = f"K={K}, B={B}, Lp={Lp}, Cin={cin}, Cout={cout}, {kh}x{kw}, p_max={p_max}"
    why = None
    if sign not in (1, -1):
        why = "sign must be +1 or -1"
    elif min(K, B, Lp, cin, cout, kh, kw) <= 0 or kh % 2 == 0 or kw % 2 == 0:
        why = "every extent must be positive and the kernel size odd"
    elif cin % 16 or cout % 16:
        why = "Cin and Cout must be multiples of 16 (the mma's k-depth)"
    elif not 1 <= p_max <= Lp:
        why = "p_max must lie in [1, Lp]"
    if why is not None:
        _raise_on(_INVALID_VALUE, name, f"{shape}: {why}")
    one = _fold_plan_with(1, sign, K, B, Lp, cin, cout, kh, kw, p_max)
    if one is not None and one.per_chunk <= one.groups:
        return one
    plan = _fold_plan_with(FOLD_STAGES, sign, K, B, Lp, cin, cout, kh, kw, p_max)
    if plan is None:
        _raise_on(_INVALID_VALUE, name, f"{shape}: W's slice and one staged item per group "
                  f"need more than {MAX_SMEM_BYTES} bytes of shared memory at every tile, or "
                  f"more than 65535 chunks")
    return plan


def _fold_plan_with(stages, sign, K, B, Lp, cin, cout, kh, kw, p_max) -> Optional[FoldMmaPlan]:
    """:func:`fold_mma_plan` with ``stages`` staged items per group, or None
    where nothing fits (``plan_with`` in the C source)."""

    cx, cy = (cin, cout) if sign > 0 else (cout, cin)
    pad = (kh // 2) * p_max + kw // 2
    lp16 = -(-Lp // MMA_ROWS) * MMA_ROWS

    def rows(rt):  # of a staged item: one window, or kh bands where fewer
        return min(rt + 2 * pad, kh * (rt + kw - 1))

    def smem_of(nt, rt, groups):
        w_bytes = 2 * kh * kw * (cx * row_stride(nt) if sign > 0 else nt * row_stride(cx))
        return w_bytes + groups * stages * 2 * rows(rt) * row_stride(cx)

    # the first tile, then item height, then the most groups, that fit
    order = ((nt, rt, groups) for nt in FOLD_TILES if nt <= cy
             for rt in FOLD_ROW_TILES if rt <= lp16
             for groups in range(min(FOLD_MAX_GROUPS, FOLD_MAX_WARPS // (rt // MMA_ROWS)), 0, -1))
    fit = next((c for c in order if smem_of(*c) <= MAX_SMEM_BYTES), None)
    if fit is None:
        return None
    nt, rt, groups = fit
    smem, buf_rows, band = smem_of(*fit), rows(rt), int(kh * (rt + kw - 1) < rt + 2 * pad)
    lp_pad = -(-Lp // rt) * rt
    tiles = -(-cy // nt)
    warps = groups * rt // MMA_ROWS
    # blocks an SM surely holds: by warps, shared memory and registers at the cap
    resident = max(1, min(WARPS_PER_SM // warps, SMEM_PER_SM // (smem + SMEM_RESERVED),
                          REGS_PER_SM // (warps * 32 * REGS_CAP)))
    want = max(1, -(-SMS * resident // tiles))  # chunks in all
    items = B * (lp_pad // rt)
    per_k = min(items, -(-want // K))
    per_chunk = -(-items // per_k)
    chunks_per_k = -(-items // per_chunk)
    if K * chunks_per_k > 65535 or tiles > 65535:
        return None
    return FoldMmaPlan(lp_pad, pad, rt, band, buf_rows, nt, tiles, groups, warps, stages,
                       chunks_per_k, per_chunk, K * chunks_per_k, smem)


# The plans of the float32 forward, dh and dW kernels, constant for constant
# as in csrc/f32_stage.cuh, csrc/tap_conv_fwd.cu (fwd_f32_plan) and
# csrc/tap_conv_bwd.cu (dh_f32_plan, dw_f32_plan); a card test holds them together.
F32_ROWS = 64  # dW: rows of an item, a 64-row tile of one sequence
F32_MAX_WARPS = 16  # warps of a block
F32_MAX_GROUPS = 15  # forward and dh: a group syncs on one of the named barriers 1-15
F32_ROW_TILES = (64, 32, 16)  # forward and dh: output rows of an item, preferred first
FWD_TILES = (32, 16, 8)  # forward: output channels of a block's tile, widest first
DH_TILES = (32, 16, 8)  # dh: input channels of a block's tile
DW_TILE = 32  # dW: a warp's tile, 32 ci x 32 co
DW_STAGES = 2  # dW: staged rounds (an item for each split) in a block's ring


def f32_stride(cols: int) -> int:
    """floats of a staged float32 row of ``cols`` channels: whole float4s, an
    odd number of them, so that 8 consecutive rows start in 8 distinct bank
    groups."""

    return ((cols + 3) // 4 | 1) * 4


def f32_warp_rows(nt: int) -> int:
    """Rows a warp of the float32 forward or dh kernel owns at a tile of
    ``nt`` channels: its lanes are 32 / (nt / 4) rows by nt / 4 groups of 4
    channels, 4 rows a lane."""

    return 4 * (32 // (nt // 4))


def _f32_chunks(items: int, warps: int, smem: int, tiles: int) -> Optional[tuple]:
    """(per_chunk, chunks) of a float32 forward or dh plan: ``items`` items
    cut into chunks, a persistent block each, that fill one wave of resident
    blocks of ``warps`` warps and ``smem`` bytes over ``tiles`` channel
    tiles, registers counted at the launch bounds' cap; None where a grid,
    or the kernels' int item count, cannot hold them (``f32_chunks`` in
    ``csrc/f32_stage.cuh``)."""

    resident = max(1, min(WARPS_PER_SM // warps, SMEM_PER_SM // (smem + SMEM_RESERVED),
                          REGS_PER_SM // (warps * 32 * REGS_CAP)))
    per_chunk = -(-items // min(items, max(1, -(-SMS * resident // tiles))))
    chunks = -(-items // per_chunk)
    if items > 0x7FFFFFFF or chunks > 65535 or tiles > 65535:
        return None
    return per_chunk, chunks


class FwdF32Plan(NamedTuple):
    """How the float32 ``tap_conv_fwd`` cuts one call, in the order its C
    plan reports. An item is ``rt`` output rows of one sequence."""

    lp_pad: int  # Lp rounded up to whole items
    pad: int  # (kh // 2) * p_max + kw // 2: the largest |dc * p + dj|
    rt: int  # output rows of an item (64, 32 or 16)
    band: int  # 1: an item is staged as kr bands of rt + kw - 1 rows; 0: one window
    buf_rows: int  # rows of a staged item
    kr: int  # kernel rows of a pass: kh, or fewer where all of W's taps do not fit
    kc: int  # input channels of a pass: Cin, or a multiple of 4 where Cin takes passes
    passes: int  # passes of a block over its items: ceil(kh / kr) * ceil(Cin / kc)
    sx: int  # floats of a staged row of h: f32_stride(kc)
    nt: int  # output channels of a block's tile (32, 16 or 8)
    tiles: int  # channel tiles: ceil(Cout / nt)
    groups: int  # items a block multiplies at once, max(1, rt // f32_warp_rows(nt)) warps each
    warps: int  # warps of a block
    per_chunk: int  # items of a chunk (the last one may hold fewer)
    chunks: int  # chunks of the K * B * lp_pad / rt items, candidates interleaved
    smem: int  # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=64)  # a request or a step asks for the same few plans each time
def fwd_f32_plan(K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int,
                 p_max: int) -> FwdF32Plan:
    """The launch plan of the float32 forward kernel, or a ``RuntimeError``
    through :func:`_raise_on` for a shape it cannot take (the kernel refuses
    the same shapes with ``cudaErrorInvalidValue``).

    A block stages the ``nt``-column slice of W's [tap][ci] rows once a
    pass, ``kr * kw`` taps of ``kc`` (rounded up to 4) rows of ``nt``
    floats, beside ``groups`` staged items of h (one window of
    ``min(Lp, rt + 2 * pad)`` rows or ``kr`` bands of ``rt + kw - 1``, the
    fewer) and one zero row, each :func:`f32_stride` (``kc``) floats. It
    takes the fewest passes over the kernel rows (slices of ``kr`` rows),
    then over Cin (slices of ``kc`` channels), at which a tile fits: one
    pass where it can. Of the tiles (32 and 16 only where Cout reaches
    them, 8 always) it takes the one with room for the most warps, ties to
    the wider, each with the first item height (64, 32, 16) and then the
    most groups that fit in ``MAX_SMEM_BYTES``. Items and chunks are those
    of :func:`dh_f32_plan`.
    """

    shape = f"K={K}, B={B}, Lp={Lp}, Cin={cin}, Cout={cout}, {kh}x{kw}, p_max={p_max}"
    why = None
    if min(K, B, Lp, cin, cout, kh, kw) <= 0 or kh % 2 == 0 or kw % 2 == 0:
        why = "every extent must be positive and the kernel size odd"
    elif not 1 <= p_max <= Lp:
        why = "p_max must lie in [1, Lp]"
    if why is not None:
        _raise_on(_INVALID_VALUE, "tap_conv_fwd", f"{shape}: {why}")
    pad = (kh // 2) * p_max + kw // 2

    def smem_of(kr, kc, nt, rows, groups):  # W's slice, the staged items and the zero row
        return 4 * (kr * kw * -(-kc // 4) * 4 * nt + (groups * rows + 1) * f32_stride(kc))

    def best_tile(kr, kc):  # (warps, nt, rt, groups, window, bands, smem), or None
        best = None
        for nt in FWD_TILES:
            if nt > cout and nt != 8:
                continue
            for rt in F32_ROW_TILES:  # the first item height at which a group fits
                window, bands = min(Lp, rt + 2 * pad), kr * (rt + kw - 1)
                tpi = max(1, rt // f32_warp_rows(nt))  # warps of a group: an item's row tiles
                rows = min(window, bands)
                fit = next((g for g in range(min(F32_MAX_GROUPS, F32_MAX_WARPS // tpi), 0, -1)
                            if smem_of(kr, kc, nt, rows, g) <= MAX_SMEM_BYTES), None)
                if fit is not None:
                    if best is None or fit * tpi > best[0]:
                        best = (fit * tpi, nt, rt, fit, window, bands,
                                smem_of(kr, kc, nt, rows, fit))
                    break
        return best

    def channels(ci_passes):  # of a slice: all of Cin, else a multiple of 4 (16-byte copies)
        share = -(-cin // ci_passes)
        return cin if ci_passes == 1 else -(-share // 4) * 4

    # the fewest passes over the kernel rows, then over Cin, at which a tile fits
    slices = ((-(-kh // row_passes), channels(ci_passes)) for row_passes in range(1, kh + 1)
              for ci_passes in range(1, -(-cin // 4) + 1))
    for kr, kc in slices:
        best = best_tile(kr, kc)
        if best is not None:
            break
    else:
        _raise_on(_INVALID_VALUE, "tap_conv_fwd", f"{shape}: W's 8-column slice of one kernel "
                  f"row at 4 input channels and one staged item need more than "
                  f"{MAX_SMEM_BYTES} bytes of shared memory")
    warps, nt, rt, groups, window, bands, smem = best
    lp_pad, tiles = -(-Lp // rt) * rt, -(-cout // nt)
    chunking = _f32_chunks(K * B * (lp_pad // rt), warps, smem, tiles)
    if chunking is None or pad > 0x7FFFFFFF:
        _raise_on(_INVALID_VALUE, "tap_conv_fwd", f"{shape}: more than 65535 chunks or tiles, "
                  f"or 2**31 items or rows of tap offset")
    per_chunk, chunks = chunking
    return FwdF32Plan(lp_pad, pad, rt, int(bands < window), min(window, bands), kr, kc,
                      -(-kh // kr) * -(-cin // kc), f32_stride(kc), nt, tiles, groups, warps,
                      per_chunk, chunks, smem)


class DhF32Plan(NamedTuple):
    """How the float32 ``tap_conv_dh`` cuts one call, in the order its C plan
    reports. An item is ``rt`` output rows of one sequence."""

    lp_pad: int  # Lp rounded up to whole items
    pad: int  # (kh // 2) * p_max + kw // 2: the largest |dc * p + dj|
    rt: int  # output rows of an item (64, 32 or 16)
    band: int  # 1: an item is staged as kh bands of rt + kw - 1 rows; 0: one window
    buf_rows: int  # rows of a staged item
    sc: int  # floats of a staged row of ct or W: f32_stride(Cout)
    nt: int  # input channels of a block's tile (32, 16 or 8)
    tiles: int  # channel tiles: ceil(Cin / nt)
    groups: int  # items a block multiplies at once, max(1, rt // f32_warp_rows(nt)) warps each
    warps: int  # warps of a block
    per_chunk: int  # items of a chunk (the last one may hold fewer)
    chunks: int  # chunks of the K * B * lp_pad / rt items, candidates interleaved
    smem: int  # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=64)  # a step asks for the same few plans each time
def dh_f32_plan(K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int,
                p_max: int) -> DhF32Plan:
    """The launch plan of the float32 dh kernel, or a ``RuntimeError``
    through :func:`_raise_on` for a shape it cannot take (the kernel refuses
    the same shapes with ``cudaErrorInvalidValue``).

    A block stages its tile of ``nt`` input channels of W once, ``kh * kw``
    taps of ``nt`` [ci][co] rows, beside ``groups`` staged items (one window
    of ``min(Lp, rt + 2 * pad)`` rows or ``kh`` bands of ``rt + kw - 1``, the
    fewer) and one zero row, every row :func:`f32_stride` floats. Of the
    tiles (32 and 16 only where Cin reaches them, 8 always) it takes the one
    with room for the most warps, ties to the wider, each with the first
    item height (64, 32, 16) and then the most groups that fit in
    ``MAX_SMEM_BYTES``. Item i is row tile (i // K) % n_rt of sequence
    (i % K, i // K // n_rt): the candidates alternate, so every chunk holds
    both periods alike, and the chunks fill one wave of resident blocks,
    registers counted at the launch bounds' cap.
    """

    shape = f"K={K}, B={B}, Lp={Lp}, Cin={cin}, Cout={cout}, {kh}x{kw}, p_max={p_max}"
    why = None
    if min(K, B, Lp, cin, cout, kh, kw) <= 0 or kh % 2 == 0 or kw % 2 == 0:
        why = "every extent must be positive and the kernel size odd"
    elif not 1 <= p_max <= Lp:
        why = "p_max must lie in [1, Lp]"
    if why is not None:
        _raise_on(_INVALID_VALUE, "tap_conv_dh", f"{shape}: {why}")
    pad = (kh // 2) * p_max + kw // 2
    sc = f32_stride(cout)
    best = None  # (warps, nt, rt, groups, window, bands, smem)
    for nt in DH_TILES:
        if nt > cin and nt != 8:
            continue
        for rt in F32_ROW_TILES:  # the first item height at which a group fits
            window, bands = min(Lp, rt + 2 * pad), kh * (rt + kw - 1)
            tpi = max(1, rt // f32_warp_rows(nt))  # warps of a group: an item's row tiles
            fit = next((g for g in range(min(F32_MAX_GROUPS, F32_MAX_WARPS // tpi), 0, -1)
                        if 4 * (kh * kw * nt + g * min(window, bands) + 1) * sc
                        <= MAX_SMEM_BYTES), None)
            if fit is not None:
                if best is None or fit * tpi > best[0]:
                    best = (fit * tpi, nt, rt, fit, window, bands,
                            4 * (kh * kw * nt + fit * min(window, bands) + 1) * sc)
                break
    if best is None:
        _raise_on(_INVALID_VALUE, "tap_conv_dh", f"{shape}: W's tile at 8 channels and one staged "
                  f"item need more than {MAX_SMEM_BYTES} bytes of shared memory")
    warps, nt, rt, groups, window, bands, smem = best
    lp_pad, tiles = -(-Lp // rt) * rt, -(-cin // nt)
    chunking = _f32_chunks(K * B * (lp_pad // rt), warps, smem, tiles)
    if chunking is None:
        _raise_on(_INVALID_VALUE, "tap_conv_dh", f"{shape}: more than 65535 chunks or tiles, "
                  f"or 2**31 items")
    per_chunk, chunks = chunking
    return DhF32Plan(lp_pad, pad, rt, int(bands < window), min(window, bands), sc, nt, tiles,
                     groups, warps, per_chunk, chunks, smem)


class DwF32Plan(NamedTuple):
    """How the float32 ``tap_conv_dw`` cuts one call, in the order its C plan
    reports. A block is (channel tile, tap group, chunk); its warps are
    ``taps`` taps of every kernel row times ``splits``, one item each in a
    round."""

    tiles: int  # 32 x 32 channel tiles of dW
    tap_groups: int  # groups of up to 16 taps of a kernel row, a block each
    taps: int  # taps of a group: ceil(kw / tap_groups)
    splits: int  # warps that share a tap, an item each: min(16 // taps, per_chunk)
    warps: int  # taps * splits
    chunks_per_k: int  # chunks of each candidate's B * ceil(Lp / 64) items
    per_chunk: int  # items of a chunk (the last one may hold fewer)
    chunks: int  # K * chunks_per_k
    smem: int  # dynamic shared memory of a block, bytes

    def scratch_elems(self, kh: int, kw: int, cin: int, cout: int) -> int:
        """float32 partials pass 1 writes: one [kh, kw, Cin, Cout] per chunk."""

        return self.chunks * kh * kw * cin * cout


@functools.lru_cache(maxsize=64)
def dw_f32_plan(K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int) -> DwF32Plan:
    """The launch plan of the float32 dW kernel, or a ``RuntimeError``
    through :func:`_raise_on` for a shape it cannot take.

    A block stages, for each kernel row and round of ``splits`` items, ct's
    64 rows and h's band of ``64 + taps - 1`` rows of its 32 x 32 channel
    tile for each item into a ring of ``DW_STAGES`` rounds, beside
    ``(splits - 1) * taps`` tiles where the splits sum; ``splits`` is
    ``min(16 // taps, per_chunk)``, or fewer where that passes
    ``MAX_SMEM_BYTES``. One block an SM: ``132 // (tiles * tap_groups)``
    chunks in all, aligned to K.
    """

    shape = f"K={K}, B={B}, Lp={Lp}, Cin={cin}, Cout={cout}, {kh}x{kw}"
    if min(K, B, Lp, cin, cout, kh, kw) <= 0 or kh % 2 == 0 or kw % 2 == 0:
        _raise_on(_INVALID_VALUE, "tap_conv_dw",
                  f"{shape}: every extent must be positive and the kernel size odd")
    tiles = -(-cin // DW_TILE) * -(-cout // DW_TILE)
    tap_groups = -(-kw // F32_MAX_WARPS)
    taps = -(-kw // tap_groups)
    # chunks of a candidate's items (none straddles two), one block an SM in all
    items = B * -(-Lp // F32_ROWS)
    per_k = min(items, -(-max(1, SMS // (tiles * tap_groups)) // K))
    per_chunk = -(-items // per_k)
    chunks_per_k = -(-items // per_chunk)
    if K * chunks_per_k > 65535:
        _raise_on(_INVALID_VALUE, "tap_conv_dw", f"{shape}: more than 65535 chunks")

    def smem_of(splits):
        return 4 * (DW_STAGES * splits * (2 * F32_ROWS + taps - 1) * DW_TILE
                    + (splits - 1) * taps * DW_TILE * DW_TILE)

    splits = min(F32_MAX_WARPS // taps, per_chunk)
    while smem_of(splits) > MAX_SMEM_BYTES:  # one split always fits
        splits -= 1
    smem = smem_of(splits)
    return DwF32Plan(tiles, tap_groups, taps, splits, taps * splits, chunks_per_k, per_chunk,
                     K * chunks_per_k, smem)


@functools.cache
def _fwd_fns():
    lib = _build.load(SOURCE)
    lib.tap_conv_fwd_plan.restype = _I
    lib.tap_conv_fwd_plan.argtypes = [_I] * 8 + [_P]
    lib.tap_conv_fwd.restype = _I
    lib.tap_conv_fwd.argtypes = [_P] * 6 + [_I] * 8 + [_P, _P]
    return lib


@functools.cache
def _mma_fns():
    lib = _build.load(SOURCE_MMA)
    lib.tap_conv_mma_plan.restype = _I
    lib.tap_conv_mma_plan.argtypes = [_I] * 9 + [_P]
    lib.tap_conv_fwd_mma.restype = _I
    lib.tap_conv_fwd_mma.argtypes = [_P] * 6 + [_I] * 8 + [_P, _P]
    lib.tap_conv_dh_mma.restype = _I
    lib.tap_conv_dh_mma.argtypes = [_P] * 5 + [_I] * 8 + [_P, _P]
    return lib


@functools.cache
def _bwd_fns():
    lib = _build.load(SOURCE_BWD)
    lib.tap_conv_dh_plan.restype = _I
    lib.tap_conv_dh_plan.argtypes = [_I] * 8 + [_P]
    lib.tap_conv_dh.restype = _I
    lib.tap_conv_dh.argtypes = [_P] * 5 + [_I] * 8 + [_P, _P]
    lib.tap_conv_dw_plan.restype = _I
    lib.tap_conv_dw_plan.argtypes = [_I] * 7 + [_P]
    lib.tap_conv_dw.restype = _I
    lib.tap_conv_dw.argtypes = [_P] * 6 + [_I] * 7 + [_P, _P]
    lib.tap_conv_dw_mma_plan.restype = _I
    lib.tap_conv_dw_mma_plan.argtypes = [_I] * 8 + [_P]
    lib.tap_conv_dw_mma.restype = _I
    lib.tap_conv_dw_mma.argtypes = [_P] * 6 + [_I] * 8 + [_P, _P]
    return lib


def dw_mma_plan_of_kernel(K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int,
                          p_max: int) -> Optional[DwMmaPlan]:
    """The plan ``csrc/tap_conv_bwd.cu`` itself makes, or None where it
    refuses the shape: what :func:`dw_mma_plan` mirrors (builds the library)."""

    out = (ctypes.c_int * len(DwMmaPlan._fields))()
    if _bwd_fns().tap_conv_dw_mma_plan(K, B, Lp, cin, cout, kh, kw, p_max, out) != 0:
        return None
    return DwMmaPlan(*out)


def fwd_f32_plan_of_kernel(K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int,
                           p_max: int) -> Optional[FwdF32Plan]:
    """The float32 forward plan ``csrc/tap_conv_fwd.cu`` itself makes, or
    None where it refuses the shape: what :func:`fwd_f32_plan` mirrors
    (builds the library)."""

    out = (ctypes.c_int * len(FwdF32Plan._fields))()
    if _fwd_fns().tap_conv_fwd_plan(K, B, Lp, cin, cout, kh, kw, p_max, out) != 0:
        return None
    return FwdF32Plan(*out)


def dh_f32_plan_of_kernel(K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int,
                          p_max: int) -> Optional[DhF32Plan]:
    """The float32 dh plan ``csrc/tap_conv_bwd.cu`` itself makes, or None
    where it refuses the shape: what :func:`dh_f32_plan` mirrors (builds the
    library)."""

    out = (ctypes.c_int * len(DhF32Plan._fields))()
    if _bwd_fns().tap_conv_dh_plan(K, B, Lp, cin, cout, kh, kw, p_max, out) != 0:
        return None
    return DhF32Plan(*out)


def dw_f32_plan_of_kernel(K: int, B: int, Lp: int, cin: int, cout: int, kh: int,
                          kw: int) -> Optional[DwF32Plan]:
    """The float32 dW plan ``csrc/tap_conv_bwd.cu`` itself makes, or None
    where it refuses the shape: what :func:`dw_f32_plan` mirrors."""

    out = (ctypes.c_int * len(DwF32Plan._fields))()
    if _bwd_fns().tap_conv_dw_plan(K, B, Lp, cin, cout, kh, kw, out) != 0:
        return None
    return DwF32Plan(*out)


def fold_mma_plan_of_kernel(sign: int, K: int, B: int, Lp: int, cin: int, cout: int, kh: int,
                            kw: int, p_max: int) -> Optional[FoldMmaPlan]:
    """The plan ``csrc/tap_conv_mma.cu`` itself makes, or None where it
    refuses the shape: what :func:`fold_mma_plan` mirrors (builds the library)."""

    out = (ctypes.c_int * len(FoldMmaPlan._fields))()
    if _mma_fns().tap_conv_mma_plan(sign, K, B, Lp, cin, cout, kh, kw, p_max, out) != 0:
        return None
    return FoldMmaPlan(*out)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its data does not start on 16 bytes (cp.async)."""

    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(name: str, x: torch.Tensor, kh: int, kw: int) -> None:
    """What every kernel needs of its [K, B, Lp, C] input and kernel size."""

    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the input must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: the input must be a contiguous [K, B, Lp, C] tensor")
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {kh}x{kw}")


def _check_geometry(name: str, geom: FoldGeometry, x: torch.Tensor, *others) -> int:
    """What every kernel needs of the geometry of its [K, B, Lp, C] input
    ``x``; returns ``geom.p_max``, the bound on its periods, which sizes the
    zero rows the kernels stage (``make_geometry``'s ``p_cap``, which is
    ``Lp - L`` there; ``make_dense_geometry``'s period, where ``Lp - L`` is
    ``(-L) % p`` and would be too small)."""

    K, Lp = int(x.shape[0]), int(x.shape[2])
    if geom.Lp != Lp:
        raise ValueError(f"{name}: the input has {Lp} rows, the geometry {geom.Lp}")
    for label, v in (("periods", geom.periods), ("cycles", geom.cycles)):
        if v.dtype != torch.int32 or tuple(v.shape) != (K,) or not v.is_contiguous():
            raise ValueError(f"{label} must be int32 [{K}], got {v.dtype} {tuple(v.shape)}")
    if any(t.device != x.device for t in (geom.periods, geom.cycles, *others)):
        raise ValueError(f"all {name} arguments must be on one device")
    return geom.p_max


def _raise_on(err: int, name: str, shape: str) -> None:
    if err != 0:
        # each kernel owns its capacity rules (channels per block, shared
        # memory) and rejects a shape beyond them with cudaErrorInvalidValue (1)
        raise RuntimeError(f"{name} launch failed with cudaError_t {err} at {shape}")


def tap_conv_cuda(
    h: torch.Tensor,
    geom: FoldGeometry,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Launch the forward kernel; every argument lies on one CUDA device.

    ``h`` [K, B, Lp, Cin] bf16 or float32; ``kernel`` [kh, kw, Cin, Cout] is
    rounded to ``h.dtype`` as in the plain version; ``bias`` [Cout]; ``geom``
    from :func:`make_geometry` or :func:`make_dense_geometry` over the same
    Lp. Returns [K, B, Lp, Cout] float32. The dtype picks the route, and neither route
    gives way to the other:

    - bf16: the tensor-core template ``tap_conv_fwd_mma`` (bf16 products are
      exact in float32, summed in float32). A shape it cannot take
      (:func:`fold_mma_plan`, with ``p_max = geom.p_max``) raises
      ``RuntimeError``.
    - float32: the CUDA-core kernel ``tap_conv_fwd``, whose float32 FMAs keep
      the products exact (the tensor cores would round them to TF32). A
      shape it cannot take (:func:`fwd_f32_plan`) raises ``RuntimeError``.

    ``launches`` counts both routes, ``launches_mma`` the tensor-core one;
    the kernel counts its own runs (:func:`kernel_runs`).
    """

    _check("tap_conv_cuda", h, kh, kw)
    K, B, Lp, Cin = h.shape
    if tuple(kernel.shape[:3]) != (kh, kw, Cin) or kernel.dim() != 4:
        raise ValueError(f"kernel must be [{kh}, {kw}, {Cin}, Cout], got {tuple(kernel.shape)}")
    Cout = int(kernel.shape[3])
    if tuple(bias.shape) != (Cout,):
        raise ValueError(f"bias must be [{Cout}], got {tuple(bias.shape)}")
    p_max = _check_geometry("tap_conv_cuda", geom, h, kernel, bias)

    mma = h.dtype == torch.bfloat16
    if mma:  # each raises on what its kernel cannot take
        fold_mma_plan(1, K, B, Lp, Cin, Cout, kh, kw, p_max)
    else:
        fwd_f32_plan(K, B, Lp, Cin, Cout, kh, kw, p_max)
    w = _aligned(kernel.to(h.dtype).contiguous())
    x = _aligned(h)
    b = bias.float().contiguous()
    out = torch.empty((K, B, Lp, Cout), dtype=torch.float32, device=h.device)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), geom.periods.data_ptr(),
            geom.cycles.data_ptr(), out.data_ptr())
    runs = _run_cell(h.device, "fwd_mma" if mma else "fwd_f32", kh, kw)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if mma:
            err = _mma_fns().tap_conv_fwd_mma(*ptrs, K, B, Lp, Cin, Cout, kh, kw, p_max, runs,
                                              stream)
        else:
            err = _fwd_fns().tap_conv_fwd(*ptrs, K, B, Lp, Cin, Cout, kh, kw, p_max, runs, stream)
    _raise_on(err, "tap_conv_fwd_mma" if mma else "tap_conv_fwd",
              f"K={K}, B={B}, Lp={Lp}, Cin={Cin}, Cout={Cout}, {kh}x{kw}")
    launches[f"{kh}x{kw}"] += 1
    if mma:
        launches_mma[f"{kh}x{kw}"] += 1
    return out


def tap_conv_dh_cuda(
    ct: torch.Tensor,
    geom: FoldGeometry,
    kernel: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Launch the dh-adjoint kernel: :func:`ops.fold.tap_conv_dh` on the card.

    ``ct`` [K, B, Lp, Cout] bf16 or float32; ``kernel`` [kh, kw, Cin, Cout]
    (the forward layout) is rounded to ``ct.dtype``. Returns [K, B, Lp, Cin]
    float32, exactly 0 at and past each fold extent; the caller casts it to
    the input's type. The routes are those of :func:`tap_conv_cuda`: bf16
    runs the tensor-core template ``tap_conv_dh_mma`` (its shape limits as
    there), float32 the CUDA-core kernel ``tap_conv_dh`` (its limits:
    :func:`dh_f32_plan`), with no fallback between them: a shape a route
    cannot take raises ``RuntimeError``. ``launches_dh`` counts both routes,
    ``launches_dh_mma`` the tensor-core one; the kernel counts its own runs
    (:func:`kernel_runs`).
    """

    _check("tap_conv_dh_cuda", ct, kh, kw)
    K, B, Lp, Cout = ct.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:2]) != (kh, kw) or kernel.shape[3] != Cout:
        raise ValueError(f"kernel must be [{kh}, {kw}, Cin, {Cout}], got {tuple(kernel.shape)}")
    Cin = int(kernel.shape[2])
    p_max = _check_geometry("tap_conv_dh_cuda", geom, ct, kernel)

    mma = ct.dtype == torch.bfloat16
    if mma:  # each raises on what its kernel cannot take
        fold_mma_plan(-1, K, B, Lp, Cin, Cout, kh, kw, p_max)
    else:
        dh_f32_plan(K, B, Lp, Cin, Cout, kh, kw, p_max)
    w = _aligned(kernel.to(ct.dtype).contiguous())
    x = _aligned(ct)
    dh = torch.empty((K, B, Lp, Cin), dtype=torch.float32, device=ct.device)
    ptrs = (x.data_ptr(), w.data_ptr(), geom.periods.data_ptr(), geom.cycles.data_ptr(),
            dh.data_ptr())
    runs = _run_cell(ct.device, "dh_mma" if mma else "dh_f32", kh, kw)
    with torch.cuda.device(ct.device):
        stream = torch.cuda.current_stream(ct.device).cuda_stream
        if mma:
            err = _mma_fns().tap_conv_dh_mma(*ptrs, K, B, Lp, Cin, Cout, kh, kw, p_max, runs,
                                             stream)
        else:
            err = _bwd_fns().tap_conv_dh(*ptrs, K, B, Lp, Cin, Cout, kh, kw, p_max, runs, stream)
    _raise_on(err, "tap_conv_dh_mma" if mma else "tap_conv_dh",
              f"K={K}, B={B}, Lp={Lp}, Cin={Cin}, Cout={Cout}, {kh}x{kw}")
    launches_dh[f"{kh}x{kw}"] += 1
    if mma:
        launches_dh_mma[f"{kh}x{kw}"] += 1
    return dh


def tap_conv_dw_cuda(
    h: torch.Tensor,
    geom: FoldGeometry,
    ct: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Launch the weight-gradient kernel: :func:`ops.fold.tap_weight_grad` on the card.

    ``h`` [K, B, Lp, Cin] and ``ct`` [K, B, Lp, Cout], both bf16 or both
    float32. Returns dW [kh, kw, Cin, Cout] float32. The dtype picks the
    route, and neither route gives way to the other:

    - bf16: the tensor-core kernel ``tap_conv_dw_mma`` (bf16 products are
      exact in float32, summed in float32). A shape it cannot take
      (:func:`dw_mma_plan`, with ``p_max = geom.p_max``) raises
      ``RuntimeError``.
    - float32: the CUDA-core kernel ``tap_conv_dw``, whose float32 FMAs keep
      the products exact (the tensor cores would round them to TF32). Its
      plan is :func:`dw_f32_plan`.

    Both sum per-chunk partials in a fixed order (no float atomics), so the
    result is the same from run to run; the wrapper allocates their scratch
    buffer. ``launches_dw`` counts both routes, ``launches_dw_mma`` the
    tensor-core one; the first pass counts its own runs (:func:`kernel_runs`).
    """

    _check("tap_conv_dw_cuda", h, kh, kw)
    _check("tap_conv_dw_cuda", ct, kh, kw)
    K, B, Lp, Cin = h.shape
    Cout = int(ct.shape[3])
    if tuple(ct.shape[:3]) != (K, B, Lp) or ct.dtype != h.dtype:
        raise ValueError(f"ct must be [{K}, {B}, {Lp}, Cout] in {h.dtype}, "
                         f"got {ct.dtype} {tuple(ct.shape)}")
    p_max = _check_geometry("tap_conv_dw_cuda", geom, h, ct)

    mma = h.dtype == torch.bfloat16
    if mma:
        chunks = dw_mma_plan(K, B, Lp, Cin, Cout, kh, kw, p_max).chunks
    else:
        chunks = dw_f32_plan(K, B, Lp, Cin, Cout, kh, kw).chunks
    lib = _bwd_fns()
    partial = torch.empty((chunks, kh, kw, Cin, Cout), dtype=torch.float32, device=h.device)
    dw = torch.empty((kh, kw, Cin, Cout), dtype=torch.float32, device=h.device)
    x, y = _aligned(h), _aligned(ct)
    ptrs = (x.data_ptr(), y.data_ptr(), geom.periods.data_ptr(), geom.cycles.data_ptr(),
            partial.data_ptr(), dw.data_ptr())
    runs = _run_cell(h.device, "dw_mma" if mma else "dw_f32", kh, kw)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if mma:
            err = lib.tap_conv_dw_mma(*ptrs, K, B, Lp, Cin, Cout, kh, kw, p_max, runs, stream)
        else:
            err = lib.tap_conv_dw(*ptrs, K, B, Lp, Cin, Cout, kh, kw, runs, stream)
    _raise_on(err, "tap_conv_dw_mma" if mma else "tap_conv_dw",
              f"K={K}, B={B}, Lp={Lp}, Cin={Cin}, Cout={Cout}, {kh}x{kw}")
    launches_dw[f"{kh}x{kw}"] += 1
    if mma:
        launches_dw_mma[f"{kh}x{kw}"] += 1
    return dw


class TapConv(torch.autograd.Function):
    """The fold conv with the JAX package's custom VJP (``ops/fold.py:303-332``).

    The backward takes the bf16 order of the XLA form: the cotangent is
    rounded to ``h.dtype`` once and feeds dh and dW; dh is cast to
    ``h.dtype``; dW is summed in float32; db is summed from the float32
    cotangent before any rounding. It keeps ``h``, the kernel and the
    geometry's int32 tensors, not the tap stack.

    ``dense`` takes the rounding of the JAX package's dense form
    (``dense_fold_conv``, ``ops/fold.py:408-421``), whose convolution runs
    in ``h.dtype``: the sum is rounded to ``h.dtype`` before the float32
    bias is added, and dW comes back rounded to ``h.dtype`` (the transpose
    of a bf16 convolution is a bf16 convolution). In float32 both roundings
    are the identity and the two forms give the same numbers, so the dense
    form adds the bias in the kernel there as the tap form does.
    """

    @staticmethod
    def forward(ctx, h, kernel, bias, geom: FoldGeometry, kh: int, kw: int, dense: bool = False):
        ctx.save_for_backward(h, kernel)
        ctx.geom, ctx.kh, ctx.kw, ctx.dense = geom, kh, kw, dense
        conv = tap_conv_cuda if h.device.type == "cuda" else tap_conv_plain
        if not dense or h.dtype == torch.float32:
            return conv(h, geom, kernel, bias, kh, kw)
        out = conv(h, geom, kernel, torch.zeros_like(bias, dtype=torch.float32), kh, kw)
        return out.to(h.dtype).float() + bias.float()

    @staticmethod
    def backward(ctx, ct):
        h, kernel = ctx.saved_tensors
        geom, kh, kw = ctx.geom, ctx.kh, ctx.kw
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        ct_dt = ct.to(h.dtype).contiguous()
        dh = dw = db = None
        if h.device.type == "cuda":
            if need_h:
                dh = tap_conv_dh_cuda(ct_dt, geom, kernel, kh, kw)
            if need_w:
                dw = tap_conv_dw_cuda(h, geom, ct_dt, kh, kw)
        else:
            if need_h:
                dh = tap_conv_dh_plain(ct_dt, geom, kernel, kh, kw)
            if need_w:
                dw = tap_weight_grad_plain(h, geom, ct_dt, kh, kw)
        if dh is not None:
            dh = dh.to(h.dtype)
        if dw is not None:
            dw = (dw.to(h.dtype) if ctx.dense else dw).to(kernel.dtype)
        if need_b:
            db = ct.sum(dim=(0, 1, 2))
        return dh, dw, db, None, None, None, None


def tap_conv(
    h: torch.Tensor,
    geom: FoldGeometry,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Fold-grid Conv2d (see :func:`flow_timesnet_tpu_torch.ops.fold.tap_conv`)
    with the JAX package's backward.

    A CUDA tensor goes through the kernels, a CPU tensor through the plain
    versions; any other device raises.
    """

    if h.device.type not in ("cuda", "cpu"):
        raise ValueError(f"tap_conv runs on cuda or cpu tensors, got {h.device}")
    return TapConv.apply(h.contiguous(), kernel, bias, geom, kh, kw)


def dense_fold_conv(
    h: torch.Tensor,
    geom: FoldGeometry,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """The exact-extent fold Conv2d of one static period: the JAX package's
    ``dense_fold_conv`` (``ops/fold.py:389-421``), the frozen-period path's.

    ``h`` [1, B, total, Cin] over :func:`make_dense_geometry`'s geometry.
    The masked taps at ``K = 1`` and ``Lp = total`` are the zero-padded
    Conv2d over the ``[cycles, p]`` grid, so this is :class:`TapConv` on the
    same kernels (a CUDA tensor) or plain versions (a CPU tensor) as
    :func:`tap_conv`, with the dense form's bf16 rounding (see ``dense``
    there). Returns [1, B, total, Cout] float32.
    """

    if not geom.dense:
        raise ValueError("dense_fold_conv needs make_dense_geometry's geometry")
    if h.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dense_fold_conv runs on cuda or cpu tensors, got {h.device}")
    return TapConv.apply(h.contiguous(), kernel, bias, geom, kh, kw, True)
