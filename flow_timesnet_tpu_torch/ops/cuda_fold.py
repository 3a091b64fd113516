"""Fold convolution on the card: the wrappers around ``csrc/tap_conv_fwd.cu``
and ``csrc/tap_conv_bwd.cu``, and the autograd Function that joins them.

Counterpart of ``flow_timesnet_tpu/ops/pallas_fold.py::tap_conv_pallas`` and
of the custom VJP of ``flow_timesnet_tpu/ops/fold.py::tap_conv``.
:func:`tap_conv` runs :class:`TapConv`: on a CUDA tensor its forward is the
forward kernel and its backward the dh-adjoint and dW kernels (or a launch
raises); on a CPU tensor both are the plain versions of ``ops/fold.py``.
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
from typing import NamedTuple, Optional

import torch

from . import _build
from .fold import FoldGeometry
from .fold import tap_conv as tap_conv_plain
from .fold import tap_conv_dh as tap_conv_dh_plain
from .fold import tap_weight_grad as tap_weight_grad_plain

SOURCE = "tap_conv_fwd.cu"
SOURCE_BWD = "tap_conv_bwd.cu"

# Launches of each kernel, keyed by kernel size ("3x3", ...). Only the CUDA
# path counts; the plain versions never do.
launches: Counter = Counter()  # forward
launches_dh: Counter = Counter()  # dh adjoint
launches_dw: Counter = Counter()  # weight gradient, either route
launches_dw_mma: Counter = Counter()  # weight gradient, the bf16 tensor-core route

_P, _I = ctypes.c_void_p, ctypes.c_int
_INVALID_VALUE = 1  # cudaErrorInvalidValue: what a kernel returns for a shape it cannot take

# The plan of the bf16 dW kernel, constant for constant as in
# csrc/tap_conv_bwd.cu (dw_mma_plan); a card test holds the two together.
MMA_ROWS = 16  # rows of a sequence per mma k-step
MMA_WARP_TILE = 32  # a warp's dW tile: 32 ci x 32 co
MMA_ROW_PAD = 8  # bf16 elements added to each staged row
MMA_MAX_WARPS = 16  # one warp per tap of a kernel row
MMA_STAGES = 4  # staged sequences in a block's ring of buffers
MMA_TARGET_WARPS = 8 * 132  # pass 1: about 8 warps per SM of an H100 in all
MAX_SMEM_BYTES = 232448  # the most shared memory one block may use


class DwMmaPlan(NamedTuple):
    """How ``tap_conv_dw_mma`` cuts one call, in the order its C plan reports."""

    lp_pad: int  # Lp rounded up to whole 16-row k-steps
    pad: int  # zero rows on each side of a staged h sequence
    tiles: int  # 32 x 32 channel tiles of dW
    chunks_per_k: int  # chunks of each candidate's B sequences
    per_chunk: int  # sequences of a chunk (the last one may hold fewer)
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

    A block stages one sequence of h between ``pad = (kh // 2) * p_max + kw // 2``
    zero rows on each side, ``MMA_STAGES`` times (a ring), beside ct, rows padded
    by ``MMA_ROW_PAD`` elements, plus its B-fragment masks (8 bytes a lane,
    warp and k-step) and its row/col table. Chunks never straddle two
    candidates, and hold as many sequences as about ``MMA_TARGET_WARPS``
    warps in all leave to each.
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
    if why is None:
        lp_pad = -(-Lp // MMA_ROWS) * MMA_ROWS
        pad = (kh // 2) * p_max + kw // 2
        smem = (2 * MMA_STAGES * ((lp_pad + 2 * pad) * (cin + MMA_ROW_PAD)
                                  + lp_pad * (cout + MMA_ROW_PAD))
                + 8 * kw * (lp_pad // MMA_ROWS) * 32 + 2 * 4 * lp_pad)
        if smem > MAX_SMEM_BYTES:
            why = f"a block would need {smem} bytes of shared memory, above {MAX_SMEM_BYTES}"
    if why is not None:
        _raise_on(_INVALID_VALUE, "tap_conv_dw_mma", f"{shape}: {why}")
    tiles = -(-cin // MMA_WARP_TILE) * -(-cout // MMA_WARP_TILE)
    want = max(1, MMA_TARGET_WARPS // (kh * tiles * kw))  # chunks in all
    per_k = min(B, -(-want // K))
    per_chunk = -(-B // per_k)
    chunks_per_k = -(-B // per_chunk)
    if K * chunks_per_k > 65535:
        _raise_on(_INVALID_VALUE, "tap_conv_dw_mma", f"{shape}: more than 65535 chunks")
    return DwMmaPlan(lp_pad, pad, tiles, chunks_per_k, per_chunk, kw, smem, K * chunks_per_k)


@functools.cache
def _kernel_fn():
    fn = _build.load(SOURCE).tap_conv_fwd
    fn.restype = _I
    fn.argtypes = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    return fn


@functools.cache
def _bwd_fns():
    lib = _build.load(SOURCE_BWD)
    lib.tap_conv_dh.restype = _I
    lib.tap_conv_dh.argtypes = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.tap_conv_dw_chunks.restype = _I
    lib.tap_conv_dw_chunks.argtypes = [_I, _I, _I]
    lib.tap_conv_dw.restype = _I
    lib.tap_conv_dw.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.tap_conv_dw_mma_plan.restype = _I
    lib.tap_conv_dw_mma_plan.argtypes = [_I] * 8 + [_P]
    lib.tap_conv_dw_mma.restype = _I
    lib.tap_conv_dw_mma.argtypes = [_P] * 6 + [_I] * 8 + [_P]
    return lib


def dw_mma_plan_of_kernel(K: int, B: int, Lp: int, cin: int, cout: int, kh: int, kw: int,
                          p_max: int) -> Optional[DwMmaPlan]:
    """The plan ``csrc/tap_conv_bwd.cu`` itself makes, or None where it
    refuses the shape: what :func:`dw_mma_plan` mirrors (builds the library)."""

    out = (ctypes.c_int * len(DwMmaPlan._fields))()
    if _bwd_fns().tap_conv_dw_mma_plan(K, B, Lp, cin, cout, kh, kw, p_max, out) != 0:
        return None
    return DwMmaPlan(*out)


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


def _check_geometry(name: str, K: int, periods, cycles, device, *others) -> None:
    for label, v in (("periods", periods), ("cycles", cycles)):
        if v.dtype != torch.int32 or tuple(v.shape) != (K,) or not v.is_contiguous():
            raise ValueError(f"{label} must be int32 [{K}], got {v.dtype} {tuple(v.shape)}")
    if any(t.device != device for t in (periods, cycles, *others)):
        raise ValueError(f"all {name} arguments must be on one device")


def _raise_on(err: int, name: str, shape: str) -> None:
    if err != 0:
        # each kernel owns its capacity rules (channels per block, shared
        # memory) and rejects a shape beyond them with cudaErrorInvalidValue (1)
        raise RuntimeError(f"{name} launch failed with cudaError_t {err} at {shape}")


def tap_conv_cuda(
    h: torch.Tensor,
    periods: torch.Tensor,
    cycles: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Launch the forward kernel; every argument lies on one CUDA device.

    ``h`` [K, B, Lp, Cin] bf16 or float32; ``kernel`` [kh, kw, Cin, Cout] is
    rounded to ``h.dtype`` as in the plain version; ``bias`` [Cout];
    ``periods``/``cycles`` [K] int32 from :func:`make_geometry`. Returns
    [K, B, Lp, Cout] float32.
    """

    _check("tap_conv_cuda", h, kh, kw)
    K, B, Lp, Cin = h.shape
    if tuple(kernel.shape[:3]) != (kh, kw, Cin) or kernel.dim() != 4:
        raise ValueError(f"kernel must be [{kh}, {kw}, {Cin}, Cout], got {tuple(kernel.shape)}")
    Cout = int(kernel.shape[3])
    if tuple(bias.shape) != (Cout,):
        raise ValueError(f"bias must be [{Cout}], got {tuple(bias.shape)}")
    _check_geometry("tap_conv_cuda", K, periods, cycles, h.device, kernel, bias)

    w = kernel.to(h.dtype).contiguous()
    b = bias.float().contiguous()
    out = torch.empty((K, B, Lp, Cout), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _kernel_fn()(
            h.data_ptr(), int(h.dtype == torch.bfloat16), w.data_ptr(), b.data_ptr(),
            periods.data_ptr(), cycles.data_ptr(), out.data_ptr(),
            K, B, Lp, Cin, Cout, kh, kw, stream,
        )
    _raise_on(err, "tap_conv_fwd", f"K={K}, B={B}, Lp={Lp}, Cin={Cin}, Cout={Cout}, {kh}x{kw}")
    launches[f"{kh}x{kw}"] += 1
    return out


def tap_conv_dh_cuda(
    ct: torch.Tensor,
    periods: torch.Tensor,
    cycles: torch.Tensor,
    kernel: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Launch the dh-adjoint kernel: :func:`ops.fold.tap_conv_dh` on the card.

    ``ct`` [K, B, Lp, Cout] bf16 or float32; ``kernel`` [kh, kw, Cin, Cout]
    (the forward layout) is rounded to ``ct.dtype``. Returns [K, B, Lp, Cin]
    float32; the caller casts it to the input's type.
    """

    _check("tap_conv_dh_cuda", ct, kh, kw)
    K, B, Lp, Cout = ct.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:2]) != (kh, kw) or kernel.shape[3] != Cout:
        raise ValueError(f"kernel must be [{kh}, {kw}, Cin, {Cout}], got {tuple(kernel.shape)}")
    Cin = int(kernel.shape[2])
    _check_geometry("tap_conv_dh_cuda", K, periods, cycles, ct.device, kernel)

    w = kernel.to(ct.dtype).contiguous()
    dh = torch.empty((K, B, Lp, Cin), dtype=torch.float32, device=ct.device)
    with torch.cuda.device(ct.device):
        stream = torch.cuda.current_stream(ct.device).cuda_stream
        err = _bwd_fns().tap_conv_dh(
            ct.data_ptr(), int(ct.dtype == torch.bfloat16), w.data_ptr(),
            periods.data_ptr(), cycles.data_ptr(), dh.data_ptr(),
            K, B, Lp, Cin, Cout, kh, kw, stream,
        )
    _raise_on(err, "tap_conv_dh", f"K={K}, B={B}, Lp={Lp}, Cin={Cin}, Cout={Cout}, {kh}x{kw}")
    launches_dh[f"{kh}x{kw}"] += 1
    return dh


def tap_conv_dw_cuda(
    h: torch.Tensor,
    periods: torch.Tensor,
    cycles: torch.Tensor,
    ct: torch.Tensor,
    kh: int,
    kw: int,
    p_max: Optional[int] = None,
) -> torch.Tensor:
    """Launch the weight-gradient kernel: :func:`ops.fold.tap_weight_grad` on the card.

    ``h`` [K, B, Lp, Cin] and ``ct`` [K, B, Lp, Cout], both bf16 or both
    float32. Returns dW [kh, kw, Cin, Cout] float32. The dtype picks the
    route, and neither route gives way to the other:

    - bf16: the tensor-core kernel ``tap_conv_dw_mma`` (bf16 products are
      exact in float32, summed in float32). A shape it cannot take
      (:func:`dw_mma_plan`) raises ``RuntimeError``. ``p_max`` bounds the
      periods (``make_geometry``'s ``p_cap``; default ``Lp - 1``, which
      holds for every geometry) and sizes the zero rows it stages.
    - float32: the CUDA-core kernel ``tap_conv_dw``, whose float32 FMAs keep
      the products exact (the tensor cores would round them to TF32).

    Both sum per-chunk partials in a fixed order (no float atomics), so the
    result is the same from run to run; the wrapper allocates their scratch
    buffer. ``launches_dw`` counts both routes, ``launches_dw_mma`` the
    tensor-core one.
    """

    _check("tap_conv_dw_cuda", h, kh, kw)
    _check("tap_conv_dw_cuda", ct, kh, kw)
    K, B, Lp, Cin = h.shape
    Cout = int(ct.shape[3])
    if tuple(ct.shape[:3]) != (K, B, Lp) or ct.dtype != h.dtype:
        raise ValueError(f"ct must be [{K}, {B}, {Lp}, Cout] in {h.dtype}, "
                         f"got {ct.dtype} {tuple(ct.shape)}")
    _check_geometry("tap_conv_dw_cuda", K, periods, cycles, h.device, ct)

    lib = _bwd_fns()
    mma = h.dtype == torch.bfloat16
    p_max = max(1, Lp - 1) if p_max is None else int(p_max)
    if mma:
        chunks = dw_mma_plan(K, B, Lp, Cin, Cout, kh, kw, p_max).chunks
    else:
        chunks = lib.tap_conv_dw_chunks(K, B, kh)
    partial = torch.empty((chunks, kh, kw, Cin, Cout), dtype=torch.float32, device=h.device)
    dw = torch.empty((kh, kw, Cin, Cout), dtype=torch.float32, device=h.device)
    ptrs = (h.data_ptr(), ct.data_ptr(), periods.data_ptr(), cycles.data_ptr(),
            partial.data_ptr(), dw.data_ptr())
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if mma:
            err = lib.tap_conv_dw_mma(*ptrs, K, B, Lp, Cin, Cout, kh, kw, p_max, stream)
        else:
            err = lib.tap_conv_dw(*ptrs, K, B, Lp, Cin, Cout, kh, kw, stream)
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
    """

    @staticmethod
    def forward(ctx, h, kernel, bias, geom: FoldGeometry, kh: int, kw: int):
        ctx.save_for_backward(h, kernel)
        ctx.geom, ctx.kh, ctx.kw = geom, kh, kw
        if h.device.type == "cuda":
            return tap_conv_cuda(h, geom.periods, geom.cycles, kernel, bias, kh, kw)
        return tap_conv_plain(h, geom, kernel, bias, kh, kw)

    @staticmethod
    def backward(ctx, ct):
        h, kernel = ctx.saved_tensors
        geom, kh, kw = ctx.geom, ctx.kh, ctx.kw
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        ct_dt = ct.to(h.dtype).contiguous()
        dh = dw = db = None
        if h.device.type == "cuda":
            if need_h:
                dh = tap_conv_dh_cuda(ct_dt, geom.periods, geom.cycles, kernel, kh, kw)
            if need_w:
                dw = tap_conv_dw_cuda(h, geom.periods, geom.cycles, ct_dt, kh, kw,
                                      p_max=geom.Lp - geom.L)
        else:
            if need_h:
                dh = tap_conv_dh_plain(ct_dt, geom, kernel, kh, kw)
            if need_w:
                dw = tap_weight_grad_plain(h, geom, ct_dt, kh, kw)
        if dh is not None:
            dh = dh.to(h.dtype)
        if dw is not None:
            dw = dw.to(kernel.dtype)
        if need_b:
            db = ct.sum(dim=(0, 1, 2))
        return dh, dw, db, None, None, None


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
