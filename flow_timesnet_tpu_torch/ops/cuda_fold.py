"""Fold convolution on the card: the wrapper around ``csrc/tap_conv_fwd.cu``.

Counterpart of ``flow_timesnet_tpu/ops/pallas_fold.py::tap_conv_pallas``.
:func:`tap_conv` sends a CUDA tensor through the hand-written kernel (or
raises) and a CPU tensor through the plain version,
:func:`flow_timesnet_tpu_torch.ops.fold.tap_conv`. The two compute the same
function; ``chip_smoke.py`` holds the kernel against the plain version on
the card, and the CPU tests hold the plain version against the JAX package.

The kernel is built with ``nvcc`` at its first launch (see ``ops/_build.py``);
importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from . import _build
from .fold import FoldGeometry
from .fold import tap_conv as tap_conv_plain

SOURCE = "tap_conv_fwd.cu"

# Launches of the kernel, keyed by kernel size ("3x3", ...). Only the CUDA
# path counts; the plain version never does.
launches: Counter = Counter()


@functools.cache
def _kernel_fn():
    fn = _build.load(SOURCE).tap_conv_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def tap_conv_cuda(
    h: torch.Tensor,
    periods: torch.Tensor,
    cycles: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Launch the fold-conv kernel; every argument lies on one CUDA device.

    ``h`` [K, B, Lp, Cin] bf16 or float32; ``kernel`` [kh, kw, Cin, Cout] is
    rounded to ``h.dtype`` as in the plain version; ``bias`` [Cout];
    ``periods``/``cycles`` [K] int32 from :func:`make_geometry`. Returns
    [K, B, Lp, Cout] float32.
    """

    if h.device.type != "cuda":
        raise ValueError(f"tap_conv_cuda needs CUDA tensors, got {h.device}")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"h must be bfloat16 or float32, got {h.dtype}")
    if h.dim() != 4 or not h.is_contiguous():
        raise ValueError("h must be a contiguous [K, B, Lp, Cin] tensor")
    K, B, Lp, Cin = h.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {kh}x{kw}")
    if tuple(kernel.shape[:3]) != (kh, kw, Cin) or kernel.dim() != 4:
        raise ValueError(f"kernel must be [{kh}, {kw}, {Cin}, Cout], got {tuple(kernel.shape)}")
    Cout = int(kernel.shape[3])
    if tuple(bias.shape) != (Cout,):
        raise ValueError(f"bias must be [{Cout}], got {tuple(bias.shape)}")
    for name, v in (("periods", periods), ("cycles", cycles)):
        if v.dtype != torch.int32 or tuple(v.shape) != (K,):
            raise ValueError(f"{name} must be int32 [{K}], got {v.dtype} {tuple(v.shape)}")
    if any(t.device != h.device for t in (kernel, bias, periods, cycles)):
        raise ValueError("all tap_conv_cuda arguments must be on h's device")

    w = kernel.to(h.dtype).contiguous()
    b = bias.float().contiguous()
    periods = periods.contiguous()
    cycles = cycles.contiguous()
    out = torch.empty((K, B, Lp, Cout), dtype=torch.float32, device=h.device)
    fn = _kernel_fn()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(
            h.data_ptr(), int(h.dtype == torch.bfloat16), w.data_ptr(), b.data_ptr(),
            periods.data_ptr(), cycles.data_ptr(), out.data_ptr(),
            K, B, Lp, Cin, Cout, kh, kw, stream,
        )
    if err != 0:
        # the kernel owns its capacity rules (Cout per block, shared memory)
        # and rejects a shape beyond them with cudaErrorInvalidValue (1)
        raise RuntimeError(
            f"tap_conv_fwd launch failed with cudaError_t {err} at K={K}, B={B}, "
            f"Lp={Lp}, Cin={Cin}, Cout={Cout}, {kh}x{kw}"
        )
    launches[f"{kh}x{kw}"] += 1
    return out


def tap_conv(
    h: torch.Tensor,
    geom: FoldGeometry,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Fold-grid Conv2d (see :func:`flow_timesnet_tpu_torch.ops.fold.tap_conv`).

    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version; any other device raises.
    """

    if h.device.type == "cuda":
        return tap_conv_cuda(
            h.contiguous(), geom.periods, geom.cycles, kernel, bias, kh, kw
        )
    if h.device.type == "cpu":
        return tap_conv_plain(h, geom, kernel, bias, kh, kw)
    raise ValueError(f"tap_conv runs on cuda or cpu tensors, got {h.device}")
