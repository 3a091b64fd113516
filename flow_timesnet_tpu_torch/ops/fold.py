"""Period-fold 2D convolution as masked dilated taps: the plain PyTorch version.

Counterpart of ``flow_timesnet_tpu/ops/fold.py`` (forward parts). For fold
position ``t = c * p + j`` the Conv2d neighbour ``(c + dc, j + dj)`` is time
index ``t + dc * p + dj``, so a 2D convolution over the ``[cycles, p]`` fold
is a sum over ``kh * kw`` taps of time-shifted copies of the sequence, where
a tap is valid iff

    0 <= (t mod p) + dj < p        (stays inside the period row)
    0 <= (t div p) + dc < cycles   (stays inside the cycle grid)

and invalid taps contribute zero (Conv2d's implicit zero padding). Shapes stay
``[K, B, Lp, C]`` whatever the periods, and the periods stay int32 tensors,
so the forward never synchronises with the host.

:func:`tap_conv` here is the reference arithmetic for the CUDA kernel in
``ops/cuda_fold.py``: the CPU path runs it, and the card checks against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FoldGeometry(NamedTuple):
    """Per-candidate fold geometry over a static padded time axis."""

    periods: torch.Tensor  # [K] int32
    total: torch.Tensor  # [K] int32: L + pad (fold extent per candidate)
    cycles: torch.Tensor  # [K] int32
    col: torch.Tensor  # [K, Lp] int32: t mod p
    row: torch.Tensor  # [K, Lp] int32: t div p
    Lp: int  # static padded length (>= max total)
    L: int  # original sequence length


def make_geometry(periods: torch.Tensor, L: int, p_cap: int) -> FoldGeometry:
    """Fold coordinates for each candidate period.

    Periods are clamped into ``[1, p_cap]``, so ``Lp = L + p_cap`` covers
    every padded extent and every valid tap reads inside ``[0, Lp)``.
    """

    cap = max(1, int(p_cap))
    p = periods.to(torch.int32).clamp(1, cap)
    pad = torch.remainder(-L, p)
    total = L + pad
    cycles = torch.div(total, p, rounding_mode="floor")
    Lp = L + cap
    t = torch.arange(Lp, dtype=torch.int32, device=p.device)[None, :]
    col = torch.remainder(t, p[:, None])
    row = torch.div(t, p[:, None], rounding_mode="floor")
    return FoldGeometry(
        periods=p, total=total.to(torch.int32), cycles=cycles.to(torch.int32),
        col=col.to(torch.int32), row=row.to(torch.int32), Lp=Lp, L=int(L),
    )


def pad_time(x: torch.Tensor, L: int, Lp: int) -> torch.Tensor:
    """Zero-pad [B, L, C] on the time axis to the static fold length Lp."""

    return torch.nn.functional.pad(x, (0, 0, 0, Lp - L))


def _fwd_mask(geom: FoldGeometry, dc: int, dj: int) -> torch.Tensor:
    """Forward tap validity at output position t: the Conv2d neighbour
    ``(row + dc, col + dj)`` stays inside the [cycles, p] grid. [K, Lp] bool."""

    row_ok = ((geom.row + dc) >= 0) & ((geom.row + dc) < geom.cycles[:, None])
    col_ok = ((geom.col + dj) >= 0) & ((geom.col + dj) < geom.periods[:, None])
    return row_ok & col_ok


def tap_conv(
    h: torch.Tensor,
    geom: FoldGeometry,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Fold-grid Conv2d with 'same' zero padding via masked time-shifted taps.

    Args:
        h: [K, B, Lp, Cin] candidate-batched features. Positions beyond a
            candidate's fold extent may hold anything: a valid tap never
            reads them.
        kernel: [kh, kw, Cin, Cout] (HWIO; rows run along the cycle axis).
        bias: [Cout].

    Returns [K, B, Lp, Cout] float32. As in the JAX package, the kernel is
    rounded to ``h.dtype`` first; the products of the (possibly bf16) values
    are then summed in float32 and the float32 bias is added last.
    """

    K, B, Lp, Cin = h.shape
    rh, rw = kh // 2, kw // 2
    m = rh * (Lp - geom.L)  # largest |dc * p| for p <= Lp - L
    pad = m + rw
    padded = torch.nn.functional.pad(h.float(), (0, 0, pad, pad))
    w = kernel.to(h.dtype).float()
    t = torch.arange(Lp, device=h.device)
    out = None
    for i, dc in enumerate(range(-rh, rh + 1)):
        starts = pad + dc * geom.periods.long()  # [K]
        taps = []
        for dj in range(-rw, rw + 1):
            idx = (starts[:, None] + dj + t[None, :])[:, None, :, None]
            tap = torch.gather(padded, 2, idx.expand(K, B, Lp, Cin))
            mask = _fwd_mask(geom, dc, dj)[:, None, :, None]
            taps.append(tap * mask.to(tap.dtype))
        term = torch.cat(taps, dim=-1) @ w[i].reshape(kw * Cin, -1)
        out = term if out is None else out + term
    return out + bias.float()


def pointwise_conv(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """1x1 conv == per-position channel matmul; kernel [Cin, Cout].

    The JAX package multiplies in ``h.dtype`` with float32 accumulation and
    adds the bias in float32 before any cast. A bf16 ``torch.matmul`` would
    round its output to bf16 before the bias, so the bf16 values are upcast
    (exactly) and multiplied in float32 instead.
    """

    return h.float() @ kernel.to(h.dtype).float() + bias.float()


def combine_residuals(deltas: torch.Tensor, weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x + sum_k w[b, k] * delta_k; deltas [K, B, L, C], weights [B, K]."""

    combined = torch.einsum("kblc,bk->blc", deltas.float(), weights.to(deltas.dtype).float())
    return x + combined.to(x.dtype)
