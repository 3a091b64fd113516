"""Period-fold 2D convolution as masked dilated taps: the plain PyTorch version.

Counterpart of ``flow_timesnet_tpu/ops/fold.py`` (the masked tap conv, its
adjoint and its weight gradient; the dense frozen-period conv is not ported
yet). For fold
position ``t = c * p + j`` the Conv2d neighbour ``(c + dc, j + dj)`` is time
index ``t + dc * p + dj``, so a 2D convolution over the ``[cycles, p]`` fold
is a sum over ``kh * kw`` taps of time-shifted copies of the sequence, where
a tap is valid iff

    0 <= (t mod p) + dj < p        (stays inside the period row)
    0 <= (t div p) + dc < cycles   (stays inside the cycle grid)

and invalid taps contribute zero (Conv2d's implicit zero padding). Shapes stay
``[K, B, Lp, C]`` whatever the periods, and the periods stay int32 tensors,
so the forward never synchronises with the host.

The adjoint is the same masked-shift sum with negated shifts and the
transposed masks of :func:`_bwd_mask`; the weight gradient contracts the
forward taps with the cotangent. :func:`tap_conv`, :func:`tap_conv_dh` and
:func:`tap_weight_grad` are the reference arithmetic for the CUDA kernels in
``ops/cuda_fold.py``: the CPU path runs them, and the card checks against
them.
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


def _bwd_mask(geom: FoldGeometry, dj: int) -> torch.Tensor:
    """Transposed tap validity at input position s, the same for every dc.

    A forward tap (dc, dj) carries ct[t] to s = t + dc*p + dj iff the forward
    mask held at t. Since dc*p = 0 mod p, col(t) = (col(s) - dj) mod p and
    row(t) + dc = floor((s - dj) / p), so the condition needs no dc. Floor
    semantics, as numpy's: ``torch.remainder`` and floor division. A t
    outside [0, Lp) is the caller's zero padding. [K, Lp] bool.
    """

    p = geom.periods[:, None]
    s_idx = torch.arange(geom.Lp, dtype=torch.int32, device=p.device)[None, :]
    c2 = torch.remainder(geom.col - dj, p)
    col_ok = ((c2 + dj) >= 0) & ((c2 + dj) < p)
    r2 = torch.div(s_idx - dj, p, rounding_mode="floor")
    row_ok = (r2 >= 0) & (r2 < geom.cycles[:, None])
    return col_ok & row_ok


def _row_taps(padded: torch.Tensor, geom: FoldGeometry, pad: int, dc: int, kw: int,
              sign: int) -> torch.Tensor:
    """The kw masked taps of kernel row dc, stacked on channels: [K, B, Lp, kw * C].

    ``padded`` is the float32 input with ``pad`` zero rows on both ends of
    the time axis. ``sign=+1`` gives the forward taps ``x[t + dc*p + dj]``
    with the forward masks, ``sign=-1`` the adjoint's ``x[t - dc*p - dj]``
    with the transposed masks.
    """

    K, B, _, C = padded.shape
    t = torch.arange(geom.Lp, device=padded.device)
    starts = pad + sign * dc * geom.periods.long()  # [K]
    taps = []
    for dj in range(-(kw // 2), kw // 2 + 1):
        idx = (starts[:, None] + sign * dj + t[None, :])[:, None, :, None]
        tap = torch.gather(padded, 2, idx.expand(K, B, geom.Lp, C))
        mask = _fwd_mask(geom, dc, dj) if sign > 0 else _bwd_mask(geom, dj)
        taps.append(tap * mask[:, None, :, None].to(tap.dtype))
    return torch.cat(taps, dim=-1)


def _pad_rows(x: torch.Tensor, geom: FoldGeometry, kh: int, kw: int):
    """float32 ``x`` with enough zero rows on both ends for every shift."""

    pad = (kh // 2) * (geom.Lp - geom.L) + kw // 2  # largest |dc * p + dj| for p <= Lp - L
    return torch.nn.functional.pad(x.float(), (0, 0, pad, pad)), pad


def _tap_matmul(x: torch.Tensor, geom: FoldGeometry, w_flat: torch.Tensor, kh: int, kw: int,
                sign: int) -> torch.Tensor:
    """sum over kernel rows of ``_row_taps(dc) @ w_flat[dc]``, in float32."""

    padded, pad = _pad_rows(x, geom, kh, kw)
    out = None
    for i, dc in enumerate(range(-(kh // 2), kh // 2 + 1)):
        term = _row_taps(padded, geom, pad, dc, kw, sign) @ w_flat[i]
        out = term if out is None else out + term
    return out


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

    w = kernel.to(h.dtype).float().reshape(kh, kw * h.shape[-1], -1)
    return _tap_matmul(h, geom, w, kh, kw, 1) + bias.float()


def tap_conv_dh(
    ct: torch.Tensor, geom: FoldGeometry, kernel: torch.Tensor, kh: int, kw: int
) -> torch.Tensor:
    """The adjoint of :func:`tap_conv` with respect to ``h``.

    ``dh[s] = sum_{dc,dj} mask'(s, dj) * ct[s - dc*p - dj] @ W[dc, dj]^T``,
    zero where ``s - dc*p - dj`` falls outside [0, Lp): the JAX package's
    ``_tap_matmul`` with ``sign=-1`` and W transposed to [kh, kw * Cout, Cin].
    ``ct`` [K, B, Lp, Cout] in the working type; W is rounded to it. Returns
    [K, B, Lp, Cin] float32 (rows at and beyond each fold extent are 0).
    """

    cout, cin = kernel.shape[3], kernel.shape[2]
    w_t = kernel.to(ct.dtype).float().permute(0, 1, 3, 2).reshape(kh, kw * cout, cin)
    return _tap_matmul(ct, geom, w_t, kh, kw, -1)


def tap_weight_grad(
    h: torch.Tensor, geom: FoldGeometry, ct: torch.Tensor, kh: int, kw: int
) -> torch.Tensor:
    """``dW[dc, dj] = sum_{k,b,t} forward_tap(h)[k,b,t] (x) ct[k,b,t]``, float32.

    The forward taps are rebuilt, not kept from the forward pass, as in the
    JAX package. Returns [kh, kw, Cin, Cout].
    """

    padded, pad = _pad_rows(h, geom, kh, kw)
    ct32 = ct.float()
    rows = [
        torch.einsum("kbtc,kbto->co", _row_taps(padded, geom, pad, dc, kw, 1), ct32)
        for dc in range(-(kh // 2), kh // 2 + 1)
    ]
    return torch.stack(rows).reshape(kh, kw, h.shape[-1], ct.shape[-1])


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
