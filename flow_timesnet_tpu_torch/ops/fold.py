"""Period-fold 2D convolution as masked dilated taps: the plain PyTorch version.

Counterpart of ``flow_timesnet_tpu/ops/fold.py``: the masked tap conv, its
adjoint and its weight gradient, and the exact-extent geometry of the dense
frozen-period conv (:func:`make_dense_geometry`). For fold
position ``t = c * p + j`` the Conv2d neighbour ``(c + dc, j + dj)`` is time
index ``t + dc * p + dj``, so a 2D convolution over the ``[cycles, p]`` fold
is a sum over ``kh * kw`` taps of time-shifted copies of the sequence, where
a tap is valid iff

    0 <= (t mod p) + dj < p        (stays inside the period row)
    0 <= (t div p) + dc < cycles   (stays inside the cycle grid)

and invalid taps contribute zero (Conv2d's implicit zero padding). Shapes stay
``[K, B, Lp, C]`` whatever the periods, and the periods stay int32 tensors,
so the forward never synchronises with the host.

The same masked sum at ``K = 1`` over ``Lp = total`` rows of one static
period is the dense zero-padded Conv2d over the exact ``[cycles, p]`` grid
that the JAX package's frozen-period path runs, so the dense form needs no
kernel of its own: only a geometry whose period bound ``p_max`` is the
period itself, not ``Lp - L``. Its bf16 rounding, which differs from the
tap form's, is ``ops/cuda_fold.py::dense_fold_conv``'s.

The adjoint is the same masked-shift sum with negated shifts and the
transposed masks of :func:`_bwd_mask`; the weight gradient contracts the
forward taps with the cotangent. :func:`tap_conv`, :func:`tap_conv_dh` and
:func:`tap_weight_grad` are the reference arithmetic for the CUDA kernels in
``ops/cuda_fold.py``: the CPU path runs them, and the card checks against
them.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Dict, NamedTuple, Optional

import torch

from .. import tracing


class FoldGeometry(NamedTuple):
    """Per-candidate fold geometry over a static padded time axis."""

    periods: torch.Tensor  # [K] int32
    total: torch.Tensor  # [K] int32: L + pad (fold extent per candidate)
    cycles: torch.Tensor  # [K] int32
    col: torch.Tensor  # [K, Lp] int32: t mod p
    row: torch.Tensor  # [K, Lp] int32: t div p
    Lp: int  # static padded length (>= max total)
    L: int  # original sequence length
    p_max: int  # static bound on every period: the zero rows a shifted tap may need
    dense: bool = False  # one static period at its exact extent (make_dense_geometry)


def make_geometry(periods: torch.Tensor, L: int, p_cap: int) -> FoldGeometry:
    """Fold coordinates for each candidate period.

    Periods are clamped into ``[1, p_cap]``, so ``Lp = L + p_cap`` covers
    every padded extent and every valid tap reads inside ``[0, Lp)``;
    ``p_max`` is that cap.
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
        col=col.to(torch.int32), row=row.to(torch.int32), Lp=Lp, L=int(L), p_max=cap,
    )


@functools.cache  # the spec is static: a frozen layer asks for the same few
def make_dense_geometry(period: int, L: int, device="cpu") -> FoldGeometry:
    """The exact-extent geometry of one static period (the JAX package's
    ``make_dense_geometry``): ``K = 1``, ``total = L + (-L) % p``, ``cycles =
    total // p`` and ``Lp = total``, so the fold is the whole ``[cycles, p]``
    grid with no padded rows beyond it, and ``p_max = p``. Cached by
    ``(period, L, device)``: its tensors are built once per spec (outside
    inference mode, so that a served request and a training step share them)
    and kept for the life of the process, as a CUDA graph that reads them
    needs (at most one entry per period, L and device).
    """

    p = max(1, int(period))
    total = L + (-L) % p
    dev = torch.device(device)
    with torch.inference_mode(False):
        t = torch.arange(total, dtype=torch.int32, device=dev)[None, :]
        periods, total_t, cycles = (torch.tensor([v], dtype=torch.int32, device=dev)
                                    for v in (p, total, total // p))
        return FoldGeometry(
            periods=periods, total=total_t, cycles=cycles,
            col=torch.remainder(t, p), row=torch.div(t, p, rounding_mode="floor"),
            Lp=total, L=int(L), p_max=p, dense=True,
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
    """float32 ``x`` with enough zero rows on both ends for every shift: the
    largest ``|dc * p + dj|`` for a period up to ``geom.p_max`` (``Lp - L``
    bounds it only on :func:`make_geometry`'s padded axis; at the exact
    extent ``Lp = L + (-L) % p`` it can be 0)."""

    pad = (kh // 2) * geom.p_max + kw // 2
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


# Calls of :func:`pointwise_conv` by route and direction since
# :func:`clear_pointwise_runs`: "tensor_core" (bf16 operands on the tensor
# cores) and "float32" (the operands widened to float32). They count where
# a call is issued, as ``cuda_fold.launches`` does: eager calls and a
# graph's warm-up and capture. A replay runs no Python; it reruns the
# route its capture took (the ``pointwise.*`` regions count replays).
POINTWISE_ROUTES = ("tensor_core", "float32")
_pointwise_runs: Counter = Counter()  # (route, "fwd" | "bwd") -> calls


def pointwise_runs() -> Dict[str, Dict[str, int]]:
    """``{route: {"fwd": n, "bwd": m}}`` for each of ``POINTWISE_ROUTES``:
    the calls of :func:`pointwise_conv` and of its backward that took the
    route since :func:`clear_pointwise_runs`."""

    return {route: {d: _pointwise_runs[(route, d)] for d in ("fwd", "bwd")}
            for route in POINTWISE_ROUTES}


def clear_pointwise_runs() -> None:
    """Zero :func:`pointwise_runs`."""

    _pointwise_runs.clear()


def pointwise_conv(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """1x1 conv == per-position channel matmul; kernel [Cin, Cout].

    The JAX package multiplies in ``h.dtype`` with float32 accumulation and
    adds the float32 bias before any cast. The result is float32, or
    ``out_dtype`` where given: the caller's cast of that float32 value,
    folded in. The route follows ``h``:

    - bf16 on a card (:class:`_TensorCorePointwise`): cuBLAS multiplies the
      bf16 operands on the tensor cores with float32 accumulation and adds
      the bias to the float32 sums, forward and both gradients, and no
      operand is widened. Products of two bf16 values are exact in float32,
      so these are the float32 route's sums in another order.
    - otherwise (float32, or on the CPU) the bf16 values are upcast
      (exactly) and multiplied in float32: a bf16 ``torch.matmul`` would
      round its output before the bias. Where autograd records the call,
      :class:`_Float32Pointwise` runs what autograd runs for that
      expression.

    With tracing on (``tracing.py``) the call is the region
    ``pointwise.fwd`` and its backward the region ``pointwise.bwd``, with
    the same results bit for bit. :func:`pointwise_runs` counts the routes.
    """

    if h.is_cuda and h.dtype == torch.bfloat16:
        return _TensorCorePointwise.apply(h, kernel, bias, out_dtype or torch.float32)
    if torch.is_grad_enabled() and (h.requires_grad or kernel.requires_grad
                                    or bias.requires_grad):
        out = _Float32Pointwise.apply(h, kernel, bias)
    else:
        _pointwise_runs[("float32", "fwd")] += 1
        with tracing.region("pointwise.fwd", h.device):
            out = h.float() @ kernel.to(h.dtype).float() + bias.float()
    return out if out_dtype is None else out.to(out_dtype)


class _TensorCorePointwise(torch.autograd.Function):
    """The bf16 1x1 conv on the tensor cores: ``rows @ W`` over bf16 rows
    and the kernel rounded to bf16 (as ``kernel.to(h.dtype)``), summed in
    float32; then one pass adds the float32 bias and rounds once to
    ``out_dtype``. (``addmm``'s bias epilogue gives the same bits, but took
    longer on an H100 and keeps a cuBLASLt workspace for each stream.) The
    rows and the kernel are saved in bf16.

    Backward, with the bf16 cotangent that a bf16 ``out_dtype`` gets from
    autograd: ``dh = g @ W^T`` with float32 sums rounded once to bf16,
    ``dW = rows^T @ g`` summed in float32 and rounded as the kernel's cast
    rounds it, ``db`` summed in float32 as ``ones @ g`` (a GEMM reads ``g``
    faster than a column reduction). A float32 cotangent (a float32
    ``out_dtype``) is not rounded: its products run in float32. The whole
    of each direction lies in one tracing region."""

    @staticmethod
    def forward(ctx, h, kernel, bias, out_dtype):
        _pointwise_runs[("tensor_core", "fwd")] += 1
        with tracing.region("pointwise.fwd", h.device):
            rows = h.reshape(-1, h.shape[-1])
            w = kernel.to(h.dtype)
            acc = torch.mm(rows, w, out_dtype=torch.float32)
            out = torch.add(acc, bias.float(), out=acc.new_empty(acc.shape, dtype=out_dtype))
            out = out.view(*h.shape[:-1], w.shape[-1])
        ctx.save_for_backward(rows, w)
        ctx.shapes = (h.shape, bias.shape)
        ctx.dtypes = (kernel.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, w = ctx.saved_tensors
        h_shape, b_shape = ctx.shapes
        k_dt, b_dt = ctx.dtypes
        dh = dk = db = None
        cores = g.dtype == rows.dtype  # a bf16 cotangent: bf16 operands
        _pointwise_runs[("tensor_core" if cores else "float32", "bwd")] += 1
        with tracing.region("pointwise.bwd", g.device):
            g2 = g.reshape(-1, g.shape[-1])
            if ctx.needs_input_grad[2]:
                if cores:
                    ones = g2.new_ones(1, g2.shape[0])
                    db = torch.mm(ones, g2, out_dtype=torch.float32)
                else:
                    db = g2.sum(0)
                db = db.reshape(b_shape).to(b_dt)
            if ctx.needs_input_grad[0]:
                dh = g2.mm(w.t()) if cores else g2.mm(w.float().t())
                dh = dh.reshape(h_shape).to(rows.dtype)
            if ctx.needs_input_grad[1]:
                if cores:
                    dk = torch.mm(rows.t(), g2, out_dtype=torch.float32)
                else:
                    dk = rows.float().t().mm(g2)
                dk = dk.to(w.dtype).to(k_dt)
        return dh, dk, db, None


class _Float32Pointwise(torch.autograd.Function):
    """:func:`pointwise_conv`'s float32 route as one autograd node, so that
    its forward and its backward each lie in one tracing region: between
    two marks around the plain expression's nodes, autograd's ready queue
    could run a sibling branch's work. It runs the operations autograd runs
    for the plain expression, in its order: the matmul folded to one ``mm``
    over the rows (``torch.matmul`` folds when the kernel records
    gradients), the bias added in float32; backward, ``mm``'s two gradients
    as autograd forms them from the operands' strides, the bias's summed to
    its shape, and each cast's gradient cast back (the kernel's through
    ``h.dtype``)."""

    @staticmethod
    def forward(ctx, h, kernel, bias):
        _pointwise_runs[("float32", "fwd")] += 1
        with tracing.region("pointwise.fwd", h.device):
            hf = h.float()
            wk = kernel.to(h.dtype)
            wf = wk.float()
            rows = hf.reshape(-1, hf.shape[-1])
            out = rows.mm(wf).view(*hf.shape[:-1], wf.shape[-1]) + bias.float()
        ctx.save_for_backward(rows, wf)
        ctx.shapes = (hf.shape, bias.shape)
        ctx.dtypes = (h.dtype, kernel.dtype, wk.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, wf = ctx.saved_tensors
        h_shape, b_shape = ctx.shapes
        h_dt, k_dt, wk_dt, b_dt = ctx.dtypes
        dh = dk = db = None
        _pointwise_runs[("float32", "bwd")] += 1
        with tracing.region("pointwise.bwd", g.device):
            if ctx.needs_input_grad[2]:
                db = g.sum_to_size(b_shape).to(b_dt)
            g2 = g.reshape(-1, g.shape[-1])
            if ctx.needs_input_grad[0]:  # mm_mat1_backward
                if rows.stride(0) == 1 and rows.stride(1) == rows.shape[0]:
                    dh = wf.mm(g2.t()).t()
                else:
                    dh = g2.mm(wf.t())
                dh = dh.reshape(h_shape).to(h_dt)
            if ctx.needs_input_grad[1]:  # mm_mat2_backward
                if wf.stride(0) == 1 and wf.stride(1) == wf.shape[0]:
                    dk = g2.t().mm(rows).t()
                else:
                    dk = rows.t().mm(g2)
                dk = dk.to(wk_dt).to(k_dt)
        return dh, dk, db


def combine_residuals(deltas: torch.Tensor, weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x + sum_k w[b, k] * delta_k; deltas [K, B, L, C], weights [B, K]."""

    combined = torch.einsum("kblc,bk->blc", deltas.float(), weights.to(deltas.dtype).float())
    return x + combined.to(x.dtype)
