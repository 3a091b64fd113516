"""TimesBlock: weighted period-fold inception residuals.

Counterpart of ``flow_timesnet_tpu/models/timesblock.py``. On the dynamic
path all selected periods run in one candidate-batched ``[K, B, Lp, C]``
program over the masked dilated-tap fold conv of ``ops/cuda_fold.py``, which
runs the CUDA kernels on the card. A block given a frozen spec (static
``(period, freq_bin, valid)`` slots) skips the selector and the grouper and
runs each unique period at its exact extent through ``dense_fold_conv``, on
the same kernels; only the slots' softmax weights stay live. A period
bucket ladder (``period_buckets``, :func:`resolve_period_buckets`) is
accepted and runs the full-cap fold, whose result is the bucketed one (see
:class:`TimesBlock`). With
``compute_dtype="bfloat16"`` the casts follow the JAX package point by
point: matmul inputs are bf16, products are summed in float32, the float32
bias is added, and only then is the result cast.
Dropout runs when the caller passes the step's ``torch.Generator``; with
None the block is deterministic.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda_fold import dense_fold_conv, tap_conv
from ..ops.fold import (
    FoldGeometry,
    combine_residuals,
    make_dense_geometry,
    make_geometry,
    pad_time,
    pointwise_conv,
)
from .embedding import dropout
from .period import PeriodSelection, amplitudes_at_bins, group_periods, softmax_safe


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _activation(name: str):
    if name.lower() == "relu":
        return F.relu
    return F.gelu  # exact (erf) GELU, as the JAX package asks for


def resolve_period_buckets(raw, seq_len: int, p_cap: int) -> Tuple[int, ...]:
    """The static period-cap ladder of ``model.period_buckets`` (the JAX
    package's ``resolve_period_buckets``).

    ``None`` or a falsy value -> one full-cap fold (``(p_cap,)``); ``"auto"``
    -> caps at ``ceil(L/4)`` and ``ceil(L/2)``; a string of integers (commas
    or spaces) or an iterable of ints -> those caps; ``"off"``, ``"none"``,
    ``"false"``, ``"0"`` or a string that does not parse -> ``(p_cap,)``.
    The ladder is deduplicated, keeps the caps in ``(0, p_cap)`` and always
    ends in ``p_cap``.
    """

    if not raw:
        return (p_cap,)
    if isinstance(raw, str):
        text = raw.strip().lower()
        if text in ("", "off", "none", "false", "0"):
            return (p_cap,)
        if text == "auto":
            caps = [-(-seq_len // 4), -(-seq_len // 2)]
        else:
            try:
                caps = [int(tok) for tok in text.replace(",", " ").split()]
            except ValueError:
                return (p_cap,)
    else:
        try:
            caps = [int(c) for c in raw]
        except TypeError:
            caps = [int(raw)]
    ladder = sorted({c for c in caps if 0 < c < p_cap})
    return tuple(ladder) + (p_cap,)


class InceptionBranch(nn.Module):
    """One conv path: plain (kh, kw) conv, or 1x1 -> (kh, kw) -> 1x1 bottleneck."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: Tuple[int, int],
        bottleneck_ratio: float = 1.0, compute_dtype: str = "float32",
    ) -> None:
        super().__init__()
        if bottleneck_ratio <= 0:
            raise ValueError("bottleneck_ratio must be a positive value")
        self.kh, self.kw = (int(k) for k in kernel_size)
        self.dt = _dtype(compute_dtype)
        self.bottleneck = not math.isclose(bottleneck_ratio, 1.0, rel_tol=1e-9, abs_tol=1e-9)
        kh, kw = self.kh, self.kw
        if not self.bottleneck:
            self.conv_kernel = nn.Parameter(torch.zeros(kh, kw, in_ch, out_ch))
            self.conv_bias = nn.Parameter(torch.zeros(out_ch))
            return
        mid = max(1, int(math.ceil(min(in_ch, out_ch) / float(bottleneck_ratio))))
        self.reduce_kernel = nn.Parameter(torch.zeros(in_ch, mid))
        self.reduce_bias = nn.Parameter(torch.zeros(mid))
        self.conv_kernel = nn.Parameter(torch.zeros(kh, kw, mid, mid))
        self.conv_bias = nn.Parameter(torch.zeros(mid))
        self.expand_kernel = nn.Parameter(torch.zeros(mid, out_ch))
        self.expand_bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, h: torch.Tensor, geom: FoldGeometry) -> torch.Tensor:
        dt, kh, kw = self.dt, self.kh, self.kw
        # the frozen-period path's exact-extent geometry takes the dense form
        conv = dense_fold_conv if geom.dense else tap_conv
        if not self.bottleneck:
            return conv(h.to(dt), geom, self.conv_kernel, self.conv_bias, kh, kw)
        h = pointwise_conv(h.to(dt), self.reduce_kernel, self.reduce_bias, dt)
        h = conv(h, geom, self.conv_kernel, self.conv_bias, kh, kw).to(dt)
        return pointwise_conv(h, self.expand_kernel, self.expand_bias, dt)


class InceptionBlock(nn.Module):
    """Multi-kernel branches -> concat -> 1x1 proj -> act -> dropout -> +res."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_set: Tuple[Tuple[int, int], ...],
        activation: str = "gelu", bottleneck_ratio: float = 1.0,
        compute_dtype: str = "float32", dropout: float = 0.0,
    ) -> None:
        super().__init__()
        if not kernel_set:
            raise ValueError("kernel_set must contain at least one kernel size")
        self.dt = _dtype(compute_dtype)
        self.dropout = float(dropout)
        self.act = _activation(activation)
        self.n_branches = len(kernel_set)
        for i, ks in enumerate(kernel_set):
            self.add_module(
                f"branch_{i}",
                InceptionBranch(in_ch, out_ch, ks, bottleneck_ratio, compute_dtype),
            )
        cat_ch = out_ch * len(kernel_set)
        self.proj_kernel = nn.Parameter(torch.zeros(cat_ch, out_ch))
        self.proj_bias = nn.Parameter(torch.zeros(out_ch))
        self.has_res = in_ch != out_ch
        if self.has_res:
            self.res_kernel = nn.Parameter(torch.zeros(in_ch, out_ch))
            self.res_bias = nn.Parameter(torch.zeros(out_ch))

    def forward(
        self, h: torch.Tensor, geom: FoldGeometry, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        dt = self.dt
        res = pointwise_conv(h.to(dt), self.res_kernel, self.res_bias, dt) if self.has_res else h
        feats = [
            getattr(self, f"branch_{i}")(h, geom).to(dt) for i in range(self.n_branches)
        ]
        z = pointwise_conv(torch.cat(feats, dim=-1), self.proj_kernel, self.proj_bias, dt)
        z = self.act(z)
        # after the cast: the dropout product stays in the compute type
        z = dropout(z, self.dropout, generator)
        return z + res.to(z.dtype)


class TimesBlock(nn.Module):
    """Period-fold residual block on [B, L, d_model] features.

    For each grouped period candidate: fold, run the two-stage inception
    stack (d_model -> d_ff -> d_model with a mid activation), take the
    residual delta against the folded input, and softmax-weight the
    candidates by their FFT amplitudes.

    ``frozen`` (a tuple of ``(period, freq_bin, valid)`` slots, or None)
    takes the frozen-period path (:meth:`_frozen_forward`). Its parameters
    are the dynamic block's, so a frozen model loads the same state dict.
    Where ``telemetry`` is a dict, a forward records in it what the JAX
    package sows (``selected_periods``, ``period_valid``, ``group_count``,
    ``freq_indices``) as tensors, with no read to the host; it is None, and
    nothing is recorded, unless the caller asks
    (``Engine.collect_period_telemetry``).

    ``period_buckets`` (``model.period_buckets``) is kept and the dynamic
    path runs the full-cap fold whatever the ladder. The JAX package runs
    the smallest cap that holds the largest valid period, and its result is
    the full-cap one: a valid candidate (p <= cap) reads only rows below
    ``cycles * p <= L + p - 1 < L + cap``, and a candidate past the cap is
    invalid (weight 0). Choosing a cap would branch on a device value,
    which a CUDA graph cannot hold, and the fold conv's kernels already skip
    each candidate's rows past its own fold.
    """

    def __init__(
        self,
        d_model: int,
        d_ff: int,
        kernel_set: Tuple[Tuple[int, int], ...],
        activation: str = "gelu",
        bottleneck_ratio: float = 1.0,
        min_period: int = 1,
        max_period: int = 10_000,
        p_cap: int = 10_000,
        log_base: Optional[float] = None,
        max_unique: Optional[int] = None,
        conv_dtype: str = "float32",
        dropout: float = 0.0,
        frozen: Optional[Tuple[Tuple[int, int, bool], ...]] = None,
        period_buckets: object = None,
    ) -> None:
        super().__init__()
        self.d_model = d_model
        self.period_buckets = period_buckets
        self.min_period = min_period
        self.max_period = max_period
        self.p_cap = p_cap
        self.log_base = log_base
        self.max_unique = max_unique
        self.frozen = (None if frozen is None
                       else tuple((int(p), int(f), bool(v)) for p, f, v in frozen))
        self.telemetry: Optional[dict] = None
        self.conv_dt = _dtype(conv_dtype)
        self.act = _activation(activation)
        self.inception_in = InceptionBlock(
            d_model, d_ff, kernel_set, activation, bottleneck_ratio, conv_dtype, dropout
        )
        self.inception_out = InceptionBlock(
            d_ff, d_model, kernel_set, activation, bottleneck_ratio, conv_dtype, dropout
        )

    def _inception(self, h: torch.Tensor, geom: FoldGeometry,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """The two inception stacks over ``geom``, on [K, B, Lp, C] in the conv type."""

        h = self.inception_in(h, geom, generator).to(self.conv_dt)
        h = self.act(h)
        return self.inception_out(h, geom, generator)

    def _conv_deltas(
        self, x: torch.Tensor, periods: torch.Tensor, p_cap: int,
        generator: Optional[torch.Generator],
    ) -> torch.Tensor:
        """Per-candidate inception residual deltas [K, B, L, C]."""

        B, L, C = x.shape
        K = int(periods.shape[0])
        geom = make_geometry(periods, L, p_cap)
        xg = pad_time(x.float(), L, geom.Lp)
        h = self._inception(xg[None].expand(K, B, geom.Lp, C).to(self.conv_dt), geom, generator)
        # residual delta against the folded input, cropped to the input length
        delta = h.float()[:, :, :L, :] - xg[None, :, :L, :]
        return delta.to(x.dtype)

    def _frozen_forward(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        """The frozen-period path (the JAX package's ``_frozen_forward``).

        The valid slots' softmax weights come from the input's amplitudes at
        the frozen bins; each unique period, in sorted order, runs the
        inception stacks over its exact ``[cycles, p]`` grid
        (:func:`make_dense_geometry`), and its weight is the sum of its
        slots'. With no valid slot the block is the identity.
        """

        B, L, C = x.shape
        slots = self.frozen
        valid = [(p, f) for p, f, v in slots if v]
        uperiods = sorted({p for p, _ in valid})
        if self.telemetry is not None:  # constants, as the JAX package sows them
            self.telemetry.update(
                selected_periods=torch.tensor([p for p, _, _ in slots], dtype=torch.int32),
                period_valid=torch.tensor([v for _, _, v in slots], dtype=torch.bool),
                group_count=torch.tensor(len(uperiods), dtype=torch.int32),
                freq_indices=torch.tensor([f for _, f, _ in slots], dtype=torch.int32),
            )
        if not valid:
            return x
        w = softmax_safe(amplitudes_at_bins(x, tuple(f for _, f in valid)), dim=1)  # [B, V]
        # the slots' weights summed onto their (unique) periods
        wu = torch.stack([sum(w[:, i] for i, (p, _) in enumerate(valid) if p == u)
                          for u in uperiods], dim=1)  # [B, U]
        x32 = x.float()
        deltas = []
        for u in uperiods:
            geom = make_dense_geometry(u, L, x.device)
            xg = pad_time(x32, L, geom.Lp)  # [B, total, C]
            h = self._inception(xg[None].to(self.conv_dt), geom, generator)
            deltas.append((h.float()[0, :, :L, :] - x32[:, :L, :]).to(x.dtype))
        return combine_residuals(torch.stack(deltas), wu, x)

    def forward(
        self,
        x: torch.Tensor,
        selection: Optional[PeriodSelection],
        row_weight: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``selection`` is the shared selector's (None for a frozen block);
        ``row_weight`` [B] (0 for padded rows) keeps padded rows out of the
        grouper's batch statistics; ``generator`` drives dropout (None:
        deterministic)."""

        if x.dim() != 3:
            raise ValueError("TimesBlock expects input shaped [B, L, d_model]")
        B, L, C = x.shape
        if C != self.d_model:
            raise ValueError("Input channel dimension does not match configured d_model")
        if self.frozen is not None:
            return self._frozen_forward(x, generator)
        if int(selection.periods.shape[0]) == 0:
            return x
        grouped = group_periods(
            selection.periods,
            selection.amplitudes,
            selection.valid,
            seq_len=L,
            min_period=self.min_period,
            max_period=self.max_period,
            log_base=self.log_base,
            max_unique=self.max_unique,
            row_weight=row_weight,
        )
        if self.telemetry is not None:
            self.telemetry.update(
                selected_periods=grouped.periods, period_valid=grouped.valid,
                group_count=grouped.group_count, freq_indices=selection.freq_indices,
            )
        p_cap = min(int(self.p_cap), max(1, L - 1))
        delta = self._conv_deltas(x, grouped.periods, p_cap, generator)
        out = combine_residuals(delta, grouped.weights, x)
        # no valid period -> identity, decided on the device
        return torch.where(grouped.any_valid, out, x)
