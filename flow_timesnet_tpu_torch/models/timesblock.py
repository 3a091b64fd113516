"""TimesBlock: weighted period-fold inception residuals.

Counterpart of ``flow_timesnet_tpu/models/timesblock.py`` (the dynamic path).
All selected periods run in one candidate-batched ``[K, B, Lp, C]`` program
over the masked dilated-tap fold conv of ``ops/cuda_fold.py``, which runs the
CUDA kernel on the card. With ``compute_dtype="bfloat16"`` the casts follow
the JAX package point by point: matmul inputs are bf16, products are summed
in float32, the float32 bias is added, and only then is the result cast.
Dropout runs when the caller passes the step's ``torch.Generator``; with
None the block is deterministic.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda_fold import tap_conv
from ..ops.fold import FoldGeometry, combine_residuals, make_geometry, pad_time, pointwise_conv
from .embedding import dropout
from .period import PeriodSelection, group_periods


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _activation(name: str):
    if name.lower() == "relu":
        return F.relu
    return F.gelu  # exact (erf) GELU, as the JAX package asks for


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
        if not self.bottleneck:
            return tap_conv(h.to(dt), geom, self.conv_kernel, self.conv_bias, kh, kw)
        h = pointwise_conv(h.to(dt), self.reduce_kernel, self.reduce_bias).to(dt)
        h = tap_conv(h, geom, self.conv_kernel, self.conv_bias, kh, kw).to(dt)
        return pointwise_conv(h, self.expand_kernel, self.expand_bias)


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
        res = pointwise_conv(h.to(dt), self.res_kernel, self.res_bias) if self.has_res else h
        feats = [
            getattr(self, f"branch_{i}")(h, geom).to(dt) for i in range(self.n_branches)
        ]
        z = pointwise_conv(torch.cat(feats, dim=-1), self.proj_kernel, self.proj_bias).to(dt)
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
    ) -> None:
        super().__init__()
        self.d_model = d_model
        self.min_period = min_period
        self.max_period = max_period
        self.p_cap = p_cap
        self.log_base = log_base
        self.max_unique = max_unique
        self.conv_dt = _dtype(conv_dtype)
        self.act = _activation(activation)
        self.inception_in = InceptionBlock(
            d_model, d_ff, kernel_set, activation, bottleneck_ratio, conv_dtype, dropout
        )
        self.inception_out = InceptionBlock(
            d_ff, d_model, kernel_set, activation, bottleneck_ratio, conv_dtype, dropout
        )

    def _conv_deltas(
        self, x: torch.Tensor, periods: torch.Tensor, p_cap: int,
        generator: Optional[torch.Generator],
    ) -> torch.Tensor:
        """Per-candidate inception residual deltas [K, B, L, C]."""

        B, L, C = x.shape
        K = int(periods.shape[0])
        geom = make_geometry(periods, L, p_cap)
        xg = pad_time(x.float(), L, geom.Lp)
        h = xg[None].expand(K, B, geom.Lp, C).to(self.conv_dt)
        h = self.inception_in(h, geom, generator).to(self.conv_dt)
        h = self.act(h)
        h = self.inception_out(h, geom, generator)
        # residual delta against the folded input, cropped to the input length
        delta = h.float()[:, :, :L, :] - xg[None, :, :L, :]
        return delta.to(x.dtype)

    def forward(
        self,
        x: torch.Tensor,
        selection: PeriodSelection,
        row_weight: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``row_weight`` [B] (0 for padded rows) keeps padded rows out of the
        grouper's batch statistics; ``generator`` drives dropout (None:
        deterministic)."""

        if x.dim() != 3:
            raise ValueError("TimesBlock expects input shaped [B, L, d_model]")
        B, L, C = x.shape
        if C != self.d_model:
            raise ValueError("Input channel dimension does not match configured d_model")
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
        p_cap = min(int(self.p_cap), max(1, L - 1))
        delta = self._conv_deltas(x, grouped.periods, p_cap, generator)
        out = combine_residuals(delta, grouped.weights, x)
        # no valid period -> identity, decided on the device
        return torch.where(grouped.any_valid, out, x)
