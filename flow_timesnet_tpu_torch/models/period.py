"""FFT dominant-period selection and static-shape period grouping.

Counterpart of ``flow_timesnet_tpu/models/period.py``. The
selector returns a fixed-K candidate set plus a validity mask, and the
grouper is O(K^2) masked tensor math over that K-vector, so the forward has
no data-dependent control flow and never reads a value back to the host.

Ties break toward the lower index, as ``lax.top_k`` and ``jnp.argmax`` do:
the top-k is a stable descending sort, and ``torch.argmax``/``argmin``
return the first extremum.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_NEG_INF = float("-inf")


class PeriodSelection(NamedTuple):
    periods: torch.Tensor  # [K] int32: clamped candidate period lengths
    amplitudes: torch.Tensor  # [B, K] float32: per-sample channel-median amplitudes
    valid: torch.Tensor  # [K] bool
    freq_indices: torch.Tensor  # [K] int32: selected rFFT bins (>= 1)


class _LowerMedianLast(torch.autograd.Function):
    """Lower median over the last axis with the JAX package's custom VJP:
    the cotangent goes to the first element equal to the median.
    ``torch.median``'s own backward sends it to the index ``torch.median``
    returns, which on ties is not specified."""

    @staticmethod
    def forward(ctx, x):
        med = torch.median(x, dim=-1).values
        ctx.save_for_backward(x, med)
        return med

    @staticmethod
    def backward(ctx, ct):
        x, med = ctx.saved_tensors
        eq = x == med[..., None]
        first = eq & (torch.cumsum(eq.to(torch.int32), dim=-1) == 1)
        return ct[..., None] * first.to(ct.dtype)


def _lower_median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median taking the lower of the two middle order statistics.

    ``torch.median`` already returns order statistic ``(n - 1) // 2``, the
    semantics the JAX package reproduces with a sort.
    """

    return _LowerMedianLast.apply(torch.movedim(x, dim, -1))


def _batch_mean(values: torch.Tensor, row_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the batch axis, optionally over the rows with weight > 0 only."""

    if row_weight is None:
        return values.mean(dim=0)
    w = row_weight.float().reshape((-1,) + (1,) * (values.dim() - 1))
    # zero dropped rows before multiplying: values may hold -inf
    masked = torch.where(w > 0.0, values, torch.zeros((), dtype=values.dtype, device=values.device))
    return (masked * w).sum(dim=0) / torch.clamp(w.sum(), min=1.0)


def select_periods(
    x: torch.Tensor,
    k_periods: int,
    pmax: int,
    min_period_threshold: int = 1,
    row_weight: Optional[torch.Tensor] = None,
) -> PeriodSelection:
    """Shared dominant-period search over ``x`` shaped [B, L, C].

    rFFT over time -> amplitude -> channel lower-median -> batch mean -> DC
    bin to -inf -> long-period log penalty -> top-k -> ``period =
    ceil(L / bin)`` clamped to ``[min_period_threshold, min(pmax, L - 1)]``;
    candidates with fewer than two cycles are masked.
    """

    if x.dim() != 3:
        raise ValueError("select_periods expects input shaped [B, L, C]")
    B, L, C = x.shape
    dev = x.device
    pmax = max(1, int(pmax))
    min_thresh = min(pmax, max(1, int(min_period_threshold)))
    n_freq = L // 2 + 1
    k = max(0, min(int(k_periods), max(0, n_freq - 1)))
    if k == 0 or L <= 1 or C <= 0 or B <= 0:
        return PeriodSelection(
            periods=torch.zeros(0, dtype=torch.int32, device=dev),
            amplitudes=torch.zeros((B, 0), dtype=torch.float32, device=dev),
            valid=torch.zeros(0, dtype=torch.bool, device=dev),
            freq_indices=torch.zeros(0, dtype=torch.int32, device=dev),
        )

    amp = torch.fft.rfft(x.float(), dim=1).abs()  # [B, F, C]
    amp_med = _lower_median(amp, dim=2)  # [B, F]
    amp_mean = _batch_mean(amp_med, row_weight).clone()  # [F]
    amp_mean[0] = _NEG_INF

    bins = torch.arange(n_freq, dtype=torch.float32, device=dev)
    scores = amp_mean - 1e-8 * torch.log1p(bins)
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    idx = idx.clamp(min=1)  # [K] int64
    sample_amps = amp_med[:, idx]  # [B, K]

    upper = min(pmax, max(1, L - 1))
    periods = torch.div(L + idx - 1, idx, rounding_mode="floor")
    periods = torch.clamp(periods, min_thresh, upper)
    cycles = torch.div(L + periods - 1, periods, rounding_mode="floor")
    valid = cycles >= 2
    if upper < min_thresh:
        valid = torch.zeros_like(valid)
    return PeriodSelection(
        periods=periods.to(torch.int32),
        amplitudes=sample_amps.float(),
        valid=valid,
        freq_indices=idx.to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Depth-scheduled knob parsing (framework-free; copied from the JAX package)
# ---------------------------------------------------------------------------


def resolve_scheduled(raw, depth: Optional[int]):
    """Resolve a per-depth scheduled value like ``"0:4,2:8,default:2"``.

    Plain ints/floats apply to every depth. String schedules accept
    ``depth:value`` / ``depth=value`` tokens plus ``default``/``*`` entries;
    the highest explicit key <= depth wins, then defaults, then bare tokens.
    """

    if raw is None:
        return None
    if isinstance(raw, (int, float)):
        return raw
    text = str(raw).strip()
    if not text:
        return None
    tokens = [t.strip() for t in text.split(",") if t.strip()]
    if not tokens:
        return None
    explicit = {}
    defaults = []
    bare = []
    for token in tokens:
        if ":" in token or "=" in token:
            sep = ":" if ":" in token else "="
            key, val = token.split(sep, 1)
            key, val = key.strip().lower(), val.strip()
            if not val:
                continue
            if key in {"default", "*"}:
                defaults.append(val)
            else:
                try:
                    explicit[int(key)] = val
                except ValueError:
                    continue
        else:
            bare.append(token)
    chosen = None
    if depth is not None and explicit:
        if depth in explicit:
            chosen = explicit[depth]
        else:
            lower_keys = [d for d in explicit if d <= depth]
            if lower_keys:
                chosen = explicit[max(lower_keys)]
    if chosen is None and defaults:
        chosen = defaults[-1]
    if chosen is None and bare:
        chosen = bare[-1]
    if chosen is None and explicit:
        chosen = explicit[min(explicit)]
    if chosen is None:
        chosen = tokens[-1]
    return chosen


def resolve_max_unique(raw, depth: Optional[int]) -> Optional[int]:
    value = resolve_scheduled(raw, depth)
    if value is None:
        return None
    try:
        parsed = int(float(value))
    except (TypeError, ValueError):
        return None
    return parsed if parsed > 0 else None


def resolve_log_base(raw, depth: Optional[int]) -> Optional[float]:
    value = resolve_scheduled(raw, depth)
    if value is None:
        return None
    if isinstance(value, (int, float)):
        base = float(value)
        return base if base > 1.0 else None
    text = str(value).strip().lower()
    if not text or text in {"off", "false", "0", "none"}:
        return None
    base: Optional[float] = None
    if ":" in text:
        prefix, suffix = (p.strip() for p in text.split(":", 1))
        if prefix in {"log", "logscale", "logarithmic"}:
            try:
                base = float(suffix)
            except ValueError:
                base = None
        else:
            try:
                base = float(prefix)
            except ValueError:
                base = None
    elif text in {"log", "logscale", "logarithmic"}:
        base = 2.0
    else:
        try:
            base = float(text)
        except ValueError:
            base = None
    if base is None:
        base = 2.0
    return base if base > 1.0 else None


# ---------------------------------------------------------------------------
# Static-shape grouping
# ---------------------------------------------------------------------------


class GroupedPeriods(NamedTuple):
    periods: torch.Tensor  # [K] int32: canonical (possibly remapped) period per candidate
    valid: torch.Tensor  # [K] bool: candidates contributing to the residual mix
    weights: torch.Tensor  # [B, K] float32: per-candidate softmax weights (0 where invalid)
    any_valid: torch.Tensor  # [] bool
    canonical: torch.Tensor  # [K] int32: representative candidate index per slot
    group_count: torch.Tensor  # [] int32: number of distinct groups


def group_periods(
    periods: torch.Tensor,
    amplitudes: torch.Tensor,
    valid: torch.Tensor,
    seq_len: int,
    min_period: Optional[int] = None,
    max_period: Optional[int] = None,
    log_base: Optional[float] = None,
    max_unique: Optional[int] = None,
    row_weight: Optional[torch.Tensor] = None,
) -> GroupedPeriods:
    """Static-K masked period grouping (duplicate / log-bucket merge,
    max-unique caps with nearest-period reassignment) and per-candidate
    softmax weights; see the JAX package's ``group_periods``."""

    K = int(periods.shape[0])
    B = int(amplitudes.shape[0])
    dev = periods.device
    if K == 0:
        return GroupedPeriods(
            periods=periods,
            valid=valid,
            weights=torch.zeros((B, 0), dtype=torch.float32, device=dev),
            any_valid=torch.zeros((), dtype=torch.bool, device=dev),
            canonical=torch.zeros(0, dtype=torch.int32, device=dev),
            group_count=torch.zeros((), dtype=torch.int32, device=dev),
        )

    arange = torch.arange(K, device=dev)
    p = periods.to(torch.int32)
    ok = valid & (p > 0)
    if min_period is not None:
        ok = ok & (p >= int(min_period))
    if max_period is not None:
        ok = ok & (p <= int(max_period))
    safe_p = torch.clamp(p, min=1)
    pad = torch.remainder(-seq_len, safe_p)
    cycles = torch.div(seq_len + pad, safe_p, rounding_mode="floor")
    ok = ok & (cycles >= 2)

    if log_base is None:
        keys = safe_p
    else:
        keys = torch.floor(
            torch.log(safe_p.float()) / math.log(float(log_base)) + 1e-6
        ).to(torch.int32)

    amps32 = amplitudes.float()
    mean_amp = _batch_mean(amps32, row_weight)  # [K]
    neg_inf = torch.full((), _NEG_INF, device=dev)

    same = (keys[:, None] == keys[None, :]) & ok[:, None] & ok[None, :]
    # canonical member per group: first argmax of batch-mean amplitude
    member_scores = torch.where(same, mean_amp[None, :], neg_inf)
    canonical = torch.argmax(member_scores, dim=1)
    canonical = torch.where(ok, canonical, arange)
    is_rep = ok & (canonical == arange)

    # group score: batch mean of the logsumexp over member amplitudes
    member_mask = (canonical[None, :] == arange[:, None]) & ok[None, :]
    masked_amps = torch.where(member_mask[None, :, :], amps32[:, None, :], neg_inf)
    group_logits = logsumexp(masked_amps, dim=2)  # [B, K]
    group_score = torch.where(is_rep, _batch_mean(group_logits, row_weight), neg_inf)

    if max_unique is not None and max_unique < K:
        # rank representatives by (score desc, key asc)
        better = (group_score[None, :] > group_score[:, None]) | (
            (group_score[None, :] == group_score[:, None]) & (keys[None, :] < keys[:, None])
        )
        better = better & is_rep[None, :] & is_rep[:, None]
        rank = better.sum(dim=1)
        kept = is_rep & (rank < int(max_unique))
        # dropped groups merge into the kept group with the nearest period;
        # distance ties go to the higher-scored kept group
        pf = safe_p.float()
        dist = torch.abs(pf[:, None] - pf[None, :])
        tie = rank.float() / (2.0 * K)
        dist_keyed = torch.where(
            kept[None, :], dist + tie[None, :], torch.full((), float("inf"), device=dev)
        )
        nearest_kept = torch.argmin(dist_keyed, dim=1)
        new_rep = torch.where(kept[canonical], canonical, nearest_kept[canonical])
        canonical = torch.where(ok, new_rep, canonical)
        is_rep = ok & (canonical == arange)

    final_periods = torch.where(ok, safe_p[canonical], safe_p)

    masked = torch.where(ok[None, :], amps32, neg_inf)
    any_valid = ok.any()
    weights = torch.where(any_valid, softmax_safe(masked, dim=1), torch.zeros_like(amps32))
    weights = torch.where(ok[None, :], weights, torch.zeros_like(weights))

    return GroupedPeriods(
        periods=final_periods.to(torch.int32),
        valid=ok,
        weights=weights,
        any_valid=any_valid,
        canonical=canonical.to(torch.int32),
        group_count=is_rep.sum().to(torch.int32),
    )


def logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """logsumexp that returns the row maximum (-inf) on all--inf rows
    (counterpart of the JAX package's ``jax_logsumexp``)."""

    m = torch.amax(x, dim=dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    out = torch.log(torch.sum(torch.exp(x - m_safe), dim=dim)) + m_safe.squeeze(dim)
    m = m.squeeze(dim)
    return torch.where(torch.isfinite(m), out, m)


def softmax_safe(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax tolerant of all--inf rows, which come out as zeros
    (counterpart of the JAX package's ``jax_softmax_safe``)."""

    m = torch.amax(x, dim=dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(x - m_safe)
    e = torch.where(torch.isfinite(x), e, torch.zeros_like(e))
    denom = e.sum(dim=dim, keepdim=True)
    return torch.where(denom > 0, e / torch.clamp(denom, min=1e-38), torch.zeros_like(e))
