"""Forecast-accuracy metrics (counterpart of
``flow_timesnet_tpu/utils/metrics.py``): the host metrics in numpy, and the
streaming sums on the device.

Each batch contributes ``(sum, count)`` tensors that stay on the device; the
caller adds them up over a pass and reads them once at its end.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def smape_mean(y_true: np.ndarray, y_pred: np.ndarray, eps: float = 1e-8) -> float:
    """Mean symmetric MAPE over points where ``|y_true| > eps``."""

    if y_true.shape != y_pred.shape:
        raise ValueError("y_true and y_pred must have the same shape")
    mask = np.abs(y_true) > eps
    if not np.any(mask):
        return 0.0
    denom = np.abs(y_true) + np.abs(y_pred)
    vals = 2.0 * np.abs(y_pred - y_true)[mask] / denom[mask]
    return float(np.mean(vals))


def _store_columns(ids: List[str]) -> Dict[str, List[int]]:
    """Column positions by store: the id's text before its first ``_``."""

    by_store: Dict[str, List[int]] = {}
    for j, sid in enumerate(ids):
        by_store.setdefault(sid.split("_", 1)[0], []).append(j)
    return by_store


def wsmape_grouped(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    ids: List[str],
    weights: Optional[Dict[str, float]] = None,
    eps: float = 1e-8,
) -> float:
    """Store-weighted sMAPE of [T, N] arrays; store key = ``id.split('_', 1)[0]``.

    Per item, only timepoints with a non-zero actual contribute; items with no
    valid points score 0. Store scores are the mean over their items; the
    final score is the (normalised) weighted sum over stores.
    """

    if y_true.shape != y_pred.shape or y_true.ndim != 2:
        raise ValueError("y_true and y_pred must be [T, N] arrays of the same shape")
    by_store = _store_columns(ids)
    if weights is None:
        weights = {store: 1.0 for store in by_store}
    total_w = sum(weights.values()) or 1.0

    def item_smape(a: np.ndarray, p: np.ndarray) -> float:
        keep = np.abs(a) > eps
        a, p = a[keep], p[keep]
        if a.size == 0:
            return 0.0
        denom = np.abs(a) + np.abs(p)
        keep2 = denom > eps
        if not np.any(keep2):
            return 0.0
        return float(np.mean(2.0 * np.abs(a[keep2] - p[keep2]) / denom[keep2]))

    score = 0.0
    for store, cols in by_store.items():
        item_scores = [item_smape(y_true[:, j], y_pred[:, j]) for j in cols]
        score += weights.get(store, 0.0) / total_w * float(np.mean(item_scores))
    return float(score)


def smape_batch_sums(
    y: torch.Tensor, pred: torch.Tensor, eps: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum, count)`` of symmetric MAPE terms over points with ``|y| > eps``.

    ``y``/``pred`` must already have masked-invalid entries zeroed, so that
    the ``|y| > eps`` gate excludes them.
    """

    y32, p32 = y.float(), pred.float()
    gate = torch.abs(y32) > eps
    denom = torch.abs(y32) + torch.abs(p32)
    one = torch.ones((), dtype=torch.float32, device=y32.device)
    term = torch.where(gate, 2.0 * torch.abs(p32 - y32) / torch.where(gate, denom, one),
                       torch.zeros_like(one))
    return term.sum(), gate.float().sum()


def wsmape_batch_sums(
    y: torch.Tensor, pred: torch.Tensor, series_idx: torch.Tensor, num_series: int,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-series ``(sums[N], counts[N])`` for grouped wSMAPE.

    ``y``/``pred`` are ``[B, H, N]`` with masked entries zeroed,
    ``series_idx`` is ``[B, N]`` integer ids into the global series list.
    """

    y32, p32 = y.float(), pred.float()
    gate = (torch.abs(y32) > eps) & ((torch.abs(y32) + torch.abs(p32)) > eps)
    one = torch.ones((), dtype=torch.float32, device=y32.device)
    denom = torch.where(gate, torch.abs(y32) + torch.abs(p32), one)
    term = torch.where(gate, 2.0 * torch.abs(y32 - p32) / denom, torch.zeros_like(one))
    flat_idx = series_idx.long()[:, None, :].expand(y32.shape).reshape(-1)
    sums = torch.zeros(num_series, dtype=torch.float32, device=y32.device)
    counts = torch.zeros(num_series, dtype=torch.float32, device=y32.device)
    sums.index_add_(0, flat_idx, term.reshape(-1))
    counts.index_add_(0, flat_idx, gate.float().reshape(-1))
    return sums, counts


def wsmape_from_series_sums(
    sums: np.ndarray,
    counts: np.ndarray,
    ids: List[str],
    weights: Optional[Dict[str, float]] = None,
) -> float:
    """Finalize grouped wSMAPE from per-series streaming accumulators: the
    weighted mean over stores (``id.split('_', 1)[0]``) of the mean per-item
    sMAPE of their items."""

    sums, counts = np.asarray(sums), np.asarray(counts)
    per_item = np.where(counts > 0, sums / np.maximum(counts, 1.0), 0.0)
    by_store = _store_columns(ids)
    if weights is None:
        weights = {store: 1.0 for store in by_store}
    total_w = sum(weights.values()) or 1.0
    score = 0.0
    for store, cols in by_store.items():
        score += (weights.get(store, 0.0) / total_w) * float(np.mean(per_item[cols]))
    return float(score)
