"""Streaming forecast-accuracy sums on the device (counterpart of the
accumulators of ``flow_timesnet_tpu/utils/metrics.py``).

Each batch contributes ``(sum, count)`` tensors that stay on the device; the
caller adds them up over a pass and reads them once at its end.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


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
    by_store: Dict[str, List[int]] = {}
    for j, sid in enumerate(ids):
        by_store.setdefault(sid.split("_", 1)[0], []).append(j)
    if weights is None:
        weights = {store: 1.0 for store in by_store}
    total_w = sum(weights.values()) or 1.0
    score = 0.0
    for store, cols in by_store.items():
        score += (weights.get(store, 0.0) / total_w) * float(np.mean(per_item[cols]))
    return float(score)
