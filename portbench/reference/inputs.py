"""What the reference works out from raw data by itself: calendar features,
the z-score scaler and the windows of a flat sample index.

numpy only, from ``datetime64`` stamps. Calendar features are
``(sin, cos)`` of ``2 pi (value mod period) / period`` for each named field,
in the order given: day of week (Monday 0, period 7), day of month (0-based,
31), month (0-based, 12), day of year (0-based, 366), hour (24).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

_FIELDS = {
    "day_of_week": (lambda d, t: (d.astype(np.int64) + 3) % 7, 7),  # 1970-01-01: Thursday
    "day_of_month": (lambda d, t: (d - d.astype("datetime64[M]")).astype(np.int64), 31),
    "month": (lambda d, t: d.astype("datetime64[M]").astype(np.int64) % 12, 12),
    "day_of_year": (lambda d, t: (d - d.astype("datetime64[Y]")).astype(np.int64), 366),
    "hour": (lambda d, t: (t - d).astype("timedelta64[h]").astype(np.int64), 24),
}


def calendar(stamps: np.ndarray, features: Sequence[str]) -> np.ndarray:
    """[T, 2 * len(features)] float32 cyclical calendar features."""

    t = np.asarray(stamps).astype("datetime64[m]")
    d = t.astype("datetime64[D]")
    cols = []
    for name in features:
        field, period = _FIELDS[name]
        angle = 2.0 * np.pi * (np.mod(field(d, t), period).astype(np.float32) / float(period))
        cols += [np.sin(angle), np.cos(angle)]
    return np.stack(cols, axis=1).astype(np.float32)


def zscore(values: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return ((values.astype(np.float32) - mean[None, :]) / std[None, :]).astype(np.float32)


def unscale(values: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (values.astype(np.float32) * std[None, :] + mean[None, :]).astype(np.float32)


def windows(flat: np.ndarray, X: np.ndarray, M: np.ndarray, marks: np.ndarray, L: int,
            H: int) -> Dict[str, np.ndarray]:
    """The windows of flat sample indices over one [T, N] fold: sample
    ``i`` is series ``i % N`` starting at step ``i // N`` (stride 1):
    ``x`` [B, L, 1], ``y`` and ``mask`` [B, H, 1], ``x_mark`` [B, L, F] and
    the series ``[B]``."""

    N = X.shape[1]
    flat = np.asarray(flat, np.int64)
    start, series = flat // N, flat % N
    t_in = start[:, None] + np.arange(L)[None, :]
    t_out = start[:, None] + L + np.arange(H)[None, :]
    return {"x": X[t_in, series[:, None]][..., None], "y": X[t_out, series[:, None]][..., None],
            "mask": M[t_out, series[:, None]][..., None], "x_mark": marks[t_in],
            "series": series}
