"""Per-series scaling of wide arrays (numpy only).

A copy of ``scaler_arrays``, ``transform_array`` and ``inverse_transform``
from ``flow_timesnet_tpu/data/pivot.py``. A scaler maps each series id to
``(a, b)``: ``(mean, std)`` for ``zscore``, ``(min, max)`` for ``minmax``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

ScalerDict = Dict[str, Tuple[float, float]]


def scaler_arrays(
    ids: List[str], scaler: Optional[ScalerDict], method: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorise a scaler dict into per-column (shift, scale) arrays.

    The transform is ``(x - shift) / scale`` and its inverse
    ``x * scale + shift``.
    """

    n = len(ids)
    shift = np.zeros(n, dtype=np.float32)
    scale = np.ones(n, dtype=np.float32)
    if scaler is None or method == "none":
        return shift, scale
    for j, c in enumerate(ids):
        a, b = scaler[c]
        if method == "zscore":
            shift[j] = a
            scale[j] = b if b != 0 else 1.0
        elif method == "minmax":
            rng = (b - a) if (b - a) != 0 else 1.0
            shift[j] = a
            scale[j] = rng
        else:
            raise ValueError(f"Unknown scaler method '{method}'")
    return shift, scale


def transform_array(
    values: np.ndarray, ids: List[str], scaler: Optional[ScalerDict], method: str
) -> np.ndarray:
    """Apply a fitted scaler to a [T, N] array column-wise."""

    if method == "none" or scaler is None:
        return values.astype(np.float32, copy=True)
    shift, scale = scaler_arrays(ids, scaler, method)
    return ((values.astype(np.float32) - shift[None, :]) / scale[None, :]).astype(np.float32)


def inverse_transform(
    arr: np.ndarray, ids: List[str], scaler: Optional[ScalerDict], method: str
) -> np.ndarray:
    """Invert the fitted scaler on a [T_or_H, N] array."""

    if method == "none" or scaler is None:
        return arr.astype(np.float32, copy=True)
    shift, scale = scaler_arrays(ids, scaler, method)
    return (arr.astype(np.float32) * scale[None, :] + shift[None, :]).astype(np.float32)
