"""Per-series static covariates computed from the wide training frame
(counterpart of ``flow_timesnet_tpu/data/static_features.py``: the same
numpy calls in the same order, so the features are equal bit for bit).

Masked mean / std / diff-std, seasonal strength (peak non-DC rFFT power over
total non-DC power of the demeaned series) and dominant period (T / peak bin).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .pivot import WideFrame

_EPS = np.float32(1e-6)

FEATURE_NAMES: List[str] = [
    "mean",
    "std",
    "diff_std",
    "seasonal_strength",
    "dominant_period",
]


def _div(numer: np.ndarray, denom: np.ndarray) -> np.ndarray:
    return (
        numer.astype(np.float32) / np.maximum(denom.astype(np.float32), _EPS)
    ).astype(np.float32)


def compute_series_features(
    wide_df: WideFrame, mask_df: WideFrame
) -> Tuple[np.ndarray, List[str]]:
    """Return ([N, 5] float32 features, feature names) for each series."""

    if wide_df.shape != mask_df.shape:
        raise ValueError("wide_df and mask_df must have the same shape")
    values = wide_df.to_numpy(dtype=np.float32)
    mask = mask_df.to_numpy(dtype=np.float32)
    T, N = values.shape
    if N == 0:
        return np.zeros((0, len(FEATURE_NAMES)), dtype=np.float32), list(FEATURE_NAMES)

    counts = mask.sum(axis=0, dtype=np.float32)
    mean = _div((values * mask).sum(axis=0, dtype=np.float32), counts)
    centered = (values - mean[None, :]) * mask
    var = _div((centered * centered).sum(axis=0, dtype=np.float32), np.maximum(counts, 1.0))
    std = np.sqrt(np.clip(var, 0.0, None)).astype(np.float32)

    if T > 1:
        diffs = values[1:] - values[:-1]
        dmask = mask[1:] * mask[:-1]
        dcounts = dmask.sum(axis=0, dtype=np.float32)
        dmean = _div((diffs * dmask).sum(axis=0, dtype=np.float32), dcounts)
        dcentered = (diffs - dmean[None, :]) * dmask
        dvar = _div(
            (dcentered * dcentered).sum(axis=0, dtype=np.float32), np.maximum(dcounts, 1.0)
        )
        diff_std = np.sqrt(np.clip(dvar, 0.0, None)).astype(np.float32)

        demeaned = np.where(mask > 0.0, values - mean[None, :], 0.0)
        power = np.abs(np.fft.rfft(demeaned, axis=0)) ** 2
        if power.shape[0] > 1:
            non_dc = power[1:]
            peak_idx = np.argmax(non_dc, axis=0)
            peak_power = non_dc[peak_idx, np.arange(N)]
            total_power = non_dc.sum(axis=0)
            seasonal_strength = _div(peak_power, total_power)
            dominant_period = np.where(
                total_power > _EPS,
                (T / np.maximum(peak_idx + 1, 1)).astype(np.float32),
                0.0,
            ).astype(np.float32)
        else:
            seasonal_strength = np.zeros(N, dtype=np.float32)
            dominant_period = np.zeros(N, dtype=np.float32)
    else:
        diff_std = np.zeros(N, dtype=np.float32)
        seasonal_strength = np.zeros(N, dtype=np.float32)
        dominant_period = np.zeros(N, dtype=np.float32)

    features = np.stack(
        [mean, std, diff_std, seasonal_strength, dominant_period], axis=1
    ).astype(np.float32)
    return features, list(FEATURE_NAMES)
