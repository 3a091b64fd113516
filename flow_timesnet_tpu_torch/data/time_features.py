"""Calendar covariates from numpy ``datetime64`` dates (no pandas).

Counterpart of ``flow_timesnet_tpu/data/time_features.py``: the same
features, (value, period) conventions and cyclical / onehot / numeric
encodings, with each calendar field derived by ``datetime64`` arithmetic.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Sequence

import numpy as np

DEFAULT_FEATURES: List[str] = ["day_of_week", "day_of_month", "month", "day_of_year"]


def _days(t: np.ndarray) -> np.ndarray:
    return t.astype("datetime64[D]")


def _day_of_week(t):  # Monday = 0; 1970-01-01 was a Thursday
    return (_days(t).astype(np.int64) + 3) % 7


def _iso_week(t):  # ISO week - 1: the week's Thursday decides its year
    days = _days(t)
    thursday = days + (3 - _day_of_week(t)).astype("timedelta64[D]")
    return (thursday - thursday.astype("datetime64[Y]")).astype(np.int64) // 7


# feature name -> (extractor over datetime64[m] values, period)
_EXTRACTORS = {
    "day_of_week": (_day_of_week, 7),
    "day_of_month": (lambda t: (_days(t) - t.astype("datetime64[M]")).astype(np.int64), 31),
    "month": (lambda t: t.astype("datetime64[M]").astype(np.int64) % 12, 12),
    "hour": (lambda t: (t - _days(t)).astype("timedelta64[h]").astype(np.int64), 24),
    "minute": (lambda t: (t - t.astype("datetime64[h]")).astype(np.int64), 60),
    "day_of_year": (lambda t: (_days(t) - t.astype("datetime64[Y]")).astype(np.int64), 366),
    "week_of_year": (_iso_week, 53),
}


def _encoding_for(feature: str, encoding: Any) -> str:
    if isinstance(encoding, Mapping):
        value = encoding.get(feature, encoding.get("default", "cyclical"))
    else:
        value = encoding
    enc = str(value).lower()
    if enc not in {"cyclical", "onehot", "numeric"}:
        raise ValueError(
            f"Unsupported encoding '{value}' for feature '{feature}'. "
            "Expected 'cyclical', 'onehot', or 'numeric'."
        )
    return enc


def _encode(values: np.ndarray, period: int, encoding: str, normalize: bool) -> np.ndarray:
    values = np.asarray(values).reshape(-1).astype(np.int64)
    if period <= 0:
        period = max(int(values.max(initial=0) - values.min(initial=0) + 1), 1)
    mod = np.mod(values, period)
    if encoding == "cyclical":
        angles = 2.0 * np.pi * (mod.astype(np.float32) / float(max(period, 1)))
        return np.stack([np.sin(angles), np.cos(angles)], axis=1).astype(np.float32)
    if encoding == "onehot":
        onehot = np.zeros((values.size, period), dtype=np.float32)
        if values.size:
            onehot[np.arange(values.size), mod] = 1.0
        return onehot
    numeric = mod.astype(np.float32)
    if normalize and period > 1:
        numeric = numeric / float(period - 1)
    return numeric.reshape(-1, 1)


def build_time_features(dates: Sequence, config: Mapping[str, Any] | None) -> np.ndarray:
    """Build a float32 [T, F] covariate matrix from ``datetime64`` dates."""

    cfg = dict(config or {})
    t = np.asarray(dates).astype("datetime64[m]")
    if not bool(cfg.get("enabled", False)):
        return np.zeros((len(t), 0), dtype=np.float32)
    encoding_cfg = cfg.get("encoding", "cyclical")
    normalize = bool(cfg.get("normalize", True))
    blocks: List[np.ndarray] = []
    for feature in cfg.get("features") or DEFAULT_FEATURES:
        spec = _EXTRACTORS.get(feature)
        if spec is None:
            raise ValueError(f"Unsupported time feature '{feature}'.")
        extractor, period = spec
        block = _encode(extractor(t), period, _encoding_for(feature, encoding_cfg), normalize)
        if block.size:
            blocks.append(block)
    if not blocks:
        return np.zeros((len(t), 0), dtype=np.float32)
    return np.hstack(blocks).astype(np.float32)
