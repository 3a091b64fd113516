"""Long-to-wide pivoting, id normalisation and per-series scalers, in numpy
(counterpart of ``flow_timesnet_tpu/data/pivot.py``).

The JAX package's pandas frames become a :class:`WideFrame`: a
``datetime64[s]`` index, the sorted id list and a ``[T, N]`` array (NaN for
a missing value before the fill). The functions run the JAX package's numpy
calls in its order, so the wide values, the mask and the scaler come out
equal to its own, bit for bit. A scaler maps each series id to ``(a, b)``:
``(mean, std)`` for ``zscore``, ``(min, max)`` for ``minmax``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .csv_long import LongTable, parse_datetimes, read_csv_long

ScalerDict = Dict[str, Tuple[float, float]]

_DAY = np.timedelta64(1, "D")
_WEEKDAYS = ("MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN")


@dataclass
class WideFrame:
    """A wide ``[T, N]`` table: ``values[t, j]`` is series ``columns[j]`` at
    ``index[t]``. ``freq`` is the pandas alias of a filled grid's step
    (``"D"``, ``"h"``, ...), None where the rows are as read."""

    index: np.ndarray  # [T] datetime64[s]
    columns: List[str]
    values: np.ndarray  # [T, N], column-major
    freq: Optional[str] = None

    def __post_init__(self) -> None:
        # A pandas frame holds its [T, N] values column-major, and numpy's
        # sums over axis 0 (the scaler's, the static features') round by
        # layout: keep the JAX package's layout so that they agree bit for bit.
        self.values = np.asfortranarray(self.values)

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.values.shape)

    def rows(self, start: Optional[int], stop: Optional[int]) -> "WideFrame":
        """Rows ``[start, stop)`` (a slice keeps the grid's ``freq``)."""

        return WideFrame(self.index[start:stop], list(self.columns), self.values[start:stop],
                         self.freq)

    def with_values(self, values: np.ndarray) -> "WideFrame":
        """This frame's index, columns and ``freq`` around ``values``."""

        return WideFrame(self.index, list(self.columns), values, self.freq)

    def reindex_columns(self, columns: List[str]) -> "WideFrame":
        """The frame on ``columns``, in their order: a column it lacks is
        zeros, one ``columns`` lacks is dropped."""

        values = np.zeros((len(self), len(columns)), dtype=np.float64)
        column_of = {c: j for j, c in enumerate(self.columns)}
        pairs = [(j, column_of[c]) for j, c in enumerate(columns) if c in column_of]
        if pairs:
            dst, src = (list(t) for t in zip(*pairs))
            values[:, dst] = self.values[:, src]
        return WideFrame(self.index, list(columns), values, self.freq)

    def isna(self) -> np.ndarray:
        return np.isnan(self.values)

    def fillna(self, value: float) -> "WideFrame":
        return self.with_values(np.where(np.isnan(self.values), value, self.values))

    def clip_lower(self, lower: float) -> "WideFrame":
        """``DataFrame.clip(lower=...)``: values below ``lower`` become it
        (NaN and -0.0 stay)."""

        v = self.values
        return self.with_values(np.where((v >= lower) | np.isnan(v), v, lower))

    def to_numpy(self, dtype=np.float32) -> np.ndarray:
        return self.values.astype(dtype)


def step_alias(step: np.timedelta64) -> str:
    """The pandas alias of a fixed step: ``"D"``, ``"h"``, ``"min"``, ``"s"``
    with a multiple where it is not 1 (``"2h"``, ``"30min"``)."""

    seconds = int(step / np.timedelta64(1, "s"))
    for unit, size in (("D", 86400), ("h", 3600), ("min", 60), ("s", 1)):
        if seconds % size == 0:
            n = seconds // size
            return unit if n == 1 else f"{n}{unit}"
    raise ValueError(f"no alias for a step of {step}")


def _at_midnight(index: np.ndarray) -> bool:
    return bool((index == index.astype("datetime64[D]")).all())


def infer_freq(index: np.ndarray) -> Optional[str]:
    """``pd.infer_freq`` for evenly spaced stamps: the alias of their step
    (``"W-SUN"`` and the like for 7 days at midnight), None where the
    spacing is uneven or there are fewer than three stamps. (pandas also
    names some uneven calendars, such as ``"B"`` or ``"MS"``; the port does
    not.)"""

    index = np.asarray(index, dtype="datetime64[s]")
    if len(index) < 3:
        return None
    steps = np.diff(index)
    if not (steps == steps[0]).all() or steps[0] <= np.timedelta64(0, "s"):
        return None
    if steps[0] == 7 * _DAY and _at_midnight(index):
        weekday = int((index[0].astype("datetime64[D]").astype(np.int64) + 3) % 7)
        return f"W-{_WEEKDAYS[weekday]}"
    return step_alias(steps[0])


def normalize_id(name: str) -> str:
    """Collapse whitespace runs to single underscores; keep unicode as-is."""

    collapsed = " ".join(str(name).split())
    return collapsed.strip().replace(" ", "_")


# the name the submission writers use
normalize_series_name = normalize_id


def build_id_col(values: np.ndarray) -> np.ndarray:
    """:func:`normalize_id` of every id: whitespace runs -> single underscore."""

    return np.array([normalize_id(v) for v in np.asarray(values, dtype=object)], dtype=object)


def _fill_grid(index: np.ndarray) -> Optional[Tuple[np.ndarray, str]]:
    """Dense timestamp grid for ``fill_missing_dates``, at the index's own
    resolution, and its alias.

    Date-like indexes (every stamp at midnight) fill missing calendar days.
    Sub-daily indexes (the hourly long-context benchmark) fill at the
    smallest observed spacing instead: reindexing them onto a daily grid
    would drop every row off midnight. If the observed stamps do not all
    lie on that grid (irregular sampling), or none is missing, return None:
    no fill beats data loss.
    """

    idx = np.asarray(index, dtype="datetime64[s]")
    if len(idx) < 2:
        return None
    if _at_midnight(idx):
        days = idx.astype("datetime64[D]")
        return np.arange(days.min(), days.max() + _DAY, _DAY).astype("datetime64[s]"), "D"
    step = np.diff(idx).min()  # index is sorted unique by construction
    full = np.arange(idx[0], idx[-1] + step, step)
    if len(full) == len(idx) or not np.isin(idx, full).all():
        return None
    return full, step_alias(step)


def pivot_long_to_wide(
    df: LongTable,
    date_col: str,
    id_col: str,
    target_col: str,
    fill_missing_dates: bool = True,
    fillna0: bool = True,
) -> WideFrame:
    """Pivot a long (date, id, target) table to a wide [T, N] frame.

    Missing stamps are filled at the index's resolution when requested
    (:func:`_fill_grid`); columns are the normalised ids in code-point
    order. The same (date, id) pair twice raises ``ValueError``.
    """

    raw_dates, raw_date_codes = np.unique(np.asarray(df[date_col]).astype(str),
                                          return_inverse=True)
    parsed_dates = parse_datetimes(raw_dates)
    if np.isnat(parsed_dates).any():
        bad = raw_dates[np.isnat(parsed_dates)][:3]
        raise ValueError(f"Column '{date_col}' holds values that are not dates: {list(bad)}")
    date_order = np.argsort(parsed_dates, kind="stable")
    date_index = parsed_dates[date_order]
    date_rank = np.empty(len(date_order), dtype=np.int64)
    date_rank[date_order] = np.arange(len(date_order))
    date_codes = date_rank[raw_date_codes.reshape(-1)]

    raw_ids, raw_id_codes = np.unique(np.asarray(df[id_col]).astype(str), return_inverse=True)
    normed_ids = build_id_col(raw_ids).astype(str)
    # normalisation can merge distinct raw ids; re-factorize the normed uniques
    id_index, id_sub_codes = np.unique(normed_ids, return_inverse=True)
    id_codes = id_sub_codes.reshape(-1)[raw_id_codes.reshape(-1)]
    T, N = len(date_index), len(id_index)
    filled = np.zeros((T, N), dtype=bool)
    filled[date_codes, id_codes] = True
    if int(filled.sum()) != len(df):
        raise ValueError(
            "Index contains duplicate entries, cannot reshape: the same "
            "(date, id) pair appears more than once"
        )
    values = np.full((T, N), np.nan, dtype=float, order="F")
    values[date_codes, id_codes] = np.asarray(df[target_col], dtype=float)
    wide = WideFrame(date_index, [str(c) for c in id_index], values)
    if fill_missing_dates:
        grid = _fill_grid(wide.index)
        if grid is not None:
            full, freq = grid
            reindexed = np.full((len(full), N), np.nan, dtype=float, order="F")
            reindexed[np.searchsorted(full, wide.index)] = values
            wide = WideFrame(full, wide.columns, reindexed, freq)
    if fillna0:
        wide = wide.fillna(0.0)
    return wide


def read_long_pivot(
    path: str,
    date_col: str,
    id_col: str,
    target_col: str,
    fill_missing_dates: bool = True,
    fillna0: bool = True,
    encoding: str = "utf-8",
) -> WideFrame:
    """:func:`~flow_timesnet_tpu_torch.data.csv_long.read_csv_long` then
    :func:`pivot_long_to_wide`."""

    return pivot_long_to_wide(
        read_csv_long(path, encoding=encoding),
        date_col=date_col,
        id_col=id_col,
        target_col=target_col,
        fill_missing_dates=fill_missing_dates,
        fillna0=fillna0,
    )


def fit_series_scaler(
    wide_df: WideFrame,
    method: str = "zscore",
    per_series: bool = True,
    eps: float = 1e-8,
) -> Tuple[Optional[ScalerDict], WideFrame]:
    """Fit a zscore/minmax scaler and return (scaler, normalised frame).

    zscore stores (mean, std) per column; minmax stores (min, max); degenerate
    spreads fall back to unit scale. ``per_series=False`` fits one global pair
    applied to every column. The reductions run in float32, as the JAX
    package's do.
    """

    ids = list(wide_df.columns)
    if method == "none":
        return None, wide_df.with_values(wide_df.values.copy(order="K"))
    values = wide_df.values.astype(np.float32)
    scaler: ScalerDict = {}
    if per_series:
        if method == "zscore":
            mu = np.mean(values, axis=0)
            sd = np.std(values, axis=0)
            sd = np.where(sd < eps, 1.0, sd)
            normed = (values - mu) / sd
            for j, c in enumerate(ids):
                scaler[c] = (float(mu[j]), float(sd[j]))
        elif method == "minmax":
            lo = np.min(values, axis=0)
            hi = np.max(values, axis=0)
            rng = np.where((hi - lo) < eps, 1.0, hi - lo)
            normed = (values - lo) / rng
            for j, c in enumerate(ids):
                scaler[c] = (float(lo[j]), float(hi[j]))
        else:
            raise ValueError(f"Unknown scaler method '{method}'")
    else:
        if method == "zscore":
            mu = float(np.mean(values))
            sd = float(np.std(values))
            sd = sd if sd >= eps else 1.0
            normed = (values - mu) / sd
            params = (mu, sd)
        elif method == "minmax":
            lo = float(np.min(values))
            hi = float(np.max(values))
            rng = (hi - lo) if (hi - lo) >= eps else 1.0
            normed = (values - lo) / rng
            params = (lo, hi)
        else:
            raise ValueError(f"Unknown scaler method '{method}'")
        for c in ids:
            scaler[c] = params
    return scaler, wide_df.with_values(normed)


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


def transform_dataframe(
    df: WideFrame, ids: List[str], scaler: Optional[ScalerDict], method: str
) -> WideFrame:
    """:func:`transform_array` of a frame (a copy where there is no scaler)."""

    if method == "none" or scaler is None:
        return df.with_values(df.values.copy(order="K"))
    return df.with_values(transform_array(df.to_numpy(np.float32), ids, scaler, method))
