"""Submission writers (counterpart of ``flow_timesnet_tpu/utils/submission.py``).

The same output contracts as the JAX package's, over small numpy frames in
place of pandas': :class:`Forecasts` (row keys, series columns and a value
matrix) in, :class:`SubmissionFrame` (a key column, then one float column a
series) out. A ``row_key`` format mirrors the sample submission's rows, and
a ``date_menu`` format is keyed by the actual forecast dates. Missing rows
follow the ``warn_fill`` / ``error`` policy; series columns are normalised
names mapped back to the sample's original headers.

:func:`read_submission` reads a wide CSV (the sample template, a written
submission) as ``pd.read_csv`` reads it, and :meth:`SubmissionFrame.to_csv`
writes the bytes that ``DataFrame.to_csv(index=False)`` writes: Python's
shortest ``repr`` of each float64, an empty cell for NaN, dates as
``YYYY-MM-DD`` when every stamp is at midnight, else ``YYYY-MM-DD
HH:MM:SS``, and quoting where the ``csv`` module's minimal quoting needs it.
"""

from __future__ import annotations

import csv
import logging
import os
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Type

import numpy as np

from ..data.csv_long import read_csv_long
from ..data.pivot import normalize_series_name
from .artifacts import parse_row_key

logger = logging.getLogger(__name__)


@dataclass
class Forecasts:
    """Forecast rows: ``values[i, j]`` is series ``columns[j]`` at row key
    ``index[i]``."""

    index: List[str]
    columns: List[str]
    values: np.ndarray  # [len(index), len(columns)]


def _is_missing(cell: Any) -> bool:
    return cell is None or (isinstance(cell, float) and np.isnan(cell))


def _key_cells(keys: Sequence[Any]) -> List[str]:
    """The text pandas writes for a key column: a datetime column as dates
    when every stamp is at midnight, else as date-times; in a column of
    mixed cells a stamp as a date-time, a missing cell empty."""

    if keys and all(isinstance(k, np.datetime64) for k in keys):
        stamps = np.asarray(keys, dtype="datetime64[s]")
        if (stamps == stamps.astype("datetime64[D]")).all():
            return [str(s) for s in stamps.astype("datetime64[D]")]
        return [str(s).replace("T", " ") for s in stamps]
    out = []
    for k in keys:
        if isinstance(k, np.datetime64):
            out.append(str(np.datetime64(k, "s")).replace("T", " "))
        elif _is_missing(k):
            out.append("")
        elif isinstance(k, (float, np.floating)):
            out.append(repr(float(k)))
        else:
            out.append(str(k))
    return out


def _float_cell(v: float) -> str:
    return "" if np.isnan(v) else repr(float(v))


@dataclass
class SubmissionFrame:
    """A wide submission as its CSV holds it: the key column (row keys, or
    ``datetime64`` forecast dates), then one float64 column a series."""

    key_column: str
    keys: List[Any]
    columns: List[str]
    values: np.ndarray  # [len(keys), len(columns)] float64

    @property
    def empty(self) -> bool:
        """``DataFrame.empty``: no rows (every frame has its key column)."""

        return len(self.keys) == 0

    def copy(self) -> "SubmissionFrame":
        return SubmissionFrame(self.key_column, list(self.keys), list(self.columns),
                               np.array(self.values, dtype=np.float64))

    def to_csv(self, path: str, encoding: str = "utf-8-sig") -> None:
        """Write the frame as ``DataFrame.to_csv(path, index=False,
        encoding=encoding)`` does."""

        with open(path, "w", encoding=encoding, newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow([self.key_column, *self.columns])
            for key, row in zip(_key_cells(self.keys), self.values):
                writer.writerow([key, *(_float_cell(v) for v in row)])


def read_submission(path: str, encoding: str = "utf-8") -> SubmissionFrame:
    """A wide CSV as ``pd.read_csv`` reads it: the first column as its
    cells (text, or numbers where every cell is one; None where missing),
    every other column as float64 (``ValueError`` where one is not
    numeric)."""

    table = read_csv_long(path, encoding=encoding)
    if not table.columns:
        raise ValueError(f"{path} has no columns")
    key_column, *columns = table.columns
    keys = table[key_column].tolist()
    values = np.empty((len(keys), len(columns)), dtype=np.float64)
    for j, name in enumerate(columns):
        col = table[name]
        if col.dtype == object:
            raise ValueError(f"{path}: column {name!r} is not numeric")
        values[:, j] = col
    return SubmissionFrame(key_column, keys, columns, values)


@dataclass
class SubmissionRowMeta:
    test_part: str
    step: int
    date: Optional[np.datetime64] = None
    source: Optional[str] = None


@dataclass
class SubmissionContext:
    predictions_columns: List[str]
    row_meta: Mapping[str, SubmissionRowMeta]
    row_order: List[str]
    test_parts: Mapping[str, Sequence[str]]
    ids: Sequence[str]
    output_order: List[str]
    normalized_to_output: Mapping[str, str]
    sample_df: Optional[SubmissionFrame]
    row_key_column: str
    date_column: str
    default_fill_value: float
    new_ids: Sequence[str]
    missing_ids: Sequence[str]
    missing_by_part: Mapping[str, Sequence[str]]

    @property
    def output_columns(self) -> List[str]:
        return [self.normalized_to_output.get(c, c) for c in self.output_order]


def _positions(labels: Sequence[str], what: str) -> Dict[str, int]:
    pos = {label: i for i, label in enumerate(labels)}
    if len(pos) != len(labels):
        raise ValueError(f"cannot reindex on an axis with duplicate labels ({what})")
    return pos


class SubmissionWriter(ABC):
    """Render predictions into a submission frame; subclasses pick the layout."""

    missing_policy: str = "warn_fill"

    def __init__(
        self,
        *,
        default_fill_value: float = 0.0,
        missing_policy: Optional[str] = None,
    ) -> None:
        self.default_fill_value = default_fill_value
        if missing_policy:
            self.missing_policy = str(missing_policy)

    def render(self, predictions: Forecasts, context: SubmissionContext) -> SubmissionFrame:
        required = [c for c in context.output_order if c not in context.new_ids]
        missing = [c for c in required if c not in predictions.columns]
        if missing:
            raise ValueError("Predictions missing required columns: " + ", ".join(missing))
        out = self._fill(predictions, context)
        expected = self._expected_columns(context)
        if [out.key_column, *out.columns] != expected:
            raise ValueError(
                f"Submission output columns mismatch; expected {expected} "
                f"but received {[out.key_column, *out.columns]}"
            )
        if len(out.keys) != len(context.row_order):
            raise ValueError(
                f"Submission row count mismatch; expected {len(context.row_order)} rows "
                f"but received {len(out.keys)}"
            )
        return out

    def _defaults(self, context: SubmissionContext) -> List[float]:
        return [self.default_fill_value] * len(context.output_order)

    def _missing_row(self, row_key: str, context: SubmissionContext, reason: str) -> List[float]:
        if self.missing_policy == "error":
            raise KeyError(f"Missing prediction for {row_key} ({reason})")
        logger.warning("Missing prediction for %s (%s); filling defaults", row_key, reason)
        return self._defaults(context)

    def _values_matrix(
        self,
        predictions: Forecasts,
        row_keys: Sequence[Optional[str]],
        context: SubmissionContext,
    ) -> np.ndarray:
        """[len(row_keys), n_output] float64 matrix aligned to ``output_order``.

        Rows whose key is ``None`` (the caller already applied the missing
        policy) or absent from ``predictions`` take the default, as do
        columns absent from ``predictions``; NaNs in present cells pass
        through.
        """

        row_pos = _positions(predictions.index, "row keys")
        col_pos = _positions(predictions.columns, "columns")
        values = np.full((len(row_keys), len(context.output_order)), self.default_fill_value,
                         dtype=np.float64)
        rows = [(i, row_pos[k]) for i, k in enumerate(row_keys) if k is not None and k in row_pos]
        cols = [(j, col_pos[c]) for j, c in enumerate(context.output_order) if c in col_pos]
        if rows and cols:
            dst_r, src_r = (list(t) for t in zip(*rows))
            dst_c, src_c = (list(t) for t in zip(*cols))
            src = np.asarray(predictions.values, dtype=np.float64)
            values[np.ix_(dst_r, dst_c)] = src[np.ix_(src_r, src_c)]
        return values

    @abstractmethod
    def _expected_columns(self, context: SubmissionContext) -> List[str]:
        ...

    @abstractmethod
    def _fill(self, predictions: Forecasts, context: SubmissionContext) -> SubmissionFrame:
        ...


class RowKeyLongWriter(SubmissionWriter):
    """Wide submission keyed by row_key; follows the sample template rows."""

    def _expected_columns(self, context: SubmissionContext) -> List[str]:
        return [context.row_key_column, *context.output_columns]

    def _fill(self, predictions: Forecasts, context: SubmissionContext) -> SubmissionFrame:
        if context.sample_df is not None:
            # the template's integer zeros become floats, as the JAX writer casts them
            df = context.sample_df.copy()
        else:
            df = SubmissionFrame(context.row_key_column, list(context.row_order),
                                 list(context.output_columns),
                                 np.full((len(context.row_order), len(context.output_columns)),
                                         float(context.default_fill_value)))
        missing_cols = [c for c in context.output_columns if c not in df.columns]
        if missing_cols:
            raise KeyError(f"{missing_cols} not in the submission template's columns")
        canon: List[Optional[str]] = []
        for raw in df.keys:
            try:
                part, step = parse_row_key("nan" if _is_missing(raw) else str(raw))
                row_key = f"{part}+D{int(step)}"
            except ValueError:
                self._missing_row(str(raw), context, "invalid_row_key")
                canon.append(None)
                continue
            if row_key not in context.row_meta:
                self._missing_row(row_key, context, "unknown_row")
                canon.append(None)
            elif row_key not in predictions.index:
                self._missing_row(row_key, context, "missing_prediction")
                canon.append(None)
            else:
                canon.append(row_key)
        targets = [df.columns.index(c) for c in context.output_columns]
        df.values[:, targets] = self._values_matrix(predictions, canon, context)
        return df


class DateMenuWriter(SubmissionWriter):
    """Submission with actual forecast dates in the first column."""

    def _expected_columns(self, context: SubmissionContext) -> List[str]:
        return [context.date_column, *context.output_columns]

    def _fill(self, predictions: Forecasts, context: SubmissionContext) -> SubmissionFrame:
        dates: List[Any] = []
        canon: List[Optional[str]] = []
        index = set(predictions.index)
        for row_key in context.row_order:
            meta = context.row_meta.get(row_key)
            dates.append(meta.date if meta and meta.date is not None else row_key)
            if row_key in index:
                canon.append(row_key)
            else:
                self._missing_row(row_key, context, "missing_prediction")
                canon.append(None)
        values = self._values_matrix(predictions, canon, context)
        return SubmissionFrame(context.date_column, dates, list(context.output_columns), values)


WRITER_REGISTRY: Dict[str, Type[SubmissionWriter]] = {
    "date_menu": DateMenuWriter,
    "row_key": RowKeyLongWriter,
    "row_key_long": RowKeyLongWriter,
}


def get_submission_writer(name: str) -> Type[SubmissionWriter]:
    key = (name or "date_menu").lower()
    if key not in WRITER_REGISTRY:
        raise KeyError(f"Unknown submission writer format '{name}'")
    return WRITER_REGISTRY[key]


def build_submission_context(
    *,
    predictions: Forecasts,
    sample_df: Optional[SubmissionFrame],
    row_meta: Mapping[str, SubmissionRowMeta],
    row_order: Sequence[str],
    test_parts: Mapping[str, Sequence[str]],
    ids: Sequence[str],
    new_ids: Sequence[str],
    missing_ids: Sequence[str],
    missing_by_part: Mapping[str, Sequence[str]],
    submission_cfg: Mapping[str, object],
) -> SubmissionContext:
    default_fill_value = float(submission_cfg.get("default_fill_value", 0.0) or 0.0)
    date_column = str(submission_cfg.get("date_col", "date"))
    row_key_column = str(submission_cfg.get("row_key_col", "row_key"))

    if sample_df is not None and not sample_df.empty:
        row_key_column = str(sample_df.key_column)
        menu_columns = list(sample_df.columns)
    else:
        menu_columns = list(ids)
        for candidate in new_ids:
            if candidate not in menu_columns:
                menu_columns.append(candidate)
    normalized = [normalize_series_name(c) for c in menu_columns]

    return SubmissionContext(
        predictions_columns=list(predictions.columns),
        row_meta=row_meta,
        row_order=list(row_order),
        test_parts=test_parts,
        ids=list(ids),
        output_order=normalized,
        normalized_to_output=dict(zip(normalized, menu_columns)),
        sample_df=sample_df,
        row_key_column=row_key_column,
        date_column=date_column,
        default_fill_value=default_fill_value,
        new_ids=list(new_ids),
        missing_ids=list(missing_ids),
        missing_by_part=missing_by_part,
    )


def merge_forecasts(pred_list: List[Forecasts]) -> Forecasts:
    """Concatenate per-test-file forecasts, normalising series headers.

    Frames with other columns join as ``pd.concat`` joins them: the union of
    the columns in order of appearance, NaN where a frame lacks one.
    """

    normed = [Forecasts(list(f.index), [normalize_series_name(c) for c in f.columns],
                        np.asarray(f.values)) for f in pred_list]
    columns: List[str] = []
    for f in normed:
        columns.extend(c for c in f.columns if c not in columns)
    dtype = np.result_type(*(f.values.dtype for f in normed)) if normed else np.float64
    blocks = []
    for f in normed:
        if f.columns == columns:
            blocks.append(f.values.astype(dtype, copy=False))
            continue
        block = np.full((len(f.index), len(columns)), np.nan, dtype=np.result_type(dtype, np.float32))
        block[:, [columns.index(c) for c in f.columns]] = f.values
        blocks.append(block)
    values = (np.concatenate(blocks, axis=0) if blocks
              else np.zeros((0, len(columns)), dtype=np.float64))
    return Forecasts([k for f in normed for k in f.index], columns, values)


def write_submission(frame: SubmissionFrame, path: str) -> None:
    """Write a submission where the pipeline writes it: the directory made
    as needed, UTF-8 with a byte-order mark."""

    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    frame.to_csv(path, encoding="utf-8-sig")
