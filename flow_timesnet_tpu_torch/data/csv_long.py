"""A long-format CSV reader on the standard ``csv`` module and numpy.

The port's stand-in for the JAX trainer's ``pd.read_csv``: it honours the
file's ``encoding`` (``utf-8-sig`` strips a byte-order mark) and returns a
:class:`LongTable`, each column one numpy array. A column's type is
inferred as ``pd.read_csv`` infers it: int64 where every cell is an
integer, float64 (NaN for a missing cell) where every present cell is a
number, else an object array of strings (None for a missing cell). A cell
is missing where it is empty or one of pandas' default NA spellings.
Numbers are parsed by Python's ``int``/``float`` (correctly rounded); the
integer counts of the benchmark data read the same under any parser.
"""

from __future__ import annotations

import csv
from typing import Dict, Iterator, List

import numpy as np

# pandas' default na_values
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


class LongTable:
    """Columns of a long-format table: ``table[name]`` is a numpy array."""

    def __init__(self, data: Dict[str, np.ndarray]) -> None:
        lengths = {len(v) for v in data.values()}
        if len(lengths) > 1:
            raise ValueError("every column of a table must have the same length")
        self.data = dict(data)

    @property
    def columns(self) -> List[str]:
        return list(self.data)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0


def _column(cells: List[str]) -> np.ndarray:
    """One column's cells as int64, float64 or object, as pandas infers."""

    missing = [c in NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return np.full(len(cells), np.nan)
    try:
        ints = [int(c) for c in present]
        if not any(missing):
            return np.asarray(ints, dtype=np.int64)
    except ValueError:
        pass
    try:
        values = iter([float(c) for c in present])
        return np.asarray([np.nan if m else next(values) for m in missing], dtype=np.float64)
    except ValueError:
        out = np.empty(len(cells), dtype=object)
        out[:] = [None if m else c for c, m in zip(cells, missing)]
        return out


def _rows(path: str, encoding: str) -> Iterator[List[str]]:
    with open(path, "r", encoding=encoding, newline="") as f:
        yield from csv.reader(f)


def read_csv_long(path: str, encoding: str = "utf-8") -> LongTable:
    """Read a CSV with a header row into a :class:`LongTable`."""

    rows = _rows(path, encoding)
    try:
        header = next(rows)
    except StopIteration:
        raise ValueError(f"{path} is empty: no header row") from None
    if header and header[0].startswith("\ufeff"):  # a byte-order mark, as pandas drops it
        header[0] = header[0][1:]
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: duplicate column names in the header {header}")
    cells: List[List[str]] = [[] for _ in header]
    for i, row in enumerate(rows):
        if not row:
            continue
        if len(row) > len(header):
            raise ValueError(f"{path}: row {i + 2} has {len(row)} fields, the header "
                             f"{len(header)}")
        row = row + [""] * (len(header) - len(row))
        for col, value in zip(cells, row):
            col.append(value)
    return LongTable({name: _column(col) for name, col in zip(header, cells)})


def _stamp(text) -> np.datetime64:
    """One cell as ``datetime64[s]``, NaT where it is not an ISO date or
    date-time (``YYYY-MM-DD``, with a ``T`` or a space before ``HH:MM[:SS]``;
    ``YYYY/MM/DD`` too)."""

    if not isinstance(text, str):
        return np.datetime64("NaT", "s")
    s = text.strip()
    if len(s) >= 10 and s[4] == "/" and s[7] == "/":
        s = f"{s[:4]}-{s[5:7]}-{s[8:]}"
    if len(s) < 10 or not (s[:4].isdigit() and s[4] == "-" and s[7] == "-"):
        return np.datetime64("NaT", "s")
    try:
        return np.datetime64(s, "s")
    except ValueError:
        return np.datetime64("NaT", "s")


def parse_datetimes(values: np.ndarray) -> np.ndarray:
    """``pd.to_datetime(values, errors="coerce")`` for the ISO stamps of the
    pipeline's CSVs: a ``datetime64[s]`` array, NaT where a cell does not
    parse. Each distinct cell is parsed once."""

    values = np.asarray(values)
    if np.issubdtype(values.dtype, np.datetime64):
        return values.astype("datetime64[s]")
    if values.dtype.kind not in "OU":
        return np.full(values.shape, np.datetime64("NaT", "s"))
    uniq, inverse = np.unique(values.astype(object).astype(str), return_inverse=True)
    parsed = np.array([_stamp(u) for u in uniq], dtype="datetime64[s]")
    out = parsed[inverse.reshape(-1)].reshape(values.shape)
    if values.dtype.kind == "O":  # a missing cell (None) is NaT, not the string "None"
        out[np.array([v is None for v in values.reshape(-1)]).reshape(values.shape)] = (
            np.datetime64("NaT", "s"))
    return out
