"""Train/validation splits over wide [T, N] frames (counterpart of
``flow_timesnet_tpu/data/split.py``, over :class:`~.pivot.WideFrame`)."""

from __future__ import annotations

from typing import Iterator, Tuple

from .pivot import WideFrame


def make_holdout_slices(wide_df: WideFrame, holdout_days: int) -> Tuple[WideFrame, WideFrame]:
    """Split the last ``holdout_days`` rows off as the validation frame."""

    if holdout_days <= 0:
        raise ValueError("holdout_days must be positive")
    return wide_df.rows(None, -holdout_days), wide_df.rows(-holdout_days, None)


def make_rolling_slices(
    wide_df: WideFrame, folds: int, step_days: int, val_len: int
) -> Iterator[Tuple[WideFrame, WideFrame]]:
    """Yield (train, val) frames with the val window stepping back from the tail.

    Fold ``k`` validates on rows ``[end - k*step - val_len, end - k*step)`` and
    trains on everything before; iteration stops once either side is empty.
    """

    end = len(wide_df)
    for k in range(folds):
        val_end = end - k * step_days
        val_start = max(0, val_end - val_len)
        trn = wide_df.rows(None, val_start)
        val = wide_df.rows(val_start, val_end)
        if len(val) == 0 or len(trn) == 0:
            break
        yield trn, val
