"""The port's window batcher against the JAX package's.

The same wide arrays, masks, static features, series ids and dates go to
both; for the same seed and epoch both give the same batches, field by
field, with shuffle on and off and with the final batch padded.
"""

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("jax")

from flow_timesnet_tpu.data import windows as jwindows  # noqa: E402
from flow_timesnet_tpu_torch.data import windows  # noqa: E402

FIELDS = ("x", "y", "mask", "x_mark", "y_mark", "static", "series_ids", "row_valid")
TF_CFG = {"enabled": True, "features": ["day_of_week", "day_of_month", "month", "day_of_year"],
          "encoding": "cyclical", "normalize": True}


def _folds(seed):
    rng = np.random.default_rng(seed)
    folds = []
    for T, start in ((60, "2023-12-20"), (45, "2024-03-01")):
        N = 5
        values = rng.poisson(4.0, (T, N)).astype(np.float32)
        mask = (rng.random((T, N)) < 0.9).astype(np.float32)
        dates = np.datetime64(start) + np.arange(T)
        folds.append((values, mask, dates))
    static = rng.standard_normal((5, 3)).astype(np.float32)
    return folds, static


def _batchers(shuffle, drop_last, pad_final, seed=3, batch_size=32):
    folds, static = _folds(0)
    ids = np.arange(5)
    made = []
    for mod, index in ((jwindows, pd.DatetimeIndex), (windows, np.asarray)):
        sources = [
            mod.SlidingWindowSource(values, 14, 7, "direct", valid_mask=mask,
                                    series_static=static, series_ids=ids,
                                    time_index=index(dates), time_feature_config=TF_CFG)
            for values, mask, dates in folds
        ]
        made.append(mod.WindowBatcher(sources, batch_size, shuffle, drop_last, seed, pad_final))
    return made


def _assert_same_batches(jbatcher, batcher):
    assert len(batcher) == len(jbatcher) and batcher.total == jbatcher.total
    want, got = list(jbatcher), list(batcher)
    assert len(got) == len(want) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        for name in FIELDS:
            gv, wv = getattr(g, name), getattr(w, name)
            assert gv.dtype == wv.dtype, (i, name)
            np.testing.assert_array_equal(gv, wv, err_msg=f"batch {i} {name}")


@pytest.mark.parametrize("shuffle,drop_last,pad_final", [(True, True, False), (False, False, True),
                                                          (True, False, True), (False, False, False)])
def test_batches_match_jax(shuffle, drop_last, pad_final):
    jbatcher, batcher = _batchers(shuffle, drop_last, pad_final)
    _assert_same_batches(jbatcher, batcher)
    for epoch in (2, 5):  # reseeded as a pure function of (seed, epoch)
        jbatcher.set_epoch(epoch)
        batcher.set_epoch(epoch)
        _assert_same_batches(jbatcher, batcher)


def test_padded_final_batch_marks_its_rows_invalid():
    _, batcher = _batchers(False, False, True)
    *_, last = list(batcher)
    real = batcher.total % batcher.batch_size
    assert last.x.shape[0] == batcher.batch_size and real > 0
    assert last.row_valid[:real].all() and not last.row_valid[real:].any()
    assert not last.x[real:].any() and not last.series_ids[real:].any()


def test_augmentation_is_not_ported_yet():
    values = np.zeros((40, 2), np.float32)
    with pytest.raises(NotImplementedError, match="augmentation"):
        windows.SlidingWindowSource(values, 14, 7, "direct", augment={"time_shift": 2})
    with pytest.raises(ValueError, match="time_index"):
        windows.SlidingWindowSource(values, 14, 7, "direct", time_index=np.arange(3))
