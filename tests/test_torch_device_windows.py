"""The port's device-resident window pipeline against the JAX package's.

``stage_windows``, ``gather_batch`` and ``epoch_index_plan`` of
``flow_timesnet_tpu_torch/data/device_windows.py`` take the same numpy
inputs as ``flow_timesnet_tpu/data/device_windows.py`` and must give the
same values exactly (they only move and zero values): several folds of
unequal length (one too short for a window), padded rows, stride 2, a
recursive horizon and ``y_mark``. The port's gather must also equal the
port's own host ``WindowBatcher`` on the same sample indices, as
``tests/test_device_windows.py`` holds the JAX package's. Augmentation is
held in ``tests/test_torch_augment.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flow_timesnet_tpu.data import device_windows as jdw  # noqa: E402
from flow_timesnet_tpu_torch.data import device_windows as dw  # noqa: E402
from flow_timesnet_tpu_torch.data import windows  # noqa: E402

ARRAY_FIELDS = ("X", "M", "marks", "static", "sigma", "offsets", "max_start")
STATIC_FIELDS = ("input_len", "horizon", "stride", "num_series", "total", "noise_std",
                 "time_shift")


def _folds(n_folds=3, T=40, N=3, with_marks=True, seed=0):
    """Folds of unequal length (40, 43, 46, ...) and one too short for a
    window (10 steps), with masks, calendar marks, static features and
    per-series floors."""

    rng = np.random.default_rng(seed)
    arrays, masks, marks = [], [], []
    for T_f in [T + 3 * f for f in range(n_folds)] + [10]:
        arrays.append(rng.normal(5.0, 2.0, size=(T_f, N)).astype(np.float32))
        masks.append((rng.random((T_f, N)) > 0.1).astype(np.float32))
        marks.append(rng.normal(size=(T_f, 5)).astype(np.float32) if with_marks else None)
    static = rng.normal(size=(N, 4)).astype(np.float32)
    sigma = np.linspace(0.1, 0.3, N).astype(np.float32)
    return arrays, masks, marks, static, sigma


def _stage_both(arrays, masks, marks, static, sigma, L, pred_len, stride, mode, rec=None):
    kw = dict(recursive_pred_len=rec, marks=marks, static=static, sigma_vector=sigma)
    want = jdw.stage_windows(arrays, masks, L, pred_len, stride, mode, **kw)
    got = dw.stage_windows(arrays, masks, L, pred_len, stride, mode, device="cpu", **kw)
    return got, want


def _assert_same(got, want, keys):
    for k in keys:
        g, w = got[k], want[k]
        assert (g is None) == (w is None), k
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("with_marks", [True, False], ids=["marks", "no_marks"])
def test_stage_windows_matches_jax(with_marks):
    arrays, masks, marks, static, sigma = _folds(with_marks=with_marks)
    got, want = _stage_both(arrays, masks, marks if with_marks else None, static, sigma,
                            8, 4, 1, "direct")
    _assert_same(vars(got), vars(want), ARRAY_FIELDS)
    for k in STATIC_FIELDS:
        assert getattr(got, k) == getattr(want, k), k
    assert got.X.shape == (3, 46, 3)  # the short fold is left out, the rest padded to T_max
    assert got.offsets.dtype == torch.int32 and got.max_start.dtype == torch.int32
    assert got.has_marks == with_marks


def test_stage_windows_with_no_usable_fold_is_none():
    arrays, masks, marks, static, sigma = _folds()
    assert dw.stage_windows(arrays, masks, 60, 4, 1, "direct", device="cpu") is None


CASES = {
    # (L, pred_len, stride, mode, recursive_pred_len, with_y_mark)
    "direct": (8, 4, 1, "direct", None, False),
    "stride_2": (8, 4, 2, "direct", None, False),
    "recursive_y_mark": (12, 6, 1, "recursive", 6, True),
    "recursive_stride_3": (12, 6, 3, "recursive", None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded_rows"])
def test_gather_batch_matches_jax(case, padded):
    L, pred_len, stride, mode, rec, y_mark = CASES[case]
    arrays, masks, marks, static, sigma = _folds(seed=1)
    got_s, want_s = _stage_both(arrays, masks, marks, static, sigma, L, pred_len, stride,
                                mode, rec)
    assert got_s.total == want_s.total > 0
    rng = np.random.default_rng(7)
    idx = rng.choice(want_s.total, size=min(24, want_s.total), replace=False).astype(np.int32)
    rv = np.ones(len(idx), np.float32)
    if padded:  # the plan's padding: index 0, row_valid 0
        idx[-5:], rv[-5:] = 0, 0.0
    want = jdw.gather_batch(want_s, jnp.asarray(idx), jnp.asarray(rv), with_y_mark=y_mark)
    got = dw.gather_batch(got_s, torch.from_numpy(idx), torch.from_numpy(rv),
                          with_y_mark=y_mark)
    assert sorted(got) == sorted(want)
    _assert_same(got, want, sorted(want))
    assert got["ids"].dtype == torch.int32 and got["ids"].shape == (len(idx), 1)
    if padded:
        assert not bool(got["x"][-5:].any()) and not bool(got["ids"][-5:].any())


@pytest.mark.parametrize("padded_batch", [None, 24], ids=["rows", "padded_to_24"])
@pytest.mark.parametrize("drop_last", [False, True], ids=["keep_last", "drop_last"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_epoch_index_plan_matches_jax(shuffle, drop_last, padded_batch):
    for total in (50, 48, 7):
        kw = dict(shuffle=shuffle, drop_last=drop_last)
        want = jdw.epoch_index_plan(total, 16, padded_batch,
                                    rng=np.random.default_rng([3, 1]) if shuffle else None, **kw)
        got = dw.epoch_index_plan(total, 16, padded_batch,
                                  rng=np.random.default_rng([3, 1]) if shuffle else None, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="shuffle requires"):
        dw.epoch_index_plan(50, 16, shuffle=True, drop_last=True, rng=None)


@pytest.mark.parametrize("stride", [1, 2])
def test_gather_matches_the_window_batcher(stride):
    """The staged gather against the port's host batcher on the same flat
    sample indices, over the batcher's own sources (the trainer stages
    those)."""

    arrays, masks, marks, static, sigma = _folds(seed=2)
    N = arrays[0].shape[1]
    sources = [windows.SlidingWindowSource(a, 8, 4, "direct", stride=stride, valid_mask=m,
                                           series_static=static, series_ids=np.arange(N),
                                           time_features=f)
               for a, m, f in zip(arrays, masks, marks)]
    batcher = windows.WindowBatcher(sources, 16, shuffle=False, drop_last=False, pad_final=True)
    kept = batcher.sources
    staged = dw.stage_windows([s.X for s in kept], [s.M for s in kept], 8, 4, stride, "direct",
                              marks=[s.marks for s in kept], static=static, sigma_vector=sigma,
                              device="cpu")
    assert staged.total == batcher.total
    idx = np.random.default_rng(42).choice(batcher.total, size=24, replace=False)
    host = batcher._gather_global(idx)
    dev = dw.gather_batch(staged, torch.from_numpy(idx.astype(np.int32)), torch.ones(len(idx)),
                          with_y_mark=True)
    for key, want in (("x", host.x), ("y", host.y), ("mask", host.mask), ("x_mark", host.x_mark),
                      ("y_mark", host.y_mark), ("static", host.static),
                      ("ids", host.series_ids), ("row_valid", host.row_valid)):
        np.testing.assert_array_equal(dev[key].numpy(), want, err_msg=key)
    np.testing.assert_array_equal(dev["floor"].numpy().reshape(-1),
                                  sigma[host.series_ids.reshape(-1)])
