"""The port's pandas-free ingestion against the JAX package's pandas path,
bit for bit, on both generators' CSVs (``tools/make_demand_benchmark.py``
at 3 stores x 5 menus x 120 days, a BOM and Korean columns;
``tools/make_long_context_benchmark.py`` at 5 series x 300 hours, hourly
stamps).

Held equal: the CSV reader's columns and inferred types against
``pd.read_csv``; the resolved schema (configured and detected); the wide
values and the mask (NaN where a row is missing), ids, dates and ``freq``
against both ``read_long_pivot`` (the JAX package's native reader) and
``pivot_long_to_wide`` over ``pd.read_csv``; the holdout and rolling
splits; the zscore and minmax scalers (per series and global) and the
frames they give; the static features. Also the duplicate-(date, id)
error, a sub-daily gap filled by ``_fill_grid`` (and irregular stamps left
as they are), whitespace ids normalised, and the temporal-coverage
analysis of an extra column.
"""

import os
import sys

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("jax")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

from flow_timesnet_tpu.data import pivot as jpivot  # noqa: E402
from flow_timesnet_tpu.data import split as jsplit  # noqa: E402
from flow_timesnet_tpu.data import static_features as jstatic  # noqa: E402
from flow_timesnet_tpu.data.schema import DataSchema as JSchema  # noqa: E402
from flow_timesnet_tpu_torch.data import csv_long  # noqa: E402
from flow_timesnet_tpu_torch.data import pivot as ppivot  # noqa: E402
from flow_timesnet_tpu_torch.data import split as psplit  # noqa: E402
from flow_timesnet_tpu_torch.data import static_features as pstatic  # noqa: E402
from flow_timesnet_tpu_torch.data.schema import DataSchema as PSchema  # noqa: E402

DEMAND = ("영업일자", "영업장명_메뉴명", "매출수량")
LONG = ("date", "id", "target")


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    from make_demand_benchmark import write_benchmark as demand
    from make_long_context_benchmark import write_benchmark as long_context

    root = tmp_path_factory.mktemp("ingest")
    demand(str(root / "demand"), seed=7, n_stores=3, n_menus=5, t_train=120)
    long_context(str(root / "long"), seed=5, n_series=5, t_train=300)
    return {"demand": (root / "demand" / "train.csv", "utf-8-sig", DEMAND, "D"),
            "long": (root / "long" / "train.csv", "utf-8", LONG, "h")}


CASES = ["demand", "long"]


def _frames(csvs, case):
    path, enc, cols, _ = csvs[case]
    native = jpivot.read_long_pivot(str(path), *cols, fillna0=False, encoding=enc)
    pandas = jpivot.pivot_long_to_wide(pd.read_csv(path, encoding=enc), *cols, fillna0=False)
    port = ppivot.read_long_pivot(str(path), *cols, fillna0=False, encoding=enc)
    return native, pandas, port


def _same_frame(want, got):
    np.testing.assert_array_equal(got.values, want.to_numpy(), strict=True)
    assert got.columns == list(want.columns)
    np.testing.assert_array_equal(got.index, want.index.values.astype("datetime64[s]"))


@pytest.mark.parametrize("case", CASES)
def test_reader_equals_read_csv(csvs, case):
    path, enc, _, _ = csvs[case]
    want = pd.read_csv(path, encoding=enc)
    got = csv_long.read_csv_long(str(path), encoding=enc)
    assert got.columns == list(want.columns) and len(got) == len(want)
    for name in want.columns:
        col = want[name]
        if pd.api.types.is_numeric_dtype(col):
            np.testing.assert_array_equal(got[name], col.to_numpy(), strict=True)
        else:
            assert got[name].dtype == object and list(got[name]) == list(col)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("configured", [True, False])
def test_schema_equals_jax(csvs, case, configured):
    path, enc, cols, _ = csvs[case]
    cfg = dict(zip(("date_col", "id_col", "target_col"), cols)) if configured else {}
    want = JSchema.from_config(cfg, sample_df=pd.read_csv(path, encoding=enc))
    got = PSchema.from_config(cfg, sample_df=csv_long.read_csv_long(str(path), encoding=enc))
    assert got.as_dict() == want.as_dict() == dict(zip(("date", "id", "target"), cols))
    assert got.sources == want.sources and got.detection == want.detection


@pytest.mark.parametrize("case", CASES)
def test_wide_values_mask_ids_and_dates_equal_jax(csvs, case):
    native, pandas, port = _frames(csvs, case)
    for want in (native, pandas):
        _same_frame(want, port)
    assert np.isnan(port.values).any()  # missing rows of the generator
    np.testing.assert_array_equal(port.isna(), native.isna().to_numpy())
    want_freq = csvs[case][3]
    assert (port.freq or ppivot.infer_freq(port.index)) == want_freq
    assert (pandas.index.freqstr or pd.infer_freq(pandas.index)) == want_freq


@pytest.mark.parametrize("case", CASES)
def test_splits_scalers_and_static_features_equal_jax(csvs, case):
    _, want_raw, got_raw = _frames(csvs, case)
    want_mask = (~want_raw.isna()).astype(np.float32)
    got_mask = got_raw.with_values((~got_raw.isna()).astype(np.float32))
    want = want_raw.fillna(0.0)
    got = got_raw.fillna(0.0)
    feats_w, names_w = jstatic.compute_series_features(want, want_mask)
    feats_g, names_g = pstatic.compute_series_features(got, got_mask)
    np.testing.assert_array_equal(feats_g, feats_w, strict=True)
    assert names_g == names_w
    want, got = want.clip(lower=0.0), got.clip_lower(0.0)
    pairs = [(jsplit.make_holdout_slices(want, 40), psplit.make_holdout_slices(got, 40))]
    pairs += list(zip(jsplit.make_rolling_slices(want, 3, 7, 40),
                      psplit.make_rolling_slices(got, 3, 7, 40)))
    assert len(pairs) == 4
    for (tr_w, va_w), (tr_g, va_g) in pairs:
        for w, g in ((tr_w, tr_g), (va_w, va_g)):
            np.testing.assert_array_equal(g.to_numpy(np.float32), w.to_numpy(dtype=np.float32),
                                          strict=True)
            np.testing.assert_array_equal(g.index, w.index.values.astype("datetime64[s]"))
        for method in ("zscore", "minmax"):
            for per_series in (True, False):
                sw, nw = jpivot.fit_series_scaler(tr_w, method, per_series)
                sg, ng = ppivot.fit_series_scaler(tr_g, method, per_series)
                assert sg == sw
                np.testing.assert_array_equal(ng.to_numpy(np.float32),
                                              nw.to_numpy(dtype=np.float32), strict=True)
                vw = jpivot.transform_dataframe(va_w, list(want.columns), sw, method)
                vg = ppivot.transform_dataframe(va_g, got.columns, sg, method)
                np.testing.assert_array_equal(vg.to_numpy(np.float32),
                                              vw.to_numpy(dtype=np.float32), strict=True)


def _write(path, rows, header=("date", "id", "target")):
    pd.DataFrame(rows, columns=list(header)).to_csv(path, index=False)
    return str(path)


def test_duplicate_rows_raise_in_both(tmp_path):
    path = _write(tmp_path / "dup.csv", [("2024-01-01", "a", 1), ("2024-01-02", "a", 2),
                                         ("2024-01-01", "a ", 3)])
    for pivot in (lambda: jpivot.pivot_long_to_wide(pd.read_csv(path), *LONG),
                  lambda: ppivot.read_long_pivot(path, *LONG)):
        with pytest.raises(ValueError, match="duplicate entries"):
            pivot()


@pytest.mark.parametrize("stamps,filled", [
    (["2024-01-01 00:00:00", "2024-01-01 01:00:00", "2024-01-01 04:00:00",
      "2024-01-01 05:00:00"], True),  # hourly with a gap: filled at 1 h
    (["2024-01-01 00:30:00", "2024-01-01 01:00:00", "2024-01-01 02:30:00"], True),  # 30 min
    (["2024-01-01 00:00:00", "2024-01-01 02:00:00", "2024-01-01 03:00:00",
      "2024-01-01 06:30:00"], False),  # off the 1 h grid: left as read
    (["2024-01-01", "2024-01-03", "2024-01-04"], True),  # daily with a gap
])
def test_fill_grid_at_the_index_resolution(tmp_path, stamps, filled):
    rows = [(s, sid, i) for i, s in enumerate(stamps) for sid in ("x  y", "b")]
    path = _write(tmp_path / "grid.csv", rows)
    want = jpivot.pivot_long_to_wide(pd.read_csv(path), *LONG, fillna0=False)
    got = ppivot.read_long_pivot(path, *LONG, fillna0=False)
    _same_frame(want, got)
    assert got.columns == ["b", "x_y"]
    assert (len(got) > len(stamps)) is filled
    assert got.freq == want.index.freqstr
    want0 = jpivot.pivot_long_to_wide(pd.read_csv(path), *LONG)
    np.testing.assert_array_equal(ppivot.read_long_pivot(path, *LONG).values, want0.to_numpy())


def test_coverage_of_an_extra_column_equals_jax(tmp_path):
    rows = [(f"2024-01-{d:02d}", sid, d, d if d > 3 else None)
            for d in range(1, 11) for sid in ("a", "b")]
    path = _write(tmp_path / "extra.csv", rows, ("date", "id", "target", "promo"))
    cfg = {"date_col": "date", "id_col": "id", "target_col": "target"}
    want = JSchema.from_config(cfg, sample_df=pd.read_csv(path))
    got = PSchema.from_config(cfg, sample_df=csv_long.read_csv_long(path))
    assert got.detection == want.detection
    assert got.detection["coverage"]["promo"]["missing_prefix"] is True
    with pytest.raises(ValueError, match="Schema evolution"):
        PSchema.from_config({**cfg, "schema_evolution_policy": "error"},
                            sample_df=csv_long.read_csv_long(path))
