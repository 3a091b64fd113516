"""``chip_smoke.py``'s numpy CSV writers against the in-repo generators:
the card trains and predicts on the recipes' own data only if the files
(``train.csv``, the TEST files and ``sample_submission.csv``) are the same,
byte for byte. Reduced sizes: the demand benchmark at 2 x 3 and 3 x 2
stores x menus over 90 days (and one store block past 26, where names gain
a digit), the long-context benchmark at 3 series x 200 hours. ``long_data``
(the long phases' in-memory arrays) is the generator's simulation too."""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("pandas")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import make_demand_benchmark  # noqa: E402
import make_long_context_benchmark  # noqa: E402


def assert_same_files(tmp_path, test_files):
    """``smoke/`` holds the generator's CSVs (``gen/``), byte for byte."""

    names = ["train.csv", "sample_submission.csv",
             *(f"test/TEST_{i:02d}.csv" for i in range(test_files))]
    for name in names:
        assert (tmp_path / "smoke" / name).read_bytes() == (tmp_path / "gen" / name).read_bytes(), \
            name
    smoke = {p.relative_to(tmp_path / "smoke") for p in (tmp_path / "smoke").rglob("*.csv")}
    assert sorted(str(p) for p in smoke) == sorted(names)


@pytest.mark.parametrize("stores,menus,days,seed", [(2, 3, 90, 7), (3, 2, 90, 11), (28, 1, 40, 3)])
def test_demand_csv_is_the_generators(tmp_path, stores, menus, days, seed):
    make_demand_benchmark.write_benchmark(str(tmp_path / "gen"), seed, n_stores=stores,
                                          n_menus=menus, t_train=days)
    rows = chip_smoke.write_demand_csv(np, tmp_path / "smoke" / "train.csv", seed, stores, menus,
                                       days)
    want = (tmp_path / "gen" / "train.csv").read_bytes()
    assert want.startswith(b"\xef\xbb\xbf")
    assert rows == want.count(b"\n") - 1
    assert_same_files(tmp_path, 5)


@pytest.mark.parametrize("series,hours,seed", [(3, 200, 5), (9, 120, 1)])
def test_long_context_csv_is_the_generators(tmp_path, series, hours, seed):
    make_long_context_benchmark.write_benchmark(str(tmp_path / "gen"), seed, series, hours)
    rows = chip_smoke.write_long_context_csv(np, tmp_path / "smoke" / "train.csv", seed, series,
                                             hours)
    want = (tmp_path / "gen" / "train.csv").read_bytes()
    assert rows == want.count(b"\n") - 1
    assert_same_files(tmp_path, 2)


def test_the_long_phases_data_is_the_generators_simulation():
    dates, demand, observed, _, _ = make_long_context_benchmark.simulate(
        5, chip_smoke.LONG_SERIES,
        chip_smoke.LONG_HOURS - chip_smoke.LONG_TEST_FILES * chip_smoke.LONG_HORIZON
        - chip_smoke.LONG_TEST_HISTORY)
    stamps, counts, mask, floors = chip_smoke.long_data(np)
    np.testing.assert_array_equal(stamps, dates.values.astype("datetime64[h]"))
    np.testing.assert_array_equal(mask, observed.astype(np.float32))
    np.testing.assert_array_equal(counts, (demand * observed).astype(np.float32))
    assert floors.shape == (chip_smoke.LONG_SERIES,)
