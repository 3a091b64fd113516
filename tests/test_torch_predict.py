"""The port's ``predict_once`` (and ``Forecaster.from_artifacts``) against
the JAX package's on the same artifacts, on the CPU.

One module-scoped fixture writes a generated demand benchmark (2 stores x 3
menus, 120 training days, five 28-day TEST files and the sample template,
``tools/make_demand_benchmark.py``) and trains two tiny artifact sets with
the port's ``train_once`` (d_model 8, one layer, 3x3, float32, 2 epochs): a
direct count-space model with calendar features and a recursive zscore one.
Both packages' ``predict_once`` then read the same set, and the submissions
must have the same header, row keys and order, and values within 1e-4
relative / 1e-5 absolute: the row_key and date_menu writers, direct and
recursive decode, chunked on a frozen spec (and equal to the whole batch
within 1e-5), nb and normal quantile files, mean and median ensembles, the
static-file override and its fallback, the short-series strategies, unseen
and missing ids, the horizon's frequency fallbacks, and the same errors on
signature drift. ``tests/test_torch_evaluate.py`` reads the same sets.
"""

import copy
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pd = pytest.importorskip("pandas")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

from flow_timesnet_tpu import forecaster as jforecaster  # noqa: E402
from flow_timesnet_tpu import predict as jpredict  # noqa: E402
from flow_timesnet_tpu_torch import forecaster as pforecaster  # noqa: E402
from flow_timesnet_tpu_torch import predict as ppredict  # noqa: E402
from flow_timesnet_tpu_torch.config import load_yaml, save_yaml  # noqa: E402
from flow_timesnet_tpu_torch.train import train_once  # noqa: E402
from flow_timesnet_tpu_torch.utils import artifacts  # noqa: E402
from flow_timesnet_tpu_torch.utils.metadata import load_json, save_json  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
# a one-layer spec of the flagship's periods: 7 (bin 4) and 14 (bin 2) of L=28
SPEC = [[[7, 4, True], [14, 2, True]]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def base_config(data, art_dir, *, mode="direct", normalize="none"):
    """A tiny flagship-shaped recipe on the generated benchmark."""

    return {
        "data": {"train_csv": f"{data}/train.csv", "test_dir": f"{data}/test",
                 "sample_submission": f"{data}/sample_submission.csv", "date_col": "영업일자",
                 "id_col": "영업장명_메뉴명", "target_col": "매출수량", "encoding": "utf-8-sig",
                 "fill_missing_dates": True, "horizon": 7,
                 "time_features": {"enabled": True, "encoding": "cyclical", "normalize": True,
                                   "features": ["day_of_week", "day_of_month", "month",
                                                "day_of_year"]}},
        "preprocess": {"normalize": normalize, "clip_negative": True},
        "window": {"input_len": 28, "pred_len": 7, "short_series_strategy": "repeat"},
        "model": {"mode": mode, "d_model": 8, "d_ff": 16, "n_layers": 1, "k_periods": 2,
                  "min_period_threshold": 7, "kernel_set": [[3, 3]], "dropout": 0.0,
                  "id_embed_dim": 4, "static_proj_dim": 4, "use_zero_mean_context": True,
                  "context_rank": 2, "compute_dtype": "float32"},
        "train": {"device": "cpu", "epochs": 2, "batch_size": 32, "lr": 3e-3,
                  "lr_warmup_steps": 5, "use_loss_masking": True, "ema_decay": 0.9,
                  "freeze_periods": True, "freeze_after_epoch": 1, "data_parallel": "off",
                  "min_sigma_method": "per_series_median", "min_sigma_scale": 0.05,
                  "val": {"strategy": "holdout", "holdout_days": 42}},
        "predict": {"data_parallel": "off"},
        "artifacts": {"dir": str(art_dir)},
        "submission": {"out_path": str(art_dir / "submission.csv"), "format": "row_key"},
        "tuning": {"seed": 7},
    }


def train_artifact_sets(root):
    """The benchmark data and the two artifact sets, each with its config."""

    from make_demand_benchmark import write_benchmark

    data = root / "data"
    write_benchmark(str(data), seed=3, n_stores=2, n_menus=3, t_train=120)
    sets = {}
    for name, kw in (("direct", {}), ("recursive", {"mode": "recursive",
                                                    "normalize": "zscore"})):
        cfg = base_config(data, root / name, **kw)
        train_once(copy.deepcopy(cfg))
        sets[name] = cfg
    return data, sets


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_artifact_sets(tmp_path_factory.mktemp("predict"))


def with_changes(cfg, tmp_path, tag, **sections):
    """``cfg`` with each section updated and the outputs under ``tmp_path``."""

    out = copy.deepcopy(cfg)
    for section, values in sections.items():
        out.setdefault(section, {}).update(values)
    out["submission"] = dict(out["submission"], out_path=str(tmp_path / f"{tag}.csv"))
    return out


def run_both(cfg, tmp_path):
    """Both packages' predict on ``cfg``: (JAX path, port path)."""

    paths = {}
    for side, fn in (("jax", jpredict.predict_once), ("port", ppredict.predict_once)):
        side_cfg = copy.deepcopy(cfg)
        root, ext = os.path.splitext(side_cfg["submission"]["out_path"])
        side_cfg["submission"]["out_path"] = f"{root}.{side}{ext}"
        paths[side] = fn(side_cfg)
        assert paths[side] == side_cfg["submission"]["out_path"]
    return paths["jax"], paths["port"]


def assert_same_submission(jax_path, port_path, rtol=RTOL, atol=ATOL):
    """The same header, keys and order; values within the tolerance."""

    want = pd.read_csv(jax_path, encoding="utf-8-sig")
    got = pd.read_csv(port_path, encoding="utf-8-sig")
    with open(port_path, "rb") as f:
        assert f.read(3) == b"\xef\xbb\xbf"
    assert list(got.columns) == list(want.columns)
    assert list(got.iloc[:, 0]) == list(want.iloc[:, 0])
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(float), want.iloc[:, 1:].to_numpy(float),
                               rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("fmt", ["row_key", "date_menu"])
def test_direct_submission(trained, tmp_path, fmt):
    _, sets = trained
    cfg = with_changes(sets["direct"], tmp_path, fmt, submission={"format": fmt})
    got = assert_same_submission(*run_both(cfg, tmp_path))
    values = got.iloc[:, 1:].to_numpy(float)
    assert values.shape == (35, 6) and np.isfinite(values).all() and (values >= 0).all()
    sample = pd.read_csv(cfg["data"]["sample_submission"], encoding="utf-8-sig")
    if fmt == "row_key":  # the sample's header and rows
        assert list(got.columns) == list(sample.columns)
        assert list(got.iloc[:, 0]) == list(sample.iloc[:, 0])
    else:  # the forecast dates, after each file's last day
        assert list(got.columns) == ["date", *sample.columns[1:]]
        test0 = pd.read_csv(os.path.join(cfg["data"]["test_dir"], "TEST_00.csv"),
                            encoding="utf-8-sig")
        first = pd.Timestamp(test0["영업일자"].max()) + pd.Timedelta(days=1)
        assert got.iloc[0, 0] == first.strftime("%Y-%m-%d")


def test_recursive_decode_covers_the_horizon(trained, tmp_path):
    _, sets = trained
    cfg = with_changes(sets["recursive"], tmp_path, "recursive", data={"horizon": 9},
                       submission={"format": "date_menu"})
    got = assert_same_submission(*run_both(cfg, tmp_path))
    assert len(got) == 5 * 9 and (got.iloc[:, 1:].to_numpy(float) >= 0).all()


def test_chunked_on_a_frozen_spec_equals_the_whole_batch(trained, tmp_path):
    """4-row chunks (the second padded by repeats and masked by row_valid)
    on a frozen spec: equal to JAX's, and to the whole batch within 1e-5."""

    _, sets = trained
    frozen = {"frozen_periods_spec": SPEC}
    chunked = with_changes(sets["direct"], tmp_path, "chunked", train=frozen,
                           predict={"chunk_rows": 4, "freeze_periods": "on"})
    jax_path, port_path = run_both(chunked, tmp_path)
    got = assert_same_submission(jax_path, port_path)
    whole = with_changes(sets["direct"], tmp_path, "whole", train=frozen,
                         predict={"chunk_rows": "off", "freeze_periods": "on"})
    whole_path = ppredict.predict_once(whole)
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(float),
                               pd.read_csv(whole_path).iloc[:, 1:].to_numpy(float),
                               rtol=1e-5, atol=1e-5)
    # with no stored spec, "on" raises in both packages
    with_none = with_changes(sets["direct"], tmp_path, "none", predict={"freeze_periods": "on"})
    with_none["train"].pop("frozen_periods_spec", None)
    stored = load_yaml(os.path.join(sets["direct"]["artifacts"]["dir"], "config_used.yaml"))
    if not stored["train"].get("frozen_periods_spec"):
        for fn in (jpredict.predict_once, ppredict.predict_once):
            with pytest.raises(ValueError, match="carries no train.frozen_periods_spec"):
                fn(copy.deepcopy(with_none))


@pytest.mark.parametrize("which,method", [("direct", "nb"), ("recursive", "normal")])
def test_quantile_submissions(trained, tmp_path, which, method):
    _, sets = trained
    levels = [0.1, 0.5, 0.9]
    cfg = with_changes(sets[which], tmp_path, f"q_{which}", predict={"quantiles": levels})
    jax_path, port_path = run_both(cfg, tmp_path)
    assert_same_submission(jax_path, port_path)
    stacked = []
    for q in levels:
        jq, pq = (ppredict.quantile_out_path(p, q) for p in (jax_path, port_path))
        stacked.append(assert_same_submission(jq, pq).iloc[:, 1:].to_numpy(float))
    assert (np.diff(np.stack(stacked), axis=0) >= 0).all()
    assert ppredict.parse_quantile_config({"quantiles": levels},
                                          cfg["preprocess"]["normalize"])[1] == method


@pytest.fixture(scope="module")
def second_member(trained, tmp_path_factory):
    """A copy of the direct set with perturbed weights: an ensemble member."""

    _, sets = trained
    dst = tmp_path_factory.mktemp("member") / "direct2"
    shutil.copytree(sets["direct"]["artifacts"]["dir"], dst)
    tree, aux = artifacts.load_checkpoint(str(dst / "timesnet.msgpack"))
    rng = np.random.default_rng(11)

    def perturb(node):
        if isinstance(node, dict):
            return {k: perturb(v) for k, v in node.items()}
        return (node + 0.05 * rng.standard_normal(node.shape)).astype(np.float32)

    artifacts.save_checkpoint(str(dst / "timesnet.msgpack"), perturb(tree), aux)
    return str(dst)


@pytest.mark.parametrize("reduce", ["mean", "median"])
def test_ensemble(trained, second_member, tmp_path, reduce):
    _, sets = trained
    levels = [0.25, 0.75]
    cfg = with_changes(sets["direct"], tmp_path, f"ens_{reduce}",
                       predict={"ensemble_dirs": [second_member], "ensemble_reduce": reduce,
                                "quantiles": levels})
    jax_path, port_path = run_both(cfg, tmp_path)
    got = assert_same_submission(jax_path, port_path)
    members = [pd.read_csv(f"{port_path}.member{i}.csv").iloc[:, 1:].to_numpy(float)
               for i in range(2)]
    assert not np.allclose(members[0], members[1])
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(float), np.mean(members, axis=0),
                               rtol=1e-12)  # the median of two is their mean
    for q in levels:
        assert_same_submission(*(ppredict.quantile_out_path(p, q) for p in (jax_path, port_path)))


def test_static_file_override_and_fallback(trained, tmp_path):
    """``artifacts.static_file`` with a permuted id order re-aligns to the
    scaler's statics (so it equals the default path); a missing file falls
    back to them."""

    _, sets = trained
    art = sets["direct"]["artifacts"]["dir"]
    with open(os.path.join(art, "scaler.pkl"), "rb") as f:
        meta = pickle.load(f)
    override = {"static_features": np.asarray(meta["static_features"])[::-1].copy(),
                "ids": list(meta["ids"])[::-1]}
    with open(tmp_path / "statics.pkl", "wb") as f:
        pickle.dump(override, f)
    default = ppredict.predict_once(with_changes(sets["direct"], tmp_path, "default"))
    for tag, static_file in (("override", str(tmp_path / "statics.pkl")),
                             ("missing", str(tmp_path / "nope.pkl"))):
        cfg = with_changes(sets["direct"], tmp_path, tag,
                           artifacts={"static_file": static_file})
        jax_path, port_path = run_both(cfg, tmp_path)
        assert_same_submission(jax_path, port_path)
        assert_same_submission(default, port_path, rtol=1e-6, atol=1e-6)


def with_window(cfg, tmp_path, **window):
    """A copy of ``cfg``'s artifact set whose stored window (metadata and
    config) takes ``window``, and ``cfg`` pointed at it."""

    dst = tmp_path / "variant"
    shutil.copytree(cfg["artifacts"]["dir"], dst)
    meta = load_json(str(dst / "metadata.json"))
    meta["window"].update(window)
    save_json(meta, str(dst / "metadata.json"))
    used = load_yaml(str(dst / "config_used.yaml"))
    used["window"].update(window)
    save_yaml(used, str(dst / "config_used.yaml"))
    return with_changes(cfg, tmp_path, "variant", window=window, artifacts={"dir": str(dst)})


def write_test_dir(data, dst, edit):
    """Copies of the TEST files, each passed through ``edit(frame, i)``."""

    os.makedirs(dst)
    for i in range(5):
        name = f"TEST_{i:02d}.csv"
        frame = pd.read_csv(os.path.join(data, "test", name), encoding="utf-8-sig")
        edit(frame, i).to_csv(os.path.join(dst, name), index=False, encoding="utf-8-sig")
    return str(dst)


@pytest.mark.parametrize("strategy", ["repeat", "pad", "error"])
def test_short_series_strategies(trained, tmp_path, strategy):
    data, sets = trained

    def shorten(frame, i):  # TEST_01 keeps its last 20 of 28 days
        if i != 1:
            return frame
        days = sorted(frame["영업일자"].unique())
        return frame[frame["영업일자"].isin(days[-20:])]

    cfg = with_window(sets["direct"], tmp_path, short_series_strategy=strategy, pad_value=0.5)
    cfg["data"]["test_dir"] = write_test_dir(data, tmp_path / "short", shorten)
    if strategy == "error":
        for fn in (jpredict.predict_once, ppredict.predict_once):
            with pytest.raises(ValueError, match="shorter than required input_len=28"):
                fn(copy.deepcopy(cfg))
        return
    got = assert_same_submission(*run_both(cfg, tmp_path))
    assert np.isfinite(got.iloc[:, 1:].to_numpy(float)).all()


def test_unseen_and_missing_ids(trained, tmp_path):
    """TEST_00 gains a series unseen in training and loses a trained one;
    with no sample template the new id becomes a default-filled column."""

    data, sets = trained

    def edit(frame, i):
        if i != 0:
            return frame
        ids = sorted(frame["영업장명_메뉴명"].unique())
        out = frame[frame["영업장명_메뉴명"] != ids[0]].copy()
        extra = out[out["영업장명_메뉴명"] == ids[1]].copy()
        extra["영업장명_메뉴명"] = "매장Z_메뉴99"
        return pd.concat([out, extra], ignore_index=True)

    cfg = with_changes(sets["direct"], tmp_path, "ids",
                       data={"test_dir": write_test_dir(data, tmp_path / "ids", edit),
                             "sample_submission": ""},
                       submission={"default_fill_value": 2.5})
    got = assert_same_submission(*run_both(cfg, tmp_path))
    assert got.columns[-1] == "매장Z_메뉴99" and (got["매장Z_메뉴99"] == 2.5).all()


@pytest.mark.parametrize("freq", ["2D", "bogus"])
def test_horizon_frequency(trained, tmp_path, freq):
    """``data.horizon_freq``: a fixed alias steps the dates; one that is no
    alias falls back to daily steps in both packages."""

    _, sets = trained
    cfg = with_changes(sets["direct"], tmp_path, f"freq_{freq}", data={"horizon_freq": freq},
                       submission={"format": "date_menu"})
    got = assert_same_submission(*run_both(cfg, tmp_path))
    dates = pd.to_datetime(got.iloc[:7, 0])
    assert (dates.diff().dropna() == pd.Timedelta(days=2 if freq == "2D" else 1)).all()


def test_calendar_horizon_alias_raises_naming_it(trained, tmp_path):
    """An alias with no fixed step (pandas steps month starts): the port
    raises, naming it (a deliberate difference)."""

    _, sets = trained
    cfg = with_changes(sets["direct"], tmp_path, "ms", data={"horizon_freq": "MS"})
    with pytest.raises(ValueError, match="'MS'.*no fixed step"):
        ppredict.predict_once(cfg)


@pytest.mark.parametrize("section,key,value,match", [
    ("model", "d_model", 16, "model.d_model=16 differs from checkpoint value 8"),
    ("model", "mode", "recursive", "model.mode=recursive differs"),
    ("window", "input_len", 21, "window.input_len=21 differs from metadata value 28"),
    ("preprocess", "normalize", "zscore", "normalize configured='zscore' stored='none'"),
])
def test_signature_drift_raises_as_jax(trained, tmp_path, section, key, value, match):
    _, sets = trained
    cfg = with_changes(sets["direct"], tmp_path, "drift", **{section: {key: value}})
    for fn in (jpredict.predict_once, ppredict.predict_once):
        with pytest.raises(ValueError, match=match):
            fn(copy.deepcopy(cfg))


@pytest.mark.parametrize("which", ["direct", "recursive"])
def test_from_artifacts_forecasts_as_jax(trained, which):
    """``Forecaster.from_artifacts`` on the same set, one TEST window:
    ``forecast`` and ``forecast_quantiles`` within the tolerance."""

    data, sets = trained
    art = sets[which]["artifacts"]["dir"]
    jfc = jforecaster.Forecaster.from_artifacts(art)
    pfc = pforecaster.Forecaster.from_artifacts(art, device="cpu")
    assert pfc.ids == jfc.ids and pfc.freq == jfc.freq == "D"
    assert pfc.engine.cfg.frozen_periods is None  # predict.freeze_periods defaults to off
    frame = pd.read_csv(os.path.join(data, "test", "TEST_02.csv"), encoding="utf-8-sig")
    wide = frame.pivot(index="영업일자", columns="영업장명_메뉴명", values="매출수량").fillna(0.0)
    wide.index = pd.DatetimeIndex(wide.index)
    wide = wide[jfc.ids].astype(np.float32)
    stamps = wide.index.values.astype("datetime64[s]")
    np.testing.assert_allclose(pfc.forecast(wide.to_numpy(), dates=stamps),
                               jfc.forecast(wide).to_numpy(), rtol=RTOL, atol=ATOL)
    levels = (0.1, 0.5, 0.9)
    got = pfc.forecast_quantiles(wide.to_numpy(), levels, dates=stamps)
    want = jfc.forecast_quantiles(wide, levels)
    for q in levels:
        np.testing.assert_allclose(got[q], want[q].to_numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("raw", [None, "auto", "off", "null", 0, -3, 64, "64", 500, 4096, False])
@pytest.mark.parametrize("num_series,mesh", [(100, 1), (10_000, 1), (10_000, 8), (300, 1)])
def test_resolve_chunk_rows_as_jax(raw, num_series, mesh):
    cfg = {} if raw is None else {"chunk_rows": raw}
    assert (ppredict._resolve_chunk_rows(cfg, num_series, mesh)
            == jpredict._resolve_chunk_rows(cfg, num_series, mesh))


def test_resolve_test_paths_as_jax(tmp_path):
    d = tmp_path / "t"
    os.makedirs(d / "sub")
    for name in ("TEST_00.csv", "TEST_01.csv", "other.csv", "sub/TEST_02.csv"):
        (d / name).write_text("x")
    for data_cfg in (
        {"test_dir": str(d)}, {"test_dir": str(d), "test_pattern": "*.csv"},
        {"test_glob": str(d / "TEST_0*.csv")}, {"test_glob": [str(d / "*.csv"), str(d / "sub")]},
        {"test_files": [str(d / "TEST_01.csv"), str(d / "TEST_00.csv"), str(d / "TEST_01.csv")]},
        {"test_path": str(d)}, {"test_path": str(d / "missing.csv")}, {},
    ):
        assert ppredict._resolve_test_paths(data_cfg) == jpredict._resolve_test_paths(data_cfg)
