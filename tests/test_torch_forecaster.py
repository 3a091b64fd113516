"""The port's serving path against the JAX package's.

``Forecaster.forecast`` of the port (numpy history plus ``datetime64``
dates) against the JAX ``Forecaster`` built through its ``__init__`` with
the same parameters (a pandas frame with a daily or an hourly index, each
stepped by its model's ``freq``), in direct and in recursive mode; the
forecast calendar without pandas (its step inferred from evenly spaced
stamps, and refused where it has no fixed width); the numpy calendar
features against the pandas ones; and the device rule: with no card, an
entry point left at its default raises.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pd = pytest.importorskip("pandas")

from port_helpers import perturb, unflat_params  # noqa: E402

from flow_timesnet_tpu.data import time_features as jtf  # noqa: E402
from flow_timesnet_tpu.engine import Engine as JEngine  # noqa: E402
from flow_timesnet_tpu.forecaster import Forecaster as JForecaster  # noqa: E402
from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu_torch import convert, forecaster  # noqa: E402
from flow_timesnet_tpu_torch.data import time_features  # noqa: E402
from flow_timesnet_tpu_torch.models import timesnet  # noqa: E402

N, L, H = 5, 28, 7
TF_CFG = {"features": ["day_of_week", "day_of_month", "month", "day_of_year"],
          "encoding": "cyclical", "normalize": True}
# case -> (calendar features, first stamp, step, freq); two cyclical columns a feature
CALENDARS = {
    "daily": (TF_CFG, np.datetime64("2023-12-20"), np.timedelta64(1, "D"), "D"),
    "hourly": (dict(TF_CFG, features=["day_of_week", "hour"]), np.datetime64("2023-12-31T02:00"),
               np.timedelta64(1, "h"), "h"),
}
MODEL_KW = dict(
    input_len=L, pred_len=H, d_model=16, d_ff=32, n_layers=1, k_periods=2,
    kernel_set=((3, 3), (7, 7)), bottleneck_ratio=4.0, min_period_threshold=7,
    id_embed_dim=4, static_dim=3, static_proj_dim=4, use_zero_mean_context=True,
    context_rank=2, context_scale=0.05, time_features=8, id_vocab=N, dropout=0.0,
)


def _series(seed, T=40, calendar="daily"):
    rng = np.random.default_rng(seed)
    ids = [f"store{i}_item" for i in range(N)]
    t = np.arange(T)[:, None]
    level = rng.uniform(5, 30, size=(1, N))
    hist = level * (1 + 0.4 * np.sin(2 * np.pi * t / 7 + rng.uniform(0, 6, (1, N))))
    hist = np.round(hist + rng.normal(0, 1.5, (T, N))).clip(0).astype(np.float32)
    _, start, step, _ = CALENDARS[calendar]
    dates = start + step * np.arange(T)  # crosses a year end (daily) or midnights (hourly)
    scaler = {sid: (float(hist[:, j].mean()), float(hist[:, j].std() + 0.5))
              for j, sid in enumerate(ids)}
    static = rng.standard_normal((N, 3)).astype(np.float32)
    sigma = rng.uniform(0.01, 0.05, N).astype(np.float32)
    return ids, hist, dates, scaler, static, sigma


def _both(mode="direct", calendar="daily"):
    tf_cfg, _, _, freq = CALENDARS[calendar]
    n_marks = 2 * len(tf_cfg["features"])
    kw = dict(MODEL_KW, mode=mode, time_features=n_marks)
    cfg = timesnet.TimesNetConfig(**kw)
    init = convert.init_params(cfg, torch.Generator().manual_seed(3))
    tree = perturb(unflat_params({k: v.numpy() for k, v in init.items()}), seed=4)
    ids, hist, dates, scaler, static, sigma = _series(5, calendar=calendar)
    port = forecaster.Forecaster(
        convert.params_from_jax(tree, cfg), cfg, ids, scaler, "zscore", static, sigma,
        tf_cfg, freq=freq, device="cpu",
    )
    jax_fc = JForecaster(
        JEngine(jtn.TimesNetConfig(**kw), num_series=N), tree, ids=ids, scaler=scaler,
        method="zscore", static_features=static, sigma_vector=sigma,
        time_feature_config=dict(tf_cfg, enabled=True), time_feature_dim=n_marks, freq=freq,
    )
    frame = pd.DataFrame(hist, index=pd.DatetimeIndex(dates), columns=ids)
    return port, jax_fc, frame, hist, dates, ids


@pytest.mark.parametrize("calendar", list(CALENDARS))
def test_forecast_matches_jax_forecaster(calendar):
    port, jax_fc, frame, hist, dates, ids = _both(calendar=calendar)
    want, want_disp = jax_fc.forecast(frame, return_dispersion=True)
    got, got_disp = port.forecast(hist, dates=dates, return_dispersion=True)
    assert got.shape == (H, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want.to_numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got_disp, want_disp, rtol=1e-4, atol=1e-4)
    assert np.all(got >= 0) and np.all(np.isfinite(got))

    # a subset of the series, in another order, over a shorter horizon
    cols = [ids[3], ids[0]]
    want = jax_fc.forecast(frame[cols], horizon=4).to_numpy()
    got = port.forecast(hist[:, [3, 0]], series=cols, horizon=4, dates=dates)
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_recursive_rollout_matches_jax_forecaster():
    port, jax_fc, frame, hist, dates, _ = _both(mode="recursive")
    want = jax_fc.forecast(frame, horizon=10).to_numpy()
    got = port.forecast(hist, horizon=10, dates=dates)
    assert got.shape == (10, N)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_calendar_step_is_inferred_from_evenly_spaced_stamps():
    """With no freq the port steps by the history's own spacing, as the JAX
    package does through ``pd.infer_freq``; the marks equal those of the
    model's freq."""

    port, jax_fc, frame, hist, dates, _ = _both(calendar="hourly")
    want = jax_fc.forecast(frame).to_numpy()
    port.freq = None
    np.testing.assert_allclose(port.forecast(hist, dates=dates), want, rtol=1e-4, atol=1e-3)
    for step, n in ((np.timedelta64(15, "m"), 6), (np.timedelta64(2, "D"), 3),
                    (np.timedelta64(7, "D"), 4)):
        stamps = (np.datetime64("2024-02-27T23:45") + step * np.arange(5)).astype("datetime64[s]")
        got = forecaster.future_stamps(None, stamps, n)
        want = pd.date_range(pd.Timestamp(stamps[-1]) + pd.tseries.frequencies.to_offset(
            pd.infer_freq(pd.DatetimeIndex(stamps))), periods=n,
            freq=pd.infer_freq(pd.DatetimeIndex(stamps)))
        np.testing.assert_array_equal(got, want.to_numpy().astype("datetime64[s]"))


@pytest.mark.parametrize("freq", ["D", "3D", "h", "6h", "15min", "15T", "30s", "W", "W-SUN",
                                  "W-WED", "2W-MON"])
@pytest.mark.parametrize("last", ["2024-01-03T05:00", "2024-01-07T00:00", "2024-02-28T23:30"])
def test_calendar_steps_as_pandas_date_range(freq, last):
    """Every fixed-width alias, weekly anchors rolled forward as pandas'."""

    stamps = np.datetime64(last, "s") - np.timedelta64(1, "D") * np.arange(3)[::-1]
    got = forecaster.future_stamps(freq, stamps, 5)
    pd_freq = {"15T": "15min", "30s": "30s"}.get(freq, freq)  # pandas 3 drops the T alias
    want = pd.date_range(pd.Timestamp(last) + pd.tseries.frequencies.to_offset(pd_freq),
                         periods=5, freq=pd_freq)
    np.testing.assert_array_equal(got, want.to_numpy().astype("datetime64[s]"))


def test_calendar_raises_where_it_has_no_fixed_step():
    """An alias with no fixed width, or uneven stamps with no freq: the port
    raises where the JAX package drops the calendar marks."""

    port, _, _, hist, dates, _ = _both(calendar="hourly")
    for freq in ("MS", "M", "B", "QS", "0D"):
        port.freq = freq
        with pytest.raises(ValueError, match="no fixed step"):
            port.forecast(hist, dates=dates)
    port.freq = None
    uneven = dates.copy()
    uneven[-1] += np.timedelta64(30, "m")
    with pytest.raises(ValueError, match="not evenly spaced"):
        port.forecast(hist, dates=uneven)


def test_forecast_rejects_bad_requests():
    port, _, _, hist, dates, ids = _both()
    with pytest.raises(ValueError, match="pred_len"):
        port.forecast(hist, horizon=H + 1, dates=dates)
    with pytest.raises(KeyError, match="Unknown"):
        port.forecast(hist[:, :1], series=["nope"], dates=dates)
    with pytest.raises(ValueError, match="dates"):
        port.forecast(hist)
    with pytest.raises(ValueError, match="input_len"):
        port.forecast(hist[-L + 1:], dates=dates[-L + 1:])


def test_new_series_ids_get_a_zero_embedding_row():
    cfg = timesnet.TimesNetConfig(**MODEL_KW)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    grown, vocab = forecaster._expand_embedding(params, N + 3)
    assert vocab == N + 3 and grown["series_embedding.embedding"].shape == (N + 3, 4)
    assert torch.equal(grown["series_embedding.embedding"][:N],
                       params["series_embedding.embedding"])
    assert float(grown["series_embedding.embedding"][N:].abs().sum()) == 0.0
    assert forecaster._expand_embedding(params, N - 1) == (params, N)
    no_ids = convert.init_params(dataclasses.replace(cfg, id_embed_dim=0), torch.Generator())
    assert forecaster._expand_embedding(no_ids, N + 3) == (no_ids, None)


@pytest.mark.parametrize("encoding", ["cyclical", "onehot", "numeric",
                                      {"default": "numeric", "month": "onehot"}])
@pytest.mark.parametrize("normalize", [True, False])
def test_time_features_match_pandas(encoding, normalize):
    features = ["day_of_week", "day_of_month", "month", "day_of_year", "week_of_year"]
    cfg = {"enabled": True, "features": features, "encoding": encoding, "normalize": normalize}
    # daily dates over two leap days and several ISO-week year boundaries
    days = np.datetime64("2019-12-25") + np.arange(0, 1900, 3)
    got = time_features.build_time_features(days, cfg)
    want = jtf.build_time_features(pd.DatetimeIndex(days), cfg)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)

    stamps = np.datetime64("2024-02-28T21:00") + np.arange(0, 6000, 37).astype("timedelta64[m]")
    cfg = dict(cfg, features=["hour", "minute", "day_of_week"])
    np.testing.assert_array_equal(time_features.build_time_features(stamps, cfg),
                                  jtf.build_time_features(pd.DatetimeIndex(stamps), cfg))


def test_time_features_disabled_or_unknown():
    days = np.datetime64("2024-01-01") + np.arange(4)
    assert time_features.build_time_features(days, None).shape == (4, 0)
    with pytest.raises(ValueError, match="Unsupported time feature"):
        time_features.build_time_features(days, {"enabled": True, "features": ["decade"]})


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = timesnet.TimesNetConfig(**MODEL_KW)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    ids, _, _, scaler, static, sigma = _series(0)
    with pytest.raises(RuntimeError, match="cuda"):
        forecaster.Forecaster(params, cfg, ids, scaler, "zscore", static, sigma, TF_CFG)
    with pytest.raises(ValueError, match="unsupported device"):
        forecaster.Forecaster(params, cfg, ids, scaler, "zscore", static, sigma, TF_CFG,
                              device="mps")
