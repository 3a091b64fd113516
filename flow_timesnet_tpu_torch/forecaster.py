"""Serving API: a resident model that forecasts in-memory history windows
(counterpart of ``flow_timesnet_tpu/forecaster.py``).

:meth:`Forecaster.from_artifacts` loads and validates the artifact set that
either package's ``train_once`` writes (``config_used.yaml``,
``metadata.json``, ``scaler.pkl``, ``schema.json`` and the flax msgpack
checkpoint, carried into the port's layout by ``convert.py``); a
``Forecaster`` may also be built from parameters and arrays held in memory.
History is a ``[T, n]`` numpy array; calendar features come from optional
``datetime64`` stamps aligned with its rows, stepped into the future by the
model's frequency. ``forecast`` gives the rates, ``forecast_quantiles`` the
NB2 head's predictive quantiles.

With tracing on (``tracing.py``) each call is the span ``forecast``, with
``forecast.prepare`` (validation, scaling, calendar marks, the static, id
and floor lookups), ``forecast.upload`` (the host-to-device copies),
``Engine``'s ``engine.replay``, ``forecast.fetch`` (the copies back, which
wait for the card) and ``forecast.finish`` (the inverse transform and the
clip) inside it.
"""

from __future__ import annotations

import os
import re
from dataclasses import replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import convert, tracing
from .config import PipelineConfig, load_yaml
from .data.pivot import ScalerDict, inverse_transform, transform_array
from .data.time_features import build_time_features
from .engine import Engine
from .models.timesnet import TimesNetConfig
from .utils import artifacts as artifacts_io
from .utils import metadata as metadata_utils
from .utils.quantiles import predictive_quantiles, resolve_method

# pandas' fixed-width aliases of the grids data/pivot.py keeps -> numpy units
_FIXED_UNITS = {"D": "D", "h": "h", "H": "h", "min": "m", "T": "m", "s": "s", "S": "s"}
_WEEKDAYS = ("MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN")


def future_stamps(freq: Optional[str], stamps: np.ndarray, horizon: int) -> np.ndarray:
    """The ``horizon`` stamps after ``stamps[-1]``, as ``pd.date_range(last +
    to_offset(freq), periods=horizon, freq=freq)`` gives them, without pandas.

    ``freq`` is a pandas alias with a fixed step: an optional multiple, then
    ``D``, ``h``/``H``, ``min``/``T``, ``s``/``S``, or ``W``/``W-<DAY>``
    (weeks anchored on a weekday, ``W`` on Sunday: the first future stamp
    rolls forward to that weekday, as pandas' does). With no ``freq`` the
    step is inferred from ``stamps`` when they are evenly spaced, as
    ``pd.infer_freq`` does. Raises ``ValueError`` on an alias with no fixed
    step (``MS``, ``M``, ``B``, ...) and on uneven stamps with no ``freq``,
    where the JAX package drops the calendar marks without a word.
    ``stamps`` are ``datetime64[s]``; so is the result.
    """

    last = stamps[-1]
    if freq is None:
        steps = np.diff(stamps)
        if len(stamps) < 3 or not (steps > np.timedelta64(0, "s")).all() or (steps != steps[0]).any():
            raise ValueError("the history's stamps are not evenly spaced and the model has no "
                             "freq: pass the freq it was trained with")
        return last + steps[0] * np.arange(1, horizon + 1)
    m = re.fullmatch(r"(\d*)(D|h|H|min|T|s|S|W(?:-(MON|TUE|WED|THU|FRI|SAT|SUN))?)", freq.strip())
    if m is None or (m.group(1) and int(m.group(1)) == 0):
        raise ValueError(f"freq {freq!r} has no fixed step: the port takes an optional multiple "
                         "and D, h, min, s or W[-<DAY>]")
    n = int(m.group(1) or 1)
    unit = m.group(2)
    if not unit.startswith("W"):
        return last + np.timedelta64(n, _FIXED_UNITS[unit]).astype("m8[s]") * np.arange(1, horizon + 1)
    # pandas' Week(weekday): a stamp off the anchor rolls forward to it, then n - 1 more weeks
    anchor = _WEEKDAYS.index(m.group(3) or "SUN")
    weekday = (last.astype("datetime64[D]").astype(np.int64) + 3) % 7  # 1970-01-01: Thursday
    roll = (anchor - weekday) % 7 or 7
    week = np.timedelta64(7, "D").astype("m8[s]")
    first = last + np.timedelta64(int(roll), "D").astype("m8[s]") + (n - 1) * week
    return first + n * week * np.arange(horizon)


def _expand_embedding(
    params: Dict[str, torch.Tensor], required_vocab: int
) -> Tuple[Dict[str, torch.Tensor], Optional[int]]:
    """Zero-expand the series embedding for ids beyond the trained vocab.

    Returns the (possibly new) params and the resulting vocab, or ``None``
    when the model has no series embedding.
    """

    emb = params.get("series_embedding.embedding")
    if emb is None:
        return params, None
    vocab, dim = emb.shape
    if required_vocab <= vocab:
        return params, int(vocab)
    grown = torch.zeros((required_vocab, dim), dtype=emb.dtype)
    grown[:vocab] = emb
    return {**params, "series_embedding.embedding": grown}, int(required_vocab)


def checkpoint_floors(aux: Mapping[str, Any], train_cfg: Mapping[str, Any]):
    """``(sigma_vector [N] or None, min_sigma scalar)`` of a checkpoint's aux."""

    sigma_vector = aux.get("min_sigma_vector")
    if sigma_vector is not None:
        sigma_vector = np.asarray(sigma_vector, np.float32).reshape(-1)
    min_sigma = float(aux.get("min_sigma_effective", train_cfg.get("min_sigma_effective", 1e-3)))
    return sigma_vector, min_sigma


def checkpoint_vocab(tree: Mapping[str, Any], num_ids: int) -> int:
    """Rows of a checkpoint's series embedding (``num_ids`` where it has
    none): the vocab its parameters convert at, before any growth."""

    emb = (tree.get("series_embedding") or {}).get("embedding")
    return num_ids if emb is None else int(np.shape(emb)[0])


def serving_model_config(
    cfg: PipelineConfig,
    model_raw: Mapping[str, Any],
    *,
    min_sigma: float,
    static_dim: int,
    time_features: int,
    id_vocab: int,
) -> TimesNetConfig:
    """The model of a trained artifact set as serving builds it: the merged
    config's ``model`` section (``model_raw``) over ``cfg``'s window and
    normalised kernel set, with the data dimensions of the artifacts."""

    return TimesNetConfig(
        input_len=cfg.window.input_len,
        pred_len=cfg.window.pred_len,
        d_model=int(model_raw["d_model"]),
        d_ff=int(model_raw.get("d_ff", 4 * int(model_raw["d_model"]))),
        n_layers=int(model_raw["n_layers"]),
        k_periods=int(model_raw["k_periods"]),
        kernel_set=tuple(tuple(k) for k in cfg.model.kernel_set),
        dropout=float(model_raw["dropout"]),
        activation=str(model_raw["activation"]),
        mode=str(model_raw["mode"]),
        bottleneck_ratio=float(model_raw.get("bottleneck_ratio", 1.0)),
        min_period_threshold=int(model_raw.get("min_period_threshold", 1)),
        use_checkpoint=False,
        use_embedding_norm=bool(model_raw.get("use_embedding_norm", True)),
        embed_norm_mode=model_raw.get("embed_norm_mode"),
        min_sigma=float(min_sigma),
        id_embed_dim=int(model_raw.get("id_embed_dim", 32)),
        static_proj_dim=cfg.model.static_proj_dim,
        static_layernorm=bool(model_raw.get("static_layernorm", True)),
        use_zero_mean_context=bool(model_raw.get("use_zero_mean_context", False)),
        context_rank=max(0, int(model_raw.get("context_rank", 0))),
        context_scale=float(model_raw.get("context_scale", 1e-2)),
        use_constant_context_bias=bool(model_raw.get("use_constant_context_bias", False)),
        use_late_bias_head=bool(model_raw.get("use_late_bias_head", True)),
        c_in=1,
        static_dim=int(static_dim),
        time_features=int(time_features),
        id_vocab=int(id_vocab),
        period_max_unique=model_raw.get("period_max_unique"),
        period_binning=model_raw.get("period_binning"),
        compute_dtype=str(model_raw.get("compute_dtype", "float32")),
        period_buckets=model_raw.get("period_buckets"),
        period_cap=(int(model_raw["period_cap"]) if model_raw.get("period_cap") is not None
                    else None),
    )


def freeze_for_serving(
    tn_cfg: TimesNetConfig, raw_mode: Any, stored_spec: Any,
    log: Callable[[str], None] = lambda msg: None,
) -> TimesNetConfig:
    """The serving side of period specialization (``predict.freeze_periods``:
    off|auto|on). ``auto`` and ``on`` pin the spec the training run stored
    (``train.frozen_periods_spec``): the fold then runs the dense
    exact-extent conv on those periods in place of re-selecting them from
    each window. ``auto`` keeps the dynamic path where no usable spec is
    stored; ``on`` raises there."""

    mode = Engine.parse_freeze_mode(raw_mode)
    if mode == "off":
        return tn_cfg
    try:
        spec = Engine.frozen_spec_from_config(stored_spec, tn_cfg.n_layers)
    except ValueError as err:
        if mode == "on":
            raise
        log(f"predict.freeze_periods=auto: stored spec unusable ({err}); using the dynamic path.")
        spec = None
    if spec is None:
        if mode == "on":
            raise ValueError(
                "predict.freeze_periods=on but the checkpoint's config_used.yaml carries no "
                "train.frozen_periods_spec (the training run never froze); retrain with "
                "train.freeze_periods=on or use auto/off")
        return tn_cfg
    periods = sorted({p for layer in spec for p, _, v in layer if v})
    log(f"freeze_periods: inference specialized to stored periods {periods}")
    return replace(tn_cfg, frozen_periods=spec)


class Forecaster:
    """Resident forecaster bound to one parameter set.

    Args:
        params: the port's ``state_dict`` (``convert.params_from_jax`` or
            ``convert.init_params``).
        cfg: the model configuration.
        ids: the trained series ids, in embedding order.
        scaler, method: the per-series scaler (see ``data/pivot.py``).
        static_features: [len(ids), static_dim] or None.
        sigma_vector: per-series dispersion floors [len(ids)] or None.
        time_feature_config: the calendar-feature config the model was
            trained with, or None when it takes no calendar features.
        freq: the pandas alias of the model's time grid (the artifact's
            time-feature ``freq``), which steps the forecast calendar; None
            infers it from evenly spaced history stamps (see
            :func:`future_stamps`).
        device: ``"cuda"`` (the default, which raises when no card is
            present) or ``"cpu"``.
    """

    def __init__(
        self,
        params: Mapping[str, torch.Tensor],
        cfg: TimesNetConfig,
        ids: Sequence[str],
        scaler: Optional[ScalerDict],
        method: str,
        static_features: Optional[np.ndarray] = None,
        sigma_vector: Optional[np.ndarray] = None,
        time_feature_config: Optional[Mapping[str, Any]] = None,
        freq: Optional[str] = None,
        device="cuda",
    ) -> None:
        self.ids: List[str] = list(ids)
        params, vocab = _expand_embedding(dict(params), len(self.ids))
        if vocab is not None:
            cfg = replace(cfg, id_vocab=vocab)
        self.engine = Engine(cfg, params, device, num_series=len(self.ids))
        self.device = self.engine.device
        self.id_position = {sid: i for i, sid in enumerate(self.ids)}
        self.scaler = scaler
        self.method = method
        self.static_features = (
            None if static_features is None else np.asarray(static_features, np.float32)
        )
        self.sigma_vector = (
            None if sigma_vector is None else np.asarray(sigma_vector, np.float32).reshape(-1)
        )
        self.time_feature_config = (
            None if time_feature_config is None else dict(time_feature_config)
        )
        self.freq = freq

    @classmethod
    def from_artifacts(cls, art_dir: str, config_path: Optional[str] = None,
                       device="cuda") -> "Forecaster":
        """Load and validate the ``train_once`` artifact set in ``art_dir``.

        The model is the stored config's, on the periods that
        ``predict.freeze_periods`` (default off) pins: see
        :func:`freeze_for_serving`.
        """

        cfg = PipelineConfig.from_mapping(
            load_yaml(config_path or os.path.join(art_dir, "config_used.yaml")))
        cfg_used = cfg.to_dict()
        artifacts = cfg_used.get("artifacts", {})

        metadata = metadata_utils.load_metadata_artifact(
            os.path.join(art_dir, artifacts.get("metadata_file", "metadata.json")))
        metadata.validate_config(cfg)
        scaler_meta = artifacts_io.load_pickle(
            os.path.join(art_dir, artifacts.get("scaler_file", "scaler.pkl")))
        schema_obj, _ = artifacts_io.load_schema_artifact(
            os.path.join(art_dir, artifacts.get("schema_file", "schema.json")))
        ids = list(scaler_meta["ids"])
        metadata.validate_artifacts(schema=schema_obj, scaler_meta=scaler_meta,
                                    num_series=len(ids))

        tree, aux = artifacts_io.load_checkpoint(
            os.path.join(art_dir, artifacts.get("model_file", "timesnet.msgpack")))
        sigma_vector, min_sigma = checkpoint_floors(aux, cfg_used.get("train", {}))

        tf_meta = scaler_meta.get("time_features") or {}
        tf_config = dict(tf_meta.get("config") or {})
        tf_enabled = bool(tf_meta.get("enabled", tf_config.get("enabled", False)))
        tf_dim = int(tf_meta.get("feature_dim", 0) or 0)
        tf_on = tf_enabled and tf_dim > 0
        static_arr = scaler_meta.get("static_features")
        static_np = (np.asarray(static_arr, np.float32)
                     if static_arr is not None and np.size(static_arr) else None)

        tn_cfg = serving_model_config(
            cfg, cfg_used["model"], min_sigma=min_sigma,
            static_dim=int(static_np.shape[1]) if static_np is not None else 0,
            time_features=tf_dim if tf_on else 0, id_vocab=checkpoint_vocab(tree, len(ids)))
        tn_cfg = freeze_for_serving(tn_cfg, (cfg_used.get("predict") or {}).get(
            "freeze_periods", "off"), cfg_used.get("train", {}).get("frozen_periods_spec"))
        return cls(convert.params_from_jax(tree, tn_cfg), tn_cfg, ids, scaler_meta["scaler"],
                   scaler_meta["method"], static_np, sigma_vector,
                   tf_config if tf_on else None, tf_meta.get("freq"), device=device)

    @property
    def input_len(self) -> int:
        return self.engine.cfg.input_len

    @property
    def pred_len(self) -> int:
        return self.engine.cfg.pred_len

    def forecast(
        self,
        history: np.ndarray,
        series: Optional[Sequence[str]] = None,
        horizon: Optional[int] = None,
        dates: Optional[np.ndarray] = None,
        return_dispersion: bool = False,
    ):
        """Forecast the next ``horizon`` steps for each requested series.

        Returns a ``[horizon, n]`` float32 array of forecast rates in
        original units (clipped >= 0), and the model-space dispersion too
        when ``return_dispersion``.
        """

        with tracing.span("forecast"):
            rate_np, disp_np, columns = self._forecast_raw(history, series, horizon, dates)
            with tracing.span("forecast.finish"):
                rate_out = np.clip(
                    inverse_transform(rate_np, columns, self._sub_scaler(columns), self.method),
                    0.0,
                    None,
                )
        if return_dispersion:
            return rate_out, disp_np
        return rate_out

    def forecast_quantiles(
        self,
        history: np.ndarray,
        quantiles: Sequence[float] = (0.1, 0.5, 0.9),
        series: Optional[Sequence[str]] = None,
        horizon: Optional[int] = None,
        dates: Optional[np.ndarray] = None,
        method: str = "auto",
    ) -> Dict[float, np.ndarray]:
        """NB2 predictive quantiles per step and series: ``{q: [horizon, n]}``
        float32 in original units.

        ``method``: ``"nb"`` (the exact integer NB2 inverse CDF),
        ``"normal"`` (moment-matched Gaussian) or ``"auto"`` (nb for
        unscaled count pipelines, normal otherwise). Quantiles are taken in
        model space, where the NB2 (mu, alpha) relation holds, then pushed
        through the monotone inverse scaler and clipped at zero.
        """

        with tracing.span("forecast"):
            rate_np, disp_np, columns = self._forecast_raw(history, series, horizon, dates)
            with tracing.span("forecast.finish"):
                values = predictive_quantiles(quantiles, rate_np, disp_np,
                                              resolve_method(method, self.method))
                sub = self._sub_scaler(columns)
                return {
                    q: np.clip(inverse_transform(np.asarray(arr, np.float32), columns, sub,
                                                 self.method), 0.0, None).astype(np.float32)
                    for q, arr in values.items()
                }

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _forecast_raw(
        self,
        history: np.ndarray,
        series: Optional[Sequence[str]] = None,
        horizon: Optional[int] = None,
        dates: Optional[np.ndarray] = None,
    ):
        """Model-space forward: ``(rate [H, n], dispersion [H, n], columns)``,
        before any inverse transform or clip."""

        with tracing.span("forecast.prepare"):
            host, columns, horizon = self._prepare(history, series, horizon, dates)
        with tracing.span("forecast.upload"):
            xb, x_mark, y_mark, static, ids_arr, floor = (
                None if a is None else self._tensor(a) for a in host)
        cfg = self.engine.cfg
        if cfg.mode == "direct":
            rate, disp = self.engine.forward(xb, x_mark, static, ids_arr, floor)
            rate, disp = rate[:, :horizon, :], disp[:, :horizon, :]
        else:
            rate, disp = self.engine.rollout(
                xb, horizon, x_mark=x_mark, y_mark=y_mark, static=static, ids=ids_arr,
                floor=floor,
            )
        with tracing.span("forecast.fetch"):
            rate_np = rate[:, :, 0].T.float().cpu().numpy()  # [horizon, n]
            disp_np = disp[:, :, 0].T.float().cpu().numpy()
        return rate_np, disp_np, columns

    def _prepare(self, history, series, horizon, dates):
        """The host arrays of a request, validated: ``(x, x_mark, y_mark,
        static, ids, floor)`` (None where the model takes none), the
        columns and the horizon."""

        cfg = self.engine.cfg
        horizon = int(horizon or cfg.pred_len)
        if cfg.mode == "direct" and horizon > cfg.pred_len:
            raise ValueError(
                f"direct mode forecasts at most pred_len={cfg.pred_len} steps; "
                "train a recursive model for longer rollouts"
            )
        values = np.asarray(history, np.float32)
        columns = list(series) if series is not None else list(self.ids)
        if values.ndim != 2 or values.shape[1] != len(columns):
            raise ValueError("history must be [T, n] aligned with the series list")
        unknown = [c for c in columns if c not in self.id_position]
        if unknown:
            raise KeyError(f"Unknown series ids: {unknown[:5]}")
        L = self.input_len
        if values.shape[0] < L:
            raise ValueError(f"history length {values.shape[0]} < required input_len {L}")

        n = len(columns)
        positions = np.asarray([self.id_position[c] for c in columns], np.int64)
        scaled = transform_array(values[-L:, :], columns, self._sub_scaler(columns), self.method)
        xb = scaled.T[:, :, None]  # [n, L, 1]

        x_mark = y_mark = None
        if self.time_feature_config is not None:
            if dates is None:
                raise ValueError("model was trained with time features; pass the history's dates")
            stamps = np.asarray(dates).astype("datetime64[s]")
            if stamps.shape != (values.shape[0],):
                raise ValueError("dates must hold one stamp per history row")
            future = future_stamps(self.freq, stamps, horizon)
            marks = build_time_features(
                np.concatenate([stamps[-L:], future]), {**self.time_feature_config, "enabled": True}
            )
            if marks.shape[1] != cfg.time_features:
                raise ValueError(
                    f"time_feature_config gives {marks.shape[1]} features, "
                    f"the model takes {cfg.time_features}"
                )
            x_mark = np.broadcast_to(marks[:L][None], (n, L, marks.shape[1]))
            y_mark = np.broadcast_to(marks[L:][None], (n, horizon, marks.shape[1]))

        static = (self.static_features[positions][:, None, :]
                  if self.static_features is not None else None)
        floor = (self.sigma_vector[positions].reshape(-1, 1, 1)
                 if self.sigma_vector is not None else None)
        return (xb, x_mark, y_mark, static, positions.reshape(-1, 1), floor), columns, horizon

    def _sub_scaler(self, columns: List[str]):
        if self.scaler is None or self.method == "none":
            return None
        return {c: self.scaler[c] for c in columns}
