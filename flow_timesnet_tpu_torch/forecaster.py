"""Serving API: a resident model that forecasts in-memory history windows.

Counterpart of ``flow_timesnet_tpu/forecaster.py`` (``forecast`` and
``_forecast_raw``). It serves from parameters and arrays held in memory:
loading the JAX package's artifact directory (a flax msgpack checkpoint, a
YAML config, pickled scalers) and ``forecast_quantiles`` are later slices.
History is a ``[T, n]`` numpy array; calendar features come from optional
``datetime64`` stamps aligned with its rows, stepped into the future by the
model's frequency.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.pivot import ScalerDict, inverse_transform, transform_array
from .data.time_features import build_time_features
from .engine import Engine
from .models.timesnet import TimesNetConfig

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
        self.engine = Engine(cfg, params, device)
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

        rate_np, disp_np, columns = self._forecast_raw(history, series, horizon, dates)
        rate_out = np.clip(
            inverse_transform(rate_np, columns, self._sub_scaler(columns), self.method),
            0.0,
            None,
        )
        if return_dispersion:
            return rate_out, disp_np
        return rate_out

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
        xb = self._tensor(scaled.T[:, :, None])  # [n, L, 1]

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
            x_mark = self._tensor(np.broadcast_to(marks[:L][None], (n, L, marks.shape[1])))
            y_mark = self._tensor(np.broadcast_to(marks[L:][None], (n, horizon, marks.shape[1])))

        static = (
            self._tensor(self.static_features[positions][:, None, :])
            if self.static_features is not None
            else None
        )
        ids_arr = self._tensor(positions.reshape(-1, 1))
        floor = (
            self._tensor(self.sigma_vector[positions].reshape(-1, 1, 1))
            if self.sigma_vector is not None
            else None
        )

        if cfg.mode == "direct":
            rate, disp = self.engine.forward(xb, x_mark, static, ids_arr, floor)
            rate, disp = rate[:, :horizon, :], disp[:, :horizon, :]
        else:
            rate, disp = self.engine.rollout(
                xb, horizon, x_mark=x_mark, y_mark=y_mark, static=static, ids=ids_arr,
                floor=floor,
            )
        rate_np = rate[:, :, 0].T.float().cpu().numpy()  # [horizon, n]
        disp_np = disp[:, :, 0].T.float().cpu().numpy()
        return rate_np, disp_np, columns

    def _sub_scaler(self, columns: List[str]):
        if self.scaler is None or self.method == "none":
            return None
        return {c: self.scaler[c] for c in columns}
