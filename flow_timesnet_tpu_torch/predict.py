"""Inference from stored artifacts: ``predict_once(cfg) -> submission_path``
(counterpart of ``flow_timesnet_tpu/predict.py``).

The runtime config is merged over the stored ``config_used.yaml``; the
metadata, signature, schema and normalization artifacts are validated; the
model is rebuilt from the checkpoint (the series embedding zero-grown for
ids beyond the trained vocab) as a :class:`~.forecaster.Forecaster`; each
TEST file becomes one batch (unseen series dropped, the rest reindexed to
the trained ids, the horizon's future dates and row keys); the forecast is
direct or recursive; the rates are inverse-transformed, clipped at zero and
rendered in the configured submission format, with one more file per
predictive quantile. ``predict.ensemble_dirs`` runs the whole path once per
artifact directory and reduces the rendered submissions cell-wise.

The device is the card (``train.device`` names anything but ``cpu``) and a
missing card raises. On the card each distinct forward shape replays one
CUDA graph (``Engine.forward``), so the fixed-shape chunks of
``predict.chunk_rows`` replay one graph between them. No pandas: TEST files
are read by ``data/csv_long.py`` and submissions written by
``utils/submission.py``, byte for byte as pandas writes them.

Data parallelism (``predict.data_parallel``, default ``auto``): in a
process that is a rank of a group (``parallel/mesh.py``; ``cli predict``
spawns one rank per visible card), every forward block is padded to a
multiple of the world (repeats of its last row, masked by ``row_valid``),
each rank forwards its rows (the period selection is the whole block's),
the rows are gathered on every rank and rank 0 writes the files. Chunk rows
round up to the world, as in JAX.

Deliberate differences from the JAX package: a horizon ``freq`` that is a
calendar alias with no fixed step (``MS``, ``B``, ...) raises, naming the
alias, where pandas would step it; JAX's data-parallel predict runs in one
process only, the port's on ranks.
"""

from __future__ import annotations

import copy
import os
import re
import time
from dataclasses import dataclass
from glob import glob
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import convert
from .config import PipelineConfig, load_yaml
from .data.csv_long import read_csv_long
from .data.pivot import infer_freq, inverse_transform, pivot_long_to_wide, transform_array
from .data.time_features import build_time_features
from .device import resolve_device
from .parallel import mesh
from .forecaster import (
    Forecaster,
    checkpoint_floors,
    checkpoint_vocab,
    freeze_for_serving,
    future_stamps,
    serving_model_config,
)
from .utils import artifacts as artifacts_io
from .utils import metadata as metadata_utils
from .utils.quantiles import (
    parse_quantile_config,
    predictive_quantiles,
    quantile_label,
    quantile_out_path,
)
from .utils.submission import (
    Forecasts,
    SubmissionRowMeta,
    build_submission_context,
    get_submission_writer,
    merge_forecasts,
    read_submission,
    write_submission,
)

# pandas' offset aliases that have no fixed step (business days, month and
# quarter ends and starts, ...): the port cannot step them without pandas
_CALENDAR_ALIAS = re.compile(
    r"\d*(B|C|BM|BME|BMS|CBM|CBMS|M|ME|MS|SM|SME|SMS|Q|QE|QS|BQ|BQE|BQS|A|Y|YE|AS|YS|BA|BAS|"
    r"BY|BYE|BYS|BH|CBH|L|ms|U|us|N|ns)(-\w+)?")


def _log(msg: str) -> None:
    if mesh.is_main():
        print(msg, flush=True)


def _is_alias(freq: str) -> bool:
    """Whether pandas' ``to_offset`` takes ``freq``: an alias the port steps
    (:func:`~.forecaster.future_stamps`) or a calendar alias."""

    try:
        future_stamps(freq, np.zeros(1, dtype="datetime64[s]"), 1)
    except ValueError:
        return bool(_CALENDAR_ALIAS.fullmatch(str(freq).strip()))
    return True


def _horizon_stamps(freq: Optional[str], history_index: np.ndarray, horizon: int,
                   name: str) -> np.ndarray:
    """The ``horizon`` stamps after a TEST file's history: stepped by
    ``freq`` (``data.horizon_freq``), else by the history's inferred
    frequency, else daily with a warning; an alias that is not one falls
    back to daily steps with a warning, one that has no fixed step raises."""

    freq_str = freq or infer_freq(history_index)
    if not freq_str:
        freq_str = "D"
        _log(f"Failed to infer frequency for {name}; defaulting to daily horizon increments.")
    try:
        return future_stamps(freq_str, history_index, horizon)
    except ValueError as err:
        if _CALENDAR_ALIAS.fullmatch(str(freq_str).strip()):
            raise ValueError(
                f"horizon frequency {freq_str!r} of {name} has no fixed step; the PyTorch "
                "package steps D, h, min, s and W[-<DAY>] (with a multiple) only: set "
                "data.horizon_freq to one of them") from err
        _log(f"Invalid horizon frequency '{freq_str}' for {name} ({err}); falling back to "
             "daily steps.")
        return future_stamps("D", history_index, horizon)


@dataclass
class TestBatch:
    """One TEST file, ready to forecast."""

    path: str
    name: str
    values: np.ndarray  # [T, len(ids)] float64, on the trained ids
    gather_positions: List[int]  # the trained positions of the series it holds
    history_index: np.ndarray  # [T] datetime64[s]
    future_dates: np.ndarray  # [horizon] datetime64[s]
    pred_row_keys: List[str]  # the rows the model forecasts


def _resolve_test_paths(data_cfg: Mapping[str, Any]) -> List[str]:
    """Resolve test CSVs from test_glob / test_files / test_path / test_dir."""

    patterns: List[str] = []
    if data_cfg.get("test_glob"):
        raw = data_cfg["test_glob"]
        patterns = [raw] if isinstance(raw, str) else [str(p) for p in raw]
    elif data_cfg.get("test_files"):
        raw = data_cfg["test_files"]
        patterns = [raw] if isinstance(raw, str) else [str(p) for p in raw]
    elif data_cfg.get("test_path"):
        patterns = [str(data_cfg["test_path"])]
    elif data_cfg.get("test_dir"):
        patterns = [
            os.path.join(str(data_cfg["test_dir"]), data_cfg.get("test_pattern", "TEST_*.csv"))
        ]
    inner = data_cfg.get("test_pattern", "TEST_*.csv")
    resolved: List[str] = []
    seen = set()
    for pattern in patterns:
        expanded = glob(pattern)
        if not expanded and os.path.isdir(pattern):
            expanded = glob(os.path.join(pattern, inner))
        if not expanded:
            expanded = [pattern]
        for path in expanded:
            # a glob that matches a directory expands to its test files
            paths = glob(os.path.join(path, inner)) if os.path.isdir(path) else [path]
            for p in paths:
                full = os.path.abspath(p)
                if full not in seen:
                    resolved.append(full)
                    seen.add(full)
    return sorted(resolved)


def _prepare_test_batches(
    *,
    data_cfg: Mapping[str, Any],
    preprocess_cfg: Mapping[str, Any],
    schema_obj,
    ids: Sequence[str],
    id_position_map: Mapping[str, int],
    pred_len: int,
    full_horizon_decode: bool = False,
) -> Tuple[
    List[TestBatch],
    Dict[str, SubmissionRowMeta],
    List[str],
    Dict[str, List[str]],
    List[str],
    List[str],
    Dict[str, List[str]],
]:
    encoding = data_cfg.get("encoding", "utf-8")
    fill_missing_dates = bool(data_cfg.get("fill_missing_dates", True))
    horizon = int(data_cfg.get("horizon") or pred_len)
    clip_negative = bool(preprocess_cfg.get("clip_negative", False))

    test_paths = _resolve_test_paths(data_cfg)
    if not test_paths:
        raise FileNotFoundError(
            "No test files found; check data.test_dir, test_glob, or test_files configuration"
        )

    batches: List[TestBatch] = []
    row_meta: Dict[str, SubmissionRowMeta] = {}
    row_order: List[str] = []
    test_parts: Dict[str, List[str]] = {}
    missing_by_part: Dict[str, List[str]] = {}
    new_ids: List[str] = []
    union: set = set()

    for path in test_paths:
        table = read_csv_long(path, encoding=encoding)
        schema_obj.require_columns(table.columns, context=path)
        wide_raw = pivot_long_to_wide(
            table,
            date_col=schema_obj["date"],
            id_col=schema_obj["id"],
            target_col=schema_obj["target"],
            fill_missing_dates=fill_missing_dates,
            fillna0=True,
        )
        if clip_negative:
            wide_raw = wide_raw.clip_lower(0.0)
        name = os.path.splitext(os.path.basename(path))[0]
        union.update(wide_raw.columns)
        present = [c for c in wide_raw.columns if c in id_position_map]
        unknown = [c for c in wide_raw.columns if c not in id_position_map]
        if unknown:
            _log(f"{name} contains {len(unknown)} series unseen during training; values will "
                 "be zero-filled.")
            new_ids.extend([c for c in unknown if c not in new_ids])
        if not present:
            raise ValueError(f"Test series '{path}' does not contain any known ids")
        present_set = set(present)
        missing = [c for c in ids if c not in present_set]
        if missing:
            _log(f"{name} missing {len(missing)} trained series; outputs will use default fill "
                 "values for those ids.")
        history_index = wide_raw.index
        if len(history_index) == 0:
            raise ValueError(f"Test series '{path}' does not contain any historical rows")

        future_index = _horizon_stamps(data_cfg.get("horizon_freq"), history_index, horizon, name)
        row_keys = [f"{name}+D{i}" for i in range(1, horizon + 1)]
        row_order.extend(row_keys)
        test_parts[name] = row_keys
        missing_by_part[name] = missing
        for step, (row_key, date_val) in enumerate(zip(row_keys, future_index), start=1):
            row_meta[row_key] = SubmissionRowMeta(
                test_part=name, step=step, date=date_val, source=path
            )
        batches.append(
            TestBatch(
                path=path,
                name=name,
                # unseen series dropped, zeros where a trained one is absent
                values=wide_raw.reindex_columns(list(ids)).values,
                gather_positions=[id_position_map[c] for c in present],
                history_index=history_index,
                future_dates=future_index,
                pred_row_keys=list(row_keys) if full_horizon_decode else row_keys[:pred_len],
            )
        )
    return batches, row_meta, row_order, test_parts, new_ids, sorted(union), missing_by_part


_AUTO_CHUNK_ROWS = 2048


def _resolve_chunk_rows(
    predict_cfg: Mapping[str, Any] | None, num_series: int, mesh_size: int
) -> Optional[int]:
    """Rows per forward, or ``None`` for the whole batch in one.

    ``predict.chunk_rows``: ``"auto"`` (default: the whole batch up to 2048
    rows, 2048-row chunks beyond), an int, or ``null``/``off``. Every chunk
    has one shape (the tail is padded and masked by ``row_valid``), so the
    forward is one program, a single CUDA graph on the card, whatever the
    series count.
    """

    raw = (predict_cfg or {}).get("chunk_rows", "auto")
    if raw in (None, False) or str(raw).lower() in ("none", "null", "off", "0"):
        return None
    if str(raw).lower() == "auto":
        chunk = _AUTO_CHUNK_ROWS
    else:
        chunk = int(raw)
        if chunk <= 0:
            return None
    if mesh_size > 1:
        chunk = -(-chunk // mesh_size) * mesh_size
    if chunk >= num_series:
        return None
    return chunk


def _validate_signature(signature: Mapping[str, Any], cfg: PipelineConfig) -> None:
    """Fail fast on window/model-hyperparameter drift vs the checkpoint."""

    errors: List[str] = []
    window_sig = signature.get("window")
    if isinstance(window_sig, Mapping):
        for key, current in (
            ("input_len", cfg.window.input_len),
            ("pred_len", cfg.window.pred_len),
            ("stride", cfg.window.stride),
        ):
            sig_val = window_sig.get(key)
            if sig_val is not None and int(sig_val) != current:
                errors.append(
                    f"Configured window.{key}={current} differs from checkpoint value {sig_val}"
                )
    model_sig = signature.get("model")
    if isinstance(model_sig, Mapping):
        for key in ("d_model", "d_ff", "n_layers", "k_periods", "min_period_threshold",
                    "id_embed_dim"):
            sig_val = model_sig.get(key)
            if sig_val is None:
                continue
            current = getattr(cfg.model, key)
            if int(sig_val) != int(current):
                errors.append(
                    f"Configured model.{key}={current} differs from checkpoint value {sig_val}"
                )
        if "static_proj_dim" in model_sig:
            sig_proj = model_sig.get("static_proj_dim")
            sig_proj_val = None if sig_proj in {None, "null"} else int(sig_proj)
            if sig_proj_val != cfg.model.static_proj_dim:
                errors.append(
                    f"Configured model.static_proj_dim={cfg.model.static_proj_dim} differs "
                    f"from checkpoint value {sig_proj_val}"
                )
        sig_mode = model_sig.get("mode")
        if sig_mode is not None and str(sig_mode) != cfg.model.mode:
            errors.append(
                f"Configured model.mode={cfg.model.mode} differs from checkpoint value {sig_mode}"
            )
    if errors:
        raise ValueError(
            "Configuration incompatible with checkpoint metadata:\n"
            + "\n".join(f"- {e}" for e in errors)
        )


def _submission_path(section: Mapping[str, Any]) -> Optional[str]:
    path = section.get("output_path") or section.get("out_path")
    return str(path) if path else None


def _ensemble_out_path(runtime_dict: Dict[str, Any]) -> str:
    """The final submission path of an ensemble predict: the runtime
    config's, else the base member's stored ``config_used.yaml``'s."""

    path = _submission_path(runtime_dict.get("submission") or {})
    if path:
        return path
    artifacts_cfg = runtime_dict.get("artifacts") or {}
    trained = load_yaml(
        os.path.join(artifacts_cfg["dir"], artifacts_cfg.get("config_file", "config_used.yaml")))
    path = _submission_path(trained.get("submission") or {})
    if not path:
        raise ValueError(
            "submission.output_path (or out_path) must be specified for ensemble prediction")
    return path


def _reduce_files(paths: Sequence[str], out_path: str, reduce: str, what: str) -> None:
    """Reduce rendered submissions cell-wise (``mean`` or ``median``) into
    ``out_path``; every file must have the first one's columns and rows."""

    frames = [read_submission(p, encoding="utf-8-sig") for p in paths]
    head = frames[0]
    for p, frame in zip(paths[1:], frames[1:]):
        if [frame.key_column, *frame.columns] != [head.key_column, *head.columns]:
            raise ValueError(f"Ensemble member {p} rendered different submission columns than "
                             "the base member")
        if frame.keys != head.keys:
            raise ValueError(f"Ensemble member {p} rendered different submission rows than the "
                             "base member")
    if not mesh.is_main():  # rank 0 alone writes
        return
    stacked = np.stack([f.values for f in frames])
    out = head.copy()
    out.values = np.median(stacked, axis=0) if reduce == "median" else stacked.mean(axis=0)
    write_submission(out, out_path)
    _log(f"Saved {reduce}-of-{len(frames)} {what}: {out_path}")


def _predict_ensemble(runtime_dict: Dict[str, Any], ensemble_dirs: Sequence[str]) -> str:
    """Deep-ensemble inference over independently trained artifact dirs.

    Runs the whole single-model predict (its validation included) once per
    member, ``artifacts.dir`` first, then every entry of
    ``predict.ensemble_dirs``, and reduces the rendered submissions
    cell-wise (``predict.ensemble_reduce``: ``mean``, the default, or
    ``median``). Reducing rendered submissions keeps every contract (row
    keys, template alignment, missing-row policy, fill values) the
    single-model path's. Member submissions stay next to the output as
    ``<out>.member<i>.csv``; the quantile files reduce the same way.
    """

    base_dir = (runtime_dict.get("artifacts") or {}).get("dir")
    if not base_dir:
        raise ValueError("artifacts.dir must be set for ensemble prediction")
    member_dirs: List[str] = [base_dir]
    for d in ensemble_dirs:
        if str(d) not in member_dirs:
            member_dirs.append(str(d))
    if len(member_dirs) < 2:
        raise ValueError(
            "predict.ensemble_dirs must list at least one artifact directory besides "
            "artifacts.dir"
        )
    predict_cfg = runtime_dict.get("predict") or {}
    reduce = str(predict_cfg.get("ensemble_reduce", "mean")).lower()
    if reduce not in ("mean", "median"):
        raise ValueError(f"predict.ensemble_reduce must be 'mean' or 'median', got {reduce!r}")
    member_model = str(predict_cfg.get("ensemble_member_model", "member")).lower()
    if member_model not in ("member", "runtime"):
        raise ValueError(
            f"predict.ensemble_member_model must be 'member' or 'runtime', got {member_model!r}"
        )

    out_path = _ensemble_out_path(runtime_dict)
    member_paths: List[str] = []
    for i, d in enumerate(member_dirs):
        member = copy.deepcopy(runtime_dict)
        member.setdefault("predict", {}).pop("ensemble_dirs", None)
        member["artifacts"] = dict(member.get("artifacts") or {}, dir=d)
        if member_model == "member":
            # each member forwards through its own trained architecture: the
            # runtime's model section would override the member's stored one
            cfg_path = os.path.join(d, member["artifacts"].get("config_file", "config_used.yaml"))
            if os.path.exists(cfg_path):
                stored_model = (load_yaml(cfg_path) or {}).get("model")
                if stored_model:
                    member["model"] = stored_model
        member_path = f"{out_path}.member{i}.csv"
        member["submission"] = dict(member.get("submission") or {}, out_path=member_path,
                                    output_path=member_path)
        _log(f"Ensemble member {i + 1}/{len(member_dirs)}: {d}")
        member_paths.append(predict_once(member))

    _reduce_files(member_paths, out_path, reduce, "ensemble submission")
    q_levels, _ = parse_quantile_config(
        predict_cfg, (runtime_dict.get("preprocess") or {}).get("normalize", "none"))
    for q in q_levels:
        _reduce_files([quantile_out_path(p, q) for p in member_paths],
                      quantile_out_path(out_path, q), reduce,
                      f"{quantile_label(q)} ensemble submission")
    mesh.barrier()  # the files exist when any rank returns
    return out_path


def _merged_config(runtime_dict: Dict[str, Any]) -> PipelineConfig:
    """The runtime config over the stored ``config_used.yaml``: section by
    section, the runtime's keys win; ``artifacts`` is the runtime's."""

    runtime_artifacts = runtime_dict.setdefault("artifacts", {})
    runtime_artifacts.setdefault("signature_file", "model_signature.json")
    runtime_artifacts.setdefault("metadata_file", "metadata.json")
    trained_cfg = PipelineConfig.from_mapping(load_yaml(os.path.join(
        runtime_artifacts["dir"], runtime_artifacts.get("config_file", "config_used.yaml"))))
    merged = trained_cfg.to_dict()
    merged.setdefault("artifacts", {}).update(runtime_artifacts)
    for key, value in runtime_dict.items():
        if key == "artifacts":
            continue
        if isinstance(value, dict):
            merged.setdefault(key, {}).update(value)
        else:
            merged[key] = value
    return PipelineConfig.from_mapping(merged)


def _load_signature(path: str) -> Optional[Mapping[str, Any]]:
    if not os.path.exists(path):
        _log(f"Signature metadata '{path}' not found; compatibility checks skipped.")
        return None
    try:
        return metadata_utils.load_json(path)
    except (OSError, ValueError) as err:
        _log(f"Failed to read signature metadata '{path}': {err}. Continuing without "
             "compatibility checks.")
        return None


def _static_features(cfg_used: Dict[str, Any], art_dir: str, scaler_meta: Mapping[str, Any],
                     ids: List[str]) -> Optional[np.ndarray]:
    """[len(ids), dim] static features: a readable ``artifacts.static_file``
    (a dict with ``static_features`` and ``ids``/``series_ids``, or an
    array) wins over the scaler metadata's; rows align by id, zeros where
    one is missing."""

    static_np = None
    static_ids: Optional[List[str]] = None
    static_file = cfg_used["artifacts"].get("static_file")
    if static_file:
        static_path = static_file if os.path.isabs(static_file) else os.path.join(art_dir,
                                                                                 static_file)
        try:
            payload = artifacts_io.load_pickle(static_path)
        except OSError as err:
            _log(f"Static feature artifact not readable at {static_path} ({err}); falling back "
                 "to scaler metadata.")
        else:
            if isinstance(payload, dict):
                static_np = payload.get("static_features")
                payload_ids = payload.get("ids") or payload.get("series_ids")
                if payload_ids is not None:
                    static_ids = list(payload_ids)
            elif isinstance(payload, np.ndarray):
                static_np = payload
            else:
                _log(f"Unsupported static feature artifact type {type(payload)!r}; falling back "
                     "to scaler metadata.")
            if static_np is None:
                _log(f"Static feature artifact {static_path} did not contain features; falling "
                     "back to scaler metadata.")
    if static_np is None:
        static_np = scaler_meta.get("static_features")
        static_ids = static_ids or list(ids)
    if static_np is None:
        return None
    arr = np.asarray(static_np, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim != 2:
        return None
    base_ids = static_ids or ids
    id_to_row = {base_ids[i]: i for i in range(min(arr.shape[0], len(base_ids)))}
    static_full = np.zeros((len(ids), arr.shape[1]), np.float32)
    missing_static = []
    for pos, sid in enumerate(ids):
        row = id_to_row.get(sid)
        if row is None:
            missing_static.append(sid)
        else:
            static_full[pos] = arr[row]
    if missing_static:
        _log(f"Static features missing for {len(missing_static)} series; zero-filled values "
             "will be used.")
    return static_full


def _calendar_marks(batch: TestBatch, meta_config: Mapping[str, Any], freq_str: Optional[str],
                    input_len: int, decode_steps: int, meta_dim: int):
    """``(x_mark [L, F], y_mark [decode_steps, F])`` of a TEST file, or None
    (with a warning) where no frequency is known or valid or the features'
    width is not the model's."""

    if freq_str is None:
        freq_str = infer_freq(batch.history_index)
    if freq_str is None:
        _log("Unable to infer frequency for time features during prediction; temporal marks "
             "disabled for this batch.")
        return None
    if not _is_alias(freq_str):
        _log(f"Invalid frequency '{freq_str}' for time features; disabling temporal marks for "
             "this batch.")
        return None
    combined = np.concatenate([batch.history_index[-input_len:],
                               batch.future_dates[:decode_steps]])
    marks = build_time_features(combined, {**meta_config, "enabled": True})
    if marks.shape[1] != meta_dim:
        _log("Time feature dimension mismatch during prediction; temporal marks disabled for "
             "this batch.")
        return None
    return marks[:input_len], marks[input_len:]


def predict_once(cfg: PipelineConfig | Dict[str, Any]) -> str:
    """Forecast every TEST file from the stored artifacts and write the
    submission (and one file per ``predict.quantiles`` level); returns the
    submission's path."""

    if isinstance(cfg, PipelineConfig):
        runtime_cfg = cfg
    elif isinstance(cfg, dict):
        runtime_cfg = PipelineConfig.from_mapping(cfg)
    else:
        raise TypeError("cfg must be a PipelineConfig or mapping")

    runtime_dict = runtime_cfg.to_dict()
    ensemble_dirs = (runtime_dict.get("predict") or {}).get("ensemble_dirs") or []
    if ensemble_dirs:
        return _predict_ensemble(runtime_dict, ensemble_dirs)
    active_cfg = _merged_config(runtime_dict)
    cfg_used = active_cfg.to_dict()
    art_dir = cfg_used["artifacts"]["dir"]
    device = resolve_device(
        "cpu" if str(cfg_used.get("train", {}).get("device", "")).lower() == "cpu" else "cuda")

    metadata_path = os.path.join(art_dir, cfg_used["artifacts"].get("metadata_file",
                                                                    "metadata.json"))
    try:
        metadata_artifact = metadata_utils.load_metadata_artifact(metadata_path)
    except FileNotFoundError as err:
        raise FileNotFoundError(
            f"Metadata artifact '{metadata_path}' not found; run training to generate it."
        ) from err
    except ValueError as err:
        raise ValueError(f"Failed to load metadata artifact '{metadata_path}': {err}") from err
    metadata_artifact.validate_config(active_cfg)

    signature_meta = _load_signature(os.path.join(
        art_dir, cfg_used["artifacts"].get("signature_file", "model_signature.json")))
    if signature_meta is not None:
        _validate_signature(signature_meta, active_cfg)

    scaler_meta = artifacts_io.load_pickle(
        os.path.join(art_dir, cfg_used["artifacts"].get("scaler_file", "scaler.pkl")))
    schema_obj, schema_meta = artifacts_io.load_schema_artifact(
        os.path.join(art_dir, cfg_used["artifacts"].get("schema_file", "schema.json")))
    schema_obj.validate_overrides(cfg_used.get("data", {}))
    preprocess_cfg = cfg_used.setdefault("preprocess", {})
    artifacts_io.validate_normalization_config(preprocess_cfg, schema_meta.get("normalization"))

    ids: List[str] = list(scaler_meta["ids"])
    metadata_artifact.validate_artifacts(schema=schema_obj, scaler_meta=scaler_meta,
                                         num_series=len(ids))
    method = scaler_meta["method"]
    scaler = scaler_meta["scaler"]

    time_feature_meta = scaler_meta.get("time_features") or {}
    data_time_cfg = dict(cfg_used.get("data", {}).get("time_features") or {})
    meta_config = dict(time_feature_meta.get("config") or data_time_cfg)
    meta_enabled = bool(time_feature_meta.get("enabled", meta_config.get("enabled", False)))
    meta_dim = int(time_feature_meta.get("feature_dim", meta_config.get("feature_dim", 0)) or 0)
    meta_freq = time_feature_meta.get("freq") or meta_config.get("freq")
    meta_config.setdefault("enabled", meta_enabled)
    cfg_used.setdefault("data", {}).setdefault("time_features", {}).update(
        {"feature_dim": meta_dim, "freq": meta_freq, "enabled": meta_enabled})
    time_features_enabled = bool(meta_enabled and meta_dim > 0)

    data_sig = (signature_meta or {}).get("data")
    if isinstance(data_sig, Mapping):
        if data_sig.get("num_series") is not None and int(data_sig["num_series"]) != len(ids):
            raise ValueError(f"Checkpoint expects {data_sig['num_series']} series but scaler "
                             f"metadata provides {len(ids)}")
        if (data_sig.get("time_feature_dim") is not None
                and int(data_sig["time_feature_dim"]) != meta_dim):
            raise ValueError("Time feature dimension does not match checkpoint metadata")
        if (data_sig.get("time_features_enabled") is not None
                and bool(data_sig["time_features_enabled"]) != time_features_enabled):
            raise ValueError("Time feature enablement differs from checkpoint metadata")

    static_full = _static_features(cfg_used, art_dir, scaler_meta, ids)
    if isinstance(data_sig, Mapping):
        sig_static_dim = data_sig.get("static_feature_dim")
        actual_dim = int(static_full.shape[1]) if static_full is not None else 0
        if sig_static_dim is not None and int(sig_static_dim) != actual_dim:
            raise ValueError(f"Static feature dimension {actual_dim} does not match checkpoint "
                             f"metadata {sig_static_dim}")

    # ------------------------------------------------------------------ model
    window_cfg = active_cfg.window
    input_len = window_cfg.input_len
    pred_len = window_cfg.pred_len
    train_cfg = cfg_used["train"]
    tree, aux = artifacts_io.load_checkpoint(
        os.path.join(art_dir, cfg_used["artifacts"].get("model_file", "timesnet.msgpack")))
    sigma_vector, min_sigma = checkpoint_floors(aux, train_cfg)
    tn_cfg = serving_model_config(
        active_cfg, cfg_used["model"], min_sigma=min_sigma,
        static_dim=int(static_full.shape[1]) if static_full is not None else 0,
        time_features=meta_dim if time_features_enabled else 0,
        id_vocab=checkpoint_vocab(tree, len(ids)))
    # Predict-side period specialization (``predict.freeze_periods``). The
    # dynamic path re-selects periods from each TEST window's FFT; freezing
    # pins the training-time selection. A chunked forward selects per chunk
    # (a chunk-local batch mean), so where the config is silent and chunks
    # will run, ``auto`` pins the stored spec (if any) and makes the result
    # independent of how the rows are chunked.
    predict_cfg_raw = cfg_used.get("predict") or {}
    mesh.check_launch(predict_cfg_raw, device, "predict", "predict")
    n_ranks = mesh.world()  # the ranks share every forward block
    raw_freeze = predict_cfg_raw.get("freeze_periods")
    if raw_freeze is None:
        will_chunk = _resolve_chunk_rows(predict_cfg_raw, len(ids), n_ranks) is not None
        raw_freeze = "auto" if will_chunk else "off"
        if will_chunk:
            _log("freeze_periods defaulting to 'auto' (chunked predict: pin the trained period "
                 "selection if the checkpoint froze)")
    tn_cfg = freeze_for_serving(tn_cfg, raw_freeze, train_cfg.get("frozen_periods_spec"), _log)

    if n_ranks > 1:
        _log(f"Predict: data-parallel over {n_ranks} ranks ({mesh.current().backend})")
    fc = Forecaster(convert.params_from_jax(tree, tn_cfg), tn_cfg, ids, scaler, method,
                    static_full, sigma_vector, device=device)
    engine = fc.engine

    id_position_map = {sid: i for i, sid in enumerate(ids)}
    t_prep = time.monotonic()
    (test_batches, row_meta, row_order, test_parts, new_ids, test_ids_union,
     missing_by_part) = _prepare_test_batches(
        data_cfg=cfg_used.setdefault("data", {}),
        preprocess_cfg=preprocess_cfg,
        schema_obj=schema_obj,
        ids=ids,
        id_position_map=id_position_map,
        pred_len=pred_len,
        # a recursive decode covers the whole requested horizon
        full_horizon_decode=(tn_cfg.mode != "direct"),
    )
    _log(f"prepared {len(test_batches)} test batches in {time.monotonic() - t_prep:.1f}s")

    sample_df = None
    sample_path = cfg_used["data"].get("sample_submission")
    if sample_path:
        try:
            sample_df = read_submission(sample_path, encoding=cfg_used["data"].get("encoding",
                                                                                   "utf-8"))
        except OSError as err:
            _log(f"Sample submission not readable at {sample_path} ({err}); a template will be "
                 "synthesized from test inputs.")

    missing_global = sorted(set(ids) - set(test_ids_union))
    new_ids_sorted = sorted(set(new_ids))

    q_levels, q_method = parse_quantile_config(cfg_used.get("predict") or {}, method)
    q_pred_lists: Dict[float, List[Forecasts]] = {q: [] for q in q_levels}

    def run_rows(arrays: Dict[str, Optional[np.ndarray]], n_rows: int, decode_steps: int):
        """One fixed-shape forward; rows [0, n_rows) of rate and dispersion.
        Under a group each rank forwards its rows of the block (padded to
        the world) and every rank gets them all back."""

        if n_ranks > 1:
            arrays = mesh.shard_rows(_pad_rows(arrays, n_ranks))
        t = {k: (fc._tensor(v) if v is not None else None) for k, v in arrays.items()}
        if tn_cfg.mode == "direct":
            rate, disp = engine.forward(t["x"], t["x_mark"], t["static"], t["ids"], t["floor"],
                                        t["row_valid"])
        else:
            rate, disp = engine.rollout(t["x"], decode_steps, x_mark=t["x_mark"],
                                        y_mark=t["y_mark"], static=t["static"], ids=t["ids"],
                                        floor=t["floor"], row_valid=t["row_valid"])
        both = torch.stack([rate[:, :, 0], disp[:, :, 0]], dim=1).float()  # [b, 2, H]
        both = mesh.gather_rows(both)[:n_rows].cpu().numpy()
        return both[:, 0], both[:, 1]

    pred_list: List[Forecasts] = []
    for batch in test_batches:
        X = batch.values.astype(np.float32)
        Xn = transform_array(X, ids, scaler, method) if method != "none" and scaler else X

        disable_marks = False
        if Xn.shape[0] < input_len:
            missing_rows = input_len - Xn.shape[0]
            strategy = window_cfg.short_series_strategy
            if strategy == "repeat":
                Xn = np.concatenate([np.repeat(Xn[:1], missing_rows, axis=0), Xn], axis=0)
                disable_marks = True
                _log(f"{batch.name} shorter than input_len={input_len}; repeating earliest "
                     "observations to fill the window.")
            elif strategy == "pad":
                pad_block = np.full((missing_rows, Xn.shape[1]), window_cfg.pad_value,
                                    np.float32)
                Xn = np.concatenate([pad_block, Xn], axis=0)
                disable_marks = True
                _log(f"{batch.name} shorter than input_len={input_len}; padding leading values "
                     f"with {window_cfg.pad_value}.")
            else:
                raise ValueError(
                    f"Test series '{batch.path}' shorter than required input_len={input_len} "
                    "and window.short_series_strategy='error'"
                )

        gather = np.asarray(batch.gather_positions, dtype=np.int64)
        # one model row per present series: [num_series, input_len, 1]
        xb = np.ascontiguousarray(np.transpose(Xn[-input_len:, :][:, gather], (1, 0))[:, :, None])
        num_series = xb.shape[0]

        decode_steps = len(batch.pred_row_keys)
        x_mark = y_mark = None
        if time_features_enabled and not disable_marks:
            freq_str = meta_freq or cfg_used.get("data", {}).get("time_features", {}).get("freq")
            marks = _calendar_marks(batch, meta_config, freq_str, input_len, decode_steps,
                                    meta_dim)
            if marks is not None:
                x_mark = np.broadcast_to(marks[0][None], (num_series, input_len, meta_dim)).copy()
                y_mark = np.broadcast_to(marks[1][None],
                                         (num_series, decode_steps, meta_dim)).copy()
        elif time_features_enabled and disable_marks:
            _log(f"Temporal marks disabled for {batch.name} because padded windows may not align "
                 "with calendar frequencies.")

        host_arrays = {
            "x": xb,
            "x_mark": x_mark,
            "y_mark": y_mark,
            "static": static_full[gather][:, None, :] if static_full is not None else None,
            "ids": gather.reshape(-1, 1).astype(np.int32),
            "floor": sigma_vector[gather].reshape(-1, 1, 1) if sigma_vector is not None else None,
            "row_valid": None,
        }
        chunk_rows = _resolve_chunk_rows(cfg_used.get("predict"), num_series, n_ranks)
        t_fwd = time.monotonic()
        if chunk_rows is None:
            rate_np, disp_np = run_rows(host_arrays, num_series, decode_steps)
        else:
            # fixed-shape blocks: the tail padded with repeats of the last row
            # and masked out of the selector's batch means by row_valid
            rates, disps = [], []
            for lo in range(0, num_series, chunk_rows):
                hi = min(lo + chunk_rows, num_series)
                pad = chunk_rows - (hi - lo)
                sub = {
                    k: (np.concatenate([v[lo:hi], np.repeat(v[hi - 1:hi], pad, axis=0)])
                        if pad else v[lo:hi]) if v is not None else None
                    for k, v in host_arrays.items()
                }
                sub["row_valid"] = np.concatenate(
                    [np.ones(hi - lo, np.float32), np.zeros(pad, np.float32)])
                rate_c, disp_c = run_rows(sub, hi - lo, decode_steps)
                rates.append(rate_c)
                disps.append(disp_c)
            rate_np = np.concatenate(rates, axis=0)
            disp_np = np.concatenate(disps, axis=0)
        _log(f"{batch.name}: forward {num_series} rows in {time.monotonic() - t_fwd:.1f}s"
             + (f" ({chunk_rows}-row chunks)" if chunk_rows else ""))
        effective_steps = len(batch.pred_row_keys)
        row_keys = batch.pred_row_keys[:effective_steps]
        Pn = np.zeros((effective_steps, len(ids)), np.float32)
        Pn[:, gather] = rate_np[:, :effective_steps].T
        P = np.clip(inverse_transform(Pn, ids, scaler, method=method), 0.0, None)
        pred_list.append(Forecasts(row_keys, list(ids), P))

        if q_levels:
            # quantiles in model space, pushed through the monotone inverse
            # scaler: quantiles commute with monotone maps
            qs = predictive_quantiles(q_levels, rate_np[:, :effective_steps],
                                      disp_np[:, :effective_steps], method=q_method)
            for q, qv in qs.items():
                Qn = np.zeros((effective_steps, len(ids)), np.float32)
                Qn[:, gather] = np.asarray(qv, np.float32).T
                Q = np.clip(inverse_transform(Qn, ids, scaler, method=method), 0.0, None)
                q_pred_lists[q].append(Forecasts(row_keys, list(ids), Q))

    preds = merge_forecasts(pred_list)
    t_write = time.monotonic()
    submission_cfg = cfg_used.setdefault("submission", {})
    context = build_submission_context(
        predictions=preds,
        sample_df=sample_df,
        row_meta=row_meta,
        row_order=row_order,
        test_parts=test_parts,
        ids=ids,
        new_ids=new_ids_sorted,
        missing_ids=missing_global,
        missing_by_part=missing_by_part,
        submission_cfg=submission_cfg,
    )
    writer = get_submission_writer(submission_cfg.get("format", "date_menu"))(
        default_fill_value=context.default_fill_value,
        missing_policy=submission_cfg.get("missing_policy"),
    )
    output_path = _submission_path(submission_cfg)
    if not output_path:
        raise ValueError(
            "submission.output_path (or out_path) must be specified in the configuration")
    if mesh.is_main():
        render_and_write(writer, preds, context, output_path)
    _log(f"Saved submission: {output_path} (render+write {time.monotonic() - t_write:.1f}s)")

    for q in q_levels:
        q_path = quantile_out_path(output_path, q)
        if mesh.is_main():
            render_and_write(writer, merge_forecasts(q_pred_lists[q]), context, q_path)
        _log(f"Saved {quantile_label(q)} submission ({q_method}): {q_path}")
    mesh.barrier()  # the files exist when any rank returns
    return output_path


def _pad_rows(arrays: Dict[str, Optional[np.ndarray]], n: int) -> Dict[str, Optional[np.ndarray]]:
    """A forward block padded to a multiple of ``n`` rows with repeats of
    its last row, which ``row_valid`` keeps out of the period selection's
    batch means (JAX ``predict.py``'s padded shards)."""

    pad = (-arrays["x"].shape[0]) % n
    if not pad:
        return arrays
    valid = arrays.get("row_valid")
    if valid is None:
        valid = np.ones(arrays["x"].shape[0], np.float32)
    out = {k: (np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) if v is not None else None)
           for k, v in arrays.items()}
    out["row_valid"] = np.concatenate([valid, np.zeros(pad, np.float32)])
    return out


def render_and_write(writer, predictions: Forecasts, context, path: str) -> None:
    """Render ``predictions`` in the writer's layout and write the CSV."""

    write_submission(writer.render(predictions, context), path)
