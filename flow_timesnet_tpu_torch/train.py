"""Training pipeline: ``train_once(cfg) -> (best_nll, artifact_paths)``
(counterpart of ``flow_timesnet_tpu/train.py``).

CSV -> schema -> pivot (validity mask = pre-fill NaNs) -> static features
-> leak-free scaler fit -> holdout/rolling window batchers -> min-sigma
calibration -> model -> AdamW + warmup/cosine epoch schedule -> early
stopping on the selection metric -> artifacts (checkpoint, ``scaler.pkl``,
``schema.json``, ``config_used.yaml``, ``metadata.json``,
``model_signature.json``), section by section as the JAX package's
``_train_once_impl``, with the same numpy host arithmetic, so the wide
arrays, the scaler, the static features, the floors and the batches are the
JAX package's own.

The device is the card (``train.device`` names anything but ``cpu``; the
shipped recipes say ``tpu``) and a missing card raises; ``cpu`` runs the
plain PyTorch versions. The input pipeline is chosen as in JAX:
``train.input_pipeline`` ``auto`` stages every fold on the device when the
staged arrays fit ``train.device_stage_mb`` and accumulation is off, and
then each epoch runs ``Engine.train_epoch_resident`` in chunks of
``train.resident_max_dispatch_steps`` (on the card one CUDA-graph replay a
step) and validation ``Engine.evaluate_resident``; otherwise the host
pipeline gathers batches with numpy, a ``data/windows.py::Prefetcher``
assembling the next ``train.prefetch_factor`` of them on a thread (0: off),
and takes one ``Engine.train_step`` a batch (on the card one CUDA-graph
replay). ``train.scan_steps`` is accepted and ignored: the JAX package's
scanned chunks compute what single steps compute, and a chunk captured as
one CUDA graph cost more to capture than it saved over a flagship epoch on
an H100 (``PERF.md``).
Dropout draws from one generator, seeded anew each epoch from
``(tuning.seed, epoch)``, so a resumed run repeats the epochs it continues.
Window augmentation (``data.augment``) draws from the training batcher's
numpy generator on the host pipeline (the JAX package's batches bit for
bit) and from the dropout generator inside each resident step; validation,
the probe and evaluation see clean windows.

Data parallelism (``train.data_parallel``, default ``auto``): in a process
that is a rank of a group (``parallel/mesh.py``: ``cli train`` spawns one
rank per visible card, or ``torchrun`` starts them), the global batch is
padded with ``row_valid = 0`` rows to a multiple of the world and each rank
steps on its rows, as the JAX package shards a batch over its mesh. Every
rank builds the same global batches and plans from the same seeds; dropout
and the resident augmentation draw from a generator seeded per rank. The
period selection, the loss's normaliser, the gradients and the evaluation
sums are global; ``train.shard_embedding`` (``auto``: ``id_vocab >= 2048``)
row-shards the series table where the world divides it. Rank 0's frozen
spec, metrics and pruning decision hold on every rank, and rank 0 alone
logs and writes the artifacts (from the assembled table: the files one card
writes). A process that sees several cards and belongs to no group raises,
naming both ways to launch ranks.

``train.debug_nans`` reads back whether each step's loss, gradients and
updated parameters are finite (one wait for the card a step) and raises
``FloatingPointError`` at the first step where one is not, naming the
epoch, the step and the first such parameter. ``train.profile_dir`` traces the first epoch after the first
one (``torch.profiler``, the CPU and, on the card, CUDA activities) into
that directory as a Chrome trace, with tracing on (``tracing.py``): the
trace holds the program's spans and the region marks, and that epoch's log
line adds its region totals in ms a step. ``model.period_buckets`` is accepted and
runs the full-cap fold, which gives the bucketed result
(``models/timesblock.py``).
"""

from __future__ import annotations

import math
import os
import re
import time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import convert
from .build import timesnet_config_from_dict
from .config import PipelineConfig, save_yaml
from .data.csv_long import read_csv_long
from .data.device_windows import epoch_index_plan, stage_windows
from .data.pivot import fit_series_scaler, infer_freq, pivot_long_to_wide, transform_dataframe
from .data.schema import DataSchema
from .data.split import make_holdout_slices, make_rolling_slices
from .data.static_features import compute_series_features
from .data.windows import Prefetcher, build_batcher, pad_batch_rows
from .device import resolve_device
from .engine import Engine, batch_to_device, first_non_finite
from .optim import LRController, resolve_warmup
from .parallel import mesh
from .tracing import EpochTrace
from .utils import artifacts as artifacts_io
from .utils import metadata as metadata_utils
from .utils.metrics import wsmape_from_series_sums
from .utils.seed import seed_everything

_ALIAS = re.compile(r"(\d*)(D|h|H|min|T|s|S)")
_ALIAS_SECONDS = {"D": 86400, "h": 3600, "H": 3600, "min": 60, "T": 60, "s": 1, "S": 1}


def _log(msg: str) -> None:
    if mesh.is_main():
        print(msg, flush=True)


def masked_std(
    arrays: List[np.ndarray],
    masks: List[Optional[np.ndarray]],
    method: str = "global",
) -> Tuple[float, Optional[np.ndarray]]:
    """Std summary over masked [T, N] arrays.

    ``global`` pools every valid point; ``per_series_median`` returns the
    median of per-series stds plus the per-series vector.
    """

    if len(arrays) == 0:
        return 0.0, None
    method = method.lower()
    if method == "global":
        total = total_sq = 0.0
        count = 0
        for arr, mask in zip(arrays, masks):
            if arr.size == 0:
                continue
            values = arr.reshape(-1) if mask is None else arr[np.asarray(mask) > 0.0]
            if values.size == 0:
                continue
            v64 = values.astype(np.float64)
            total += float(v64.sum())
            total_sq += float(np.square(v64).sum())
            count += int(values.size)
        if count == 0:
            return 0.0, None
        mean = total / count
        return float(math.sqrt(max(total_sq / count - mean * mean, 0.0))), None

    if method == "per_series_median":
        n_series: Optional[int] = None
        s = ss = c = None
        for arr, mask in zip(arrays, masks):
            arr2d = np.asarray(arr)
            if arr2d.ndim == 1:
                arr2d = arr2d.reshape(-1, 1)
            if arr2d.size == 0:
                continue
            if mask is None:
                mb = np.ones(arr2d.shape, dtype=bool)
            else:
                mask_arr = np.asarray(mask)
                if mask_arr.shape != arr2d.shape:
                    raise ValueError(
                        "Mask shape must match array shape for per-series std computation"
                    )
                mb = mask_arr > 0.0
            if not np.any(mb):
                continue
            a64 = arr2d.astype(np.float64)
            mf = mb.astype(np.float64)
            if n_series is None:
                n_series = arr2d.shape[1]
                s = np.zeros(n_series)
                ss = np.zeros(n_series)
                c = np.zeros(n_series)
            elif n_series != arr2d.shape[1]:
                raise ValueError("All arrays must have the same number of series")
            s += (a64 * mf).sum(axis=0)
            ss += (np.square(a64) * mf).sum(axis=0)
            c += mf.sum(axis=0)
        if n_series is None:
            return 0.0, None
        per = np.zeros(n_series)
        valid = c > 0
        if not np.any(valid):
            return 0.0, per
        means = np.where(valid, s / np.maximum(c, 1.0), 0.0)
        variances = np.where(valid, np.maximum(ss / np.maximum(c, 1.0) - means**2, 0.0), 0.0)
        per = np.sqrt(variances)
        per[~valid] = 0.0
        stds = per[valid]
        return float(np.median(stds)), per

    raise ValueError(
        f"Unsupported min_sigma_method '{method}'. Expected 'global' or 'per_series_median'."
    )


def periods_to_day_counts(periods: List[int], freq: Optional[str]) -> List[Optional[float]]:
    """Period step counts as days, for a fixed-step ``freq`` alias."""

    m = _ALIAS.fullmatch(str(freq or "").strip())
    if m is None:
        return [None for _ in periods]
    day_scale = int(m.group(1) or 1) * _ALIAS_SECONDS[m.group(2)] / 86400.0
    return [p * day_scale for p in periods]


def _log_period_telemetry(telemetry: Dict[str, Any], freq: Optional[str], epoch: int) -> None:
    all_periods = sorted(
        {
            int(p)
            for info in telemetry.values()
            for p, ok in zip(info["periods"], info["valid"])
            if ok
        }
    )
    if not all_periods:
        return
    parts = []
    for p, d in zip(all_periods, periods_to_day_counts(all_periods, freq)):
        if d is None:
            parts.append(f"{p}")
        elif abs(d - round(d)) < 1e-6:
            parts.append(f"{p} (~{int(round(d))}d)")
        else:
            parts.append(f"{p} (~{d:.2f}d)")
    groups = ", ".join(f"{k}:{v['group_count']}" for k, v in sorted(telemetry.items()))
    _log(f"Epoch {epoch}: selected periods {', '.join(parts)} (groups {groups})")


def _floor_for_batch(batch, sigma_vector: Optional[np.ndarray]):
    """Per-sample dispersion floor gathered by series id."""

    if sigma_vector is None or batch.series_ids is None:
        return None
    gathered = sigma_vector[batch.series_ids.reshape(-1)]
    return gathered.reshape(-1, 1, 1).astype(np.float32)


def _log_device_memory(tag: str, device: torch.device) -> None:
    """Allocated and peak device memory (``model.debug_memory``); nothing on
    the CPU."""

    if device.type != "cuda":
        return
    _log(f"mem[{tag}] {torch.cuda.get_device_name(device)} "
         f"in_use={torch.cuda.memory_allocated(device) / 1e6:.1f}MB "
         f"peak={torch.cuda.max_memory_allocated(device) / 1e6:.1f}MB")


def _stage_from_batcher(batcher, sigma_vector, device):
    """Stage a batcher's (already filtered, feature-computed) sources on
    ``device``, so the device plan's flat indices mean what the host
    iterator's do. None for an empty batcher."""

    sources = batcher.sources
    if not sources:
        return None
    s0 = sources[0]
    return stage_windows(
        [s.X for s in sources],
        [s.M for s in sources],
        s0.L,
        s0.H,
        s0.stride,
        "direct",  # s0.H already encodes the mode's horizon
        marks=[s.marks for s in sources],
        static=s0.static,
        sigma_vector=sigma_vector,
        augment={"add_noise_std": s0.add_noise_std, "time_shift": s0.time_shift},
        device=device,
    )


def _staged_nbytes(batcher) -> int:
    sources = batcher.sources
    if not sources:
        return 0
    t_max = max(s.T for s in sources)
    per_fold = t_max * sources[0].N * 4 * 2  # X + M
    if sources[0].marks is not None:
        per_fold += t_max * sources[0].marks.shape[1] * 4
    return per_fold * len(sources)


def _epoch_seed(seed: int, epoch: int, rank: Optional[int] = None) -> int:
    """The dropout generator's seed for ``epoch``: a function of the run's
    seed and the epoch only, and of the rank where there are several (each
    rank's rows draw their own masks)."""

    entropy = [int(seed), 1, int(epoch)] + ([int(rank)] if rank is not None else [])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def _spec_lists(spec) -> List[List[List[Any]]]:
    return [[list(slot) for slot in layer] for layer in spec]


def _is_on(value: Any, default: str) -> bool:
    return str(value if value is not None else default).lower() in (
        "1", "true", "yes", "on", "auto")


def train_once(
    cfg: PipelineConfig | Dict[str, Any],
    epoch_hook: Optional[Any] = None,
) -> Tuple[float, Dict[str, Any]]:
    """Train from a config and its CSV; returns ``(best_nll, paths)``.

    ``epoch_hook(epoch, selection_value) -> bool`` is called after every
    epoch's validation; returning True stops training early (the tuner's
    pruner).
    """

    trace = EpochTrace()
    try:
        return _train_once(cfg, epoch_hook, trace)
    finally:
        trace.stop()  # a run that raises mid-epoch leaves no profiler running


def _train_once(cfg, epoch_hook, trace: EpochTrace) -> Tuple[float, Dict[str, Any]]:
    t_start = time.perf_counter()
    if isinstance(cfg, PipelineConfig):
        pipeline_cfg = cfg
    elif isinstance(cfg, dict):
        pipeline_cfg = PipelineConfig.from_mapping(cfg)
    else:
        raise TypeError("cfg must be a PipelineConfig or mapping")
    cfg = pipeline_cfg.to_dict()

    window_cfg = pipeline_cfg.window
    cfg.setdefault("window", {}).update(window_cfg.to_dict())
    cfg.setdefault("model", {}).update(pipeline_cfg.model.to_dict(window_cfg))
    artifacts_section = cfg.setdefault("artifacts", {})
    artifacts_section.setdefault("signature_file", "model_signature.json")
    artifacts_section.setdefault("metadata_file", "metadata.json")
    train_section = cfg.setdefault("train", {})
    train_section.setdefault("val", {})

    debug_nans = bool(cfg["train"].get("debug_nans", False))
    profile_dir = cfg["train"].get("profile_dir")
    device = resolve_device(
        "cpu" if str(cfg["train"].get("device", "")).lower() == "cpu" else "cuda")
    debug_memory = bool(cfg["model"].get("debug_memory", False))
    # train.deterministic is accepted and needs nothing: see seed_everything
    seed = seed_everything(int(cfg.get("tuning", {}).get("seed", 2025)))
    _log(f"Device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                if device.type == "cuda" else ""))

    # ------------------------------------------------------------------ data
    data_cfg = cfg.setdefault("data", {})
    time_feature_cfg = dict(data_cfg.get("time_features") or {})
    time_feature_cfg.setdefault("enabled", False)
    time_features_enabled = bool(time_feature_cfg.get("enabled", False))
    data_cfg["time_features"] = time_feature_cfg

    table = read_csv_long(cfg["data"]["train_csv"], encoding=cfg["data"].get("encoding", "utf-8"))
    schema = DataSchema.from_config(data_cfg, sample_df=table)
    data_cfg.setdefault("schema", schema.as_dict())
    wide_raw = pivot_long_to_wide(
        table,
        date_col=schema["date"],
        id_col=schema["id"],
        target_col=schema["target"],
        fill_missing_dates=bool(cfg["data"].get("fill_missing_dates", True)),
        fillna0=False,
    )
    del table
    mask_wide = wide_raw.with_values((~wide_raw.isna()).astype(np.float32))
    wide = wide_raw.fillna(0.0)
    series_static_np, static_feature_names = compute_series_features(wide, mask_wide)
    if cfg.get("preprocess", {}).get("clip_negative", False):
        wide = wide.clip_lower(0.0)
    ids = list(wide.columns)

    # ------------------------------------------------- splits + scaler (leak-free)
    preprocess = cfg.setdefault("preprocess", {})
    norm_method = preprocess.get("normalize", "none")
    norm_per_series = bool(preprocess.get("normalize_per_series", True))
    eps = float(preprocess.get("eps", 1e-8))
    val_cfg = cfg["train"]["val"]
    strategy = val_cfg.get("strategy", "holdout")

    train_arrays: List[np.ndarray] = []
    val_arrays: List[np.ndarray] = []
    train_mask_arrays: List[np.ndarray] = []
    val_mask_arrays: List[np.ndarray] = []
    train_time_indices: Optional[List[np.ndarray]] = [] if time_features_enabled else None
    val_time_indices: Optional[List[np.ndarray]] = [] if time_features_enabled else None

    if strategy == "holdout":
        trn_df, val_df = make_holdout_slices(wide, int(val_cfg["holdout_days"]))
        trn_mask_df, val_mask_df = make_holdout_slices(mask_wide, int(val_cfg["holdout_days"]))
        if norm_method == "none":
            scaler = None
            trn_norm, val_norm = trn_df, val_df
        else:
            scaler, trn_norm = fit_series_scaler(trn_df, norm_method, norm_per_series, eps)
            val_norm = transform_dataframe(val_df, ids, scaler, norm_method)
        train_arrays = [trn_norm.to_numpy(np.float32)]
        val_arrays = [val_norm.to_numpy(np.float32)]
        train_mask_arrays = [trn_mask_df.to_numpy(np.float32)]
        val_mask_arrays = [val_mask_df.to_numpy(np.float32)]
        if time_features_enabled:
            train_time_indices = [trn_norm.index]
            val_time_indices = [val_norm.index]
    else:
        folds = int(val_cfg.get("rolling_folds") or 1)
        step_days = int(val_cfg.get("rolling_step_days") or 1)
        val_len = int(val_cfg["holdout_days"])
        fold_slices = list(make_rolling_slices(wide, folds, step_days, val_len))
        if not fold_slices:
            raise ValueError("No folds produced; check rolling validation configuration")
        if norm_method == "none":
            scaler = None
            wide_norm = wide
        else:
            # leak-free fit: the LAST fold's train slice ends before every
            # fold's validation window
            fit_tr = fold_slices[-1][0]
            scaler, _ = fit_series_scaler(fit_tr, norm_method, norm_per_series, eps)
            wide_norm = transform_dataframe(wide, ids, scaler, norm_method)
        for (tr_df, va_df), (tr_m, va_m) in zip(
            make_rolling_slices(wide_norm, folds, step_days, val_len),
            make_rolling_slices(mask_wide, folds, step_days, val_len),
        ):
            train_arrays.append(tr_df.to_numpy(np.float32))
            val_arrays.append(va_df.to_numpy(np.float32))
            train_mask_arrays.append(tr_m.to_numpy(np.float32))
            val_mask_arrays.append(va_m.to_numpy(np.float32))
            if time_features_enabled:
                train_time_indices.append(tr_df.index)
                val_time_indices.append(va_df.index)

    # ------------------------------------------------------------ batchers
    input_len = window_cfg.input_len
    pred_len = window_cfg.pred_len
    mode = cfg["model"]["mode"]
    batch_size = int(cfg["train"]["batch_size"])
    series_id_array = np.arange(len(ids), dtype=np.int64)
    n_folds_t = len(train_arrays)
    n_folds_v = len(val_arrays)
    # the step's pandas alias: the filled grid's, else inferred from the stamps
    inferred_freq = wide.freq or infer_freq(wide.index)
    dl_train = build_batcher(
        train_arrays,
        train_mask_arrays,
        input_len,
        pred_len,
        window_cfg.stride,
        mode,
        batch_size,
        shuffle=True,
        drop_last=True,
        augment=cfg["data"].get("augment"),
        series_static=[series_static_np] * n_folds_t,
        series_ids=[series_id_array] * n_folds_t,
        time_indices=train_time_indices,
        time_feature_config=time_feature_cfg if time_features_enabled else None,
        seed=seed,
        time_frequency=inferred_freq,
    )
    dl_val = build_batcher(
        val_arrays,
        val_mask_arrays,
        input_len,
        pred_len,
        window_cfg.stride,
        mode,
        batch_size,
        shuffle=False,
        drop_last=False,
        recursive_pred_len=(pred_len if mode == "recursive" else None),
        augment=None,
        series_static=[series_static_np] * n_folds_v,
        series_ids=[series_id_array] * n_folds_v,
        time_indices=val_time_indices,
        time_feature_config=time_feature_cfg if time_features_enabled else None,
        seed=seed + 1,
        pad_final=True,
        time_frequency=inferred_freq,
    )
    if dl_val.total == 0:
        raise ValueError(
            "Validation split has no windows; increase train.val.holdout_days or "
            "adjust model.input_len/pred_len."
        )
    time_feature_dim = dl_train.time_feature_dim
    cfg["data"]["time_features"]["feature_dim"] = int(time_feature_dim)
    if inferred_freq is not None:
        cfg["data"]["time_features"]["freq"] = inferred_freq
    time_feature_meta = {
        "enabled": bool(time_features_enabled and time_feature_dim > 0),
        "feature_dim": int(time_feature_dim),
        "config": dict(time_feature_cfg),
        "freq": inferred_freq,
    }

    use_loss_masking = bool(cfg["train"].get("use_loss_masking", False))

    # -------------------------------------------------- min-sigma calibration
    min_sigma_method = str(cfg["train"].get("min_sigma_method", "global"))
    target_std, per_series_std = masked_std(
        train_arrays, train_mask_arrays, method=min_sigma_method
    )
    min_sigma_cfg_val = float(cfg["train"].get("min_sigma", 1e-3))
    min_sigma_scale = float(cfg["train"].get("min_sigma_scale", 0.1))
    scaled = target_std * min_sigma_scale if target_std > 0.0 else 0.0
    min_sigma_scalar = max(min_sigma_cfg_val, scaled)
    sigma_vector: Optional[np.ndarray] = None
    if per_series_std is not None and per_series_std.size > 0:
        sigma_vector = np.maximum(
            np.asarray(per_series_std, np.float64) * min_sigma_scale, min_sigma_scalar
        ).astype(np.float32)
        cfg["train"]["min_sigma_vector"] = [float(v) for v in sigma_vector]
    else:
        cfg["train"].pop("min_sigma_vector", None)
    cfg["train"]["min_sigma_effective"] = float(min_sigma_scalar)
    _log(f"min_sigma calibrated: {min_sigma_scalar:.6f} "
         f"(target std={target_std:.6f}, scale={min_sigma_scale})")

    # ------------------------------------------------------------------ model
    model_cfg_raw = cfg["model"]
    d_model = int(model_cfg_raw["d_model"])
    d_ff = int(model_cfg_raw.get("d_ff", 4 * d_model))
    model_cfg_raw["d_ff"] = d_ff
    static_dim = int(series_static_np.shape[1]) if series_static_np.size else 0
    model_cfg_raw["kernel_set"] = [list(k) for k in pipeline_cfg.model.kernel_set]
    model_cfg_raw["static_proj_dim"] = pipeline_cfg.model.static_proj_dim
    tn_cfg = timesnet_config_from_dict(
        cfg,
        static_dim=static_dim,
        time_feature_dim=int(time_feature_dim),
        id_vocab=max(1, len(ids)),
        min_sigma=float(min_sigma_scalar),
    )

    # Polyak/EMA weight averaging (``train.ema_decay``, default off): the
    # averaged weights are evaluated, selected and checkpointed; the raw
    # weights keep training.
    ema_decay = float(cfg["train"].get("ema_decay", 0.0) or 0.0)
    if len(dl_train) == 0:
        raise ValueError("Training split has no windows")
    init_params = convert.init_params(tn_cfg, torch.Generator().manual_seed(seed))

    # Data parallelism: one rank a card, each on its rows of the global
    # batch, padded with row_valid=0 rows to a multiple of the world (JAX
    # train.py:670-720); the series table row-sharded where asked and where
    # the world divides it.
    mesh.check_launch(cfg["train"], device, "train", "train")
    use_dp = mesh.grouped()
    n_ranks = mesh.world()
    dp_rows = mesh.dp_batch_rows(batch_size) if use_dp else batch_size
    plan_rows = dp_rows if use_dp else None
    shard_tables = False
    if use_dp:
        mesh.check_dcn(n_ranks, cfg["train"].get("dcn_slices", 1))
        shard_raw = str(cfg["train"].get("shard_embedding", "auto")).lower()
        vocab = tn_cfg.id_vocab
        want_shard = (vocab >= 2048 if shard_raw == "auto"
                      else shard_raw in ("true", "1", "yes", "on"))
        shard_tables = want_shard and vocab % n_ranks == 0
        if want_shard and not shard_tables:
            _log(f"shard_embedding requested but id_vocab={vocab} does not divide the world "
                 f"size {n_ranks}; the table stays replicated")
        cfg["train"]["shard_embedding_effective"] = bool(shard_tables)
        _log(f"Data parallel: batch {batch_size}"
             + (f" (padded to {dp_rows})" if dp_rows != batch_size else "")
             + f" sharded over mesh {mesh.current().axes}"
             + (" · embedding table row-sharded" if shard_tables else "")
             + f" ({mesh.current().backend}"
             + ("; its collectives cannot be captured, so every step runs eagerly)"
                if device.type == "cuda" and not mesh.graphs_allowed() else ")"))

    def make_engine(model_cfg):
        return Engine(
            model_cfg,
            init_params,
            device,
            use_loss_masking=use_loss_masking,
            accumulation_steps=int(cfg["train"].get("accumulation_steps", 1)),
            grad_clip_norm=float(cfg["train"].get("grad_clip_norm", 0.0) or 0.0),
            weight_decay=float(cfg["train"].get("weight_decay", 0.0)),
            num_series=len(ids),
            ema_decay=ema_decay,
            debug_nans=debug_nans,
            shard_table=shard_tables,
        )

    engine = make_engine(tn_cfg)
    sharded = engine.sharded  # the parameters each rank holds only its rows of
    # Period specialization (``train.freeze_periods``): after
    # ``train.freeze_after_epoch`` warm-up epochs, a selection that is the
    # same at two consecutive probes becomes an engine on the frozen-period
    # path. It takes the same TrainState (its parameters, moments and EMA,
    # bound in place: no tensor moves, so the graphs each engine captured
    # stay valid); the per-epoch probe keeps running on the dynamic engine,
    # and a drift swaps the dynamic engine back in for an epoch. Each
    # distinct spec costs an engine (and its graphs), at most
    # ``train.freeze_max_recompiles`` of them.
    dynamic_engine = engine
    freeze_enabled = _is_on(cfg["train"].get("freeze_periods"), "off")
    freeze_after = max(1, int(cfg["train"].get("freeze_after_epoch", 1) or 1))
    freeze_max = max(1, int(cfg["train"].get("freeze_max_recompiles", 3) or 3))
    frozen_state: Dict[str, Any] = {"spec": None, "prev": None, "engines": {}}

    def maybe_freeze(ep, telemetry, current_engine):
        if not freeze_enabled:
            return current_engine
        spec_now = Engine.frozen_spec_from_telemetry(telemetry, tn_cfg.n_layers)
        # every rank takes rank 0's spec: ranks on different specs would run
        # different programs and deadlock in the next collective
        spec_now = mesh.sync_frozen_spec(spec_now, tn_cfg.n_layers, tn_cfg.k_periods)
        if spec_now is None:
            return current_engine
        prev = frozen_state["prev"]
        frozen_state["prev"] = spec_now
        if frozen_state["spec"] is not None:
            if spec_now == frozen_state["spec"]:
                return current_engine
            _log(f"freeze_periods: selection drifted at epoch {ep}; running this epoch on "
                 "the dynamic path (re-freezes when the selection is stable again)")
            frozen_state["spec"] = None
            cfg["train"].pop("frozen_periods_spec", None)
            cfg["train"]["freeze_periods_drift_epoch"] = int(ep)
            return dynamic_engine
        if ep <= freeze_after or spec_now != prev:
            return current_engine
        if spec_now not in frozen_state["engines"]:
            if len(frozen_state["engines"]) >= freeze_max:
                return current_engine
            frozen_state["engines"][spec_now] = make_engine(
                replace(tn_cfg, frozen_periods=spec_now))
        frozen_state["spec"] = spec_now
        cfg["train"]["frozen_periods_spec"] = _spec_lists(spec_now)
        periods = sorted({p for layer in spec_now for p, _, v in layer if v})
        _log(f"freeze_periods: epoch {ep} freezes periods {periods} into the exact-extent "
             "fold conv")
        return frozen_state["engines"][spec_now]

    state = engine.init_state()
    if use_dp:  # every rank starts from rank 0's weights (a shard keeps its own rows)
        mesh.replicate(t.detach() for named in (state.params, state.ema or {})
                       for k, t in named.items() if k not in sharded)

    def to_device(batch):
        if use_dp:  # this rank's rows of the global batch, padded to the world
            if batch.x.shape[0] < dp_rows:
                batch = pad_batch_rows(batch, dp_rows)
            batch = mesh.shard_rows(batch)
        return batch_to_device(batch, floor=_floor_for_batch(batch, sigma_vector), device=device)

    n_params = sum(int(p.numel()) for p in state.params.values())
    if sharded:
        n_params = int(n_params + (n_ranks - 1) * state.params[mesh.TABLE_NAME].numel())
    _log(f"Parameters: {n_params:,}")

    # ------------------------------------------------------------ lr schedule
    epochs = int(cfg["train"]["epochs"])
    accum_steps = max(1, int(cfg["train"].get("accumulation_steps", 1)))
    batches_per_epoch = len(dl_train)
    updates_per_epoch = (
        max(1, math.ceil(batches_per_epoch / accum_steps)) if batches_per_epoch > 0 else 1
    )
    warmup = resolve_warmup(
        cfg["train"].get("lr_warmup_steps"),
        cfg["train"].get("lr_warmup_epochs"),
        updates_per_epoch,
    )
    lr_ctl = LRController(
        base_lr=float(cfg["train"]["lr"]),
        epochs=epochs,
        sched_cfg=cfg["train"].get("lr_scheduler", {}),
        warmup=warmup,
    )
    cfg["train"].update(lr_ctl.effective_summary())
    _log(f"window {cfg['window']}\nmodel {cfg['model']}\nlr(epoch 1) "
         f"{lr_ctl.lr_for_epoch(1):.3e}")

    # ------------------------------------------------------------ train loop
    best_nll = float("inf")
    best_smape = float("inf")
    best_wsmape = float("inf")
    best_params: Optional[Dict[str, torch.Tensor]] = None
    best_epoch = 0
    # the frozen spec active when the best snapshot was taken (None: dynamic);
    # config_used.yaml records it, describing the checkpoint that is shipped
    best_frozen_spec = None
    patience_limit = cfg["train"].get("early_stopping_patience")
    patience = 0
    selection_metric = str(cfg["train"].get("selection_metric", "nll")).lower()
    if selection_metric not in ("nll", "smape"):
        raise ValueError(
            f"train.selection_metric must be 'nll' or 'smape', got {selection_metric!r}"
        )
    best_sel = float("inf")
    epoch_throughputs: List[float] = []
    # per epoch: seconds (the probe and the steps), of which the probe's (the
    # telemetry forward, the freeze decision), then the evaluation's seconds,
    # whether the frozen-period path ran, the mean loss and the val metrics
    history: Dict[str, List[Any]] = {k: [] for k in ("seconds", "probe_seconds", "eval_seconds",
                                                     "frozen", "loss", "val_nll", "val_smape")}
    generator = torch.Generator(device=device)

    art_dir = cfg["artifacts"].get("dir", "outputs/artifacts")
    model_path = os.path.join(art_dir, cfg["artifacts"].get("model_file", "timesnet.msgpack"))
    resume_enabled = bool(cfg["train"].get("resume", False))
    save_state_enabled = bool(cfg["train"].get("save_train_state", resume_enabled))
    train_state_path = os.path.join(art_dir, artifacts_io.TRAIN_STATE_FILE)
    start_epoch = 1
    if resume_enabled and os.path.exists(train_state_path):
        state, resume_extra = artifacts_io.load_train_state(train_state_path, state, sharded)
        start_epoch = int(resume_extra.get("epoch", 0)) + 1
        best_nll = float(resume_extra.get("best_nll", best_nll))
        best_smape = float(resume_extra.get("best_smape", best_smape))
        best_wsmape = float(resume_extra.get("best_wsmape", best_wsmape))
        best_sel = float(
            resume_extra.get(
                "best_sel", best_nll if selection_metric == "nll" else best_smape
            )
        )
        best_epoch = int(resume_extra.get("best_epoch", 0))
        patience = int(resume_extra.get("patience", 0))
        lr_ctl.load_state_dict(resume_extra.get("lr_state", {}))
        try:
            best_frozen_spec = Engine.frozen_spec_from_config(
                resume_extra.get("best_frozen_spec"), tn_cfg.n_layers
            )
        except ValueError:
            best_frozen_spec = None
        if os.path.exists(model_path) and np.isfinite(best_nll):
            tree, _ = artifacts_io.load_checkpoint(model_path)
            best_params = {k: v.to(device) for k, v in mesh.shard_train_state(
                convert.params_from_jax(tree, tn_cfg), sharded).items()}
        _log(f"Resumed from epoch {start_epoch - 1} "
             f"(best_nll={best_nll:.6f} @ epoch {best_epoch})")

    # longest single resident pass, in steps (0: the whole epoch at once)
    resident_max_dispatch = int(cfg["train"].get("resident_max_dispatch_steps", 512) or 0)
    # the host pipeline's next batches, assembled on a thread (0: off)
    prefetch = int(cfg["train"].get("prefetch_factor", 2) or 0)

    # Input-pipeline selection, as in JAX: "device" stages the folds on the
    # device once and gathers each batch there; "host" gathers with numpy;
    # "auto" (default) picks device whenever the staged arrays fit
    # ``train.device_stage_mb`` and accumulation is off.
    pipeline_req = str(cfg["train"].get("input_pipeline", "auto")).lower()
    stage_budget = float(cfg["train"].get("device_stage_mb", 512) or 512) * 1e6
    staged_train = staged_val = None
    if pipeline_req == "device" and accum_steps > 1:
        _log("train.input_pipeline=device is incompatible with accumulation_steps="
             f"{accum_steps}; the host pipeline runs instead.")
    if pipeline_req != "host" and accum_steps == 1:
        fits = _staged_nbytes(dl_train) + _staged_nbytes(dl_val) <= stage_budget
        if pipeline_req == "device" or fits:
            staged_train = _stage_from_batcher(dl_train, sigma_vector, device)
            staged_val = _stage_from_batcher(dl_val, sigma_vector, device)
    use_resident = staged_train is not None and staged_val is not None
    cfg["train"]["input_pipeline_effective"] = "device" if use_resident else "host"
    if use_resident:
        # the eval plan is deterministic: build it once
        val_idx, val_rv = epoch_index_plan(staged_val.total, batch_size, plan_rows,
                                           shuffle=False, drop_last=False)
        # a FIXED telemetry probe batch, so that the drift check does not see
        # batch-sampling noise as selection drift
        probe_idx, probe_rv = epoch_index_plan(staged_train.total, batch_size, plan_rows,
                                               shuffle=False, drop_last=True)
        _log("Input pipeline: device-resident "
             f"({(_staged_nbytes(dl_train) + _staged_nbytes(dl_val)) / 1e6:.1f} MB staged)")

    if debug_memory:
        _log_device_memory("post-init", device)

    t_loop = time.perf_counter()
    for ep in range(start_epoch, epochs + 1):
        if profile_dir and ep == start_epoch + 1:  # the first epoch after the warm-up one
            trace.start(device)
        dl_train.set_epoch(ep)
        generator.manual_seed(_epoch_seed(seed, ep, mesh.rank() if n_ranks > 1 else None))
        lr = lr_ctl.lr_for_epoch(ep)
        t0 = time.perf_counter()

        def check_step(step: int, finite: torch.Tensor, ep: int = ep) -> None:
            if use_dp:  # a sharded table's flags are each rank's own: stop together
                finite = mesh.all_sum_((~finite).int()) == 0
            bad = first_non_finite(state, finite)
            if bad is not None:
                raise FloatingPointError(
                    f"train.debug_nans: {bad} not finite at epoch {ep}, step {step}")

        if use_resident:
            idx_np, rv_np = epoch_index_plan(
                staged_train.total, batch_size, plan_rows, shuffle=True, drop_last=True,
                rng=np.random.default_rng([seed, ep]),
            )
            if idx_np.shape[0] == 0:
                raise ValueError("Training split has no windows")
            # the probe always runs the DYNAMIC model: drift detection must
            # see the live selection, not the frozen constants
            telemetry = dynamic_engine.collect_period_telemetry_staged(
                state.params, staged_train, probe_idx[0], probe_rv[0]
            )
            _log_period_telemetry(telemetry, inferred_freq, ep)
            engine = maybe_freeze(ep, telemetry, engine)
            t_probe = time.perf_counter()
            n_steps = int(idx_np.shape[0])
            chunk = resident_max_dispatch if resident_max_dispatch else n_steps
            loss_parts, mask_parts = [], []
            for off in range(0, n_steps, chunk):
                end = min(off + chunk, n_steps)
                state, part_losses, part_mask = engine.train_epoch_resident(
                    state, lr, generator, staged_train, idx_np[off:end], rv_np[off:end],
                    step_offset=off, on_step=check_step if debug_nans else None,
                )
                loss_parts.append(part_losses)
                mask_parts.append(part_mask)
            fetched = torch.cat([torch.cat(loss_parts), torch.cat(mask_parts)]).cpu().numpy()
            losses = [float(v) for v in fetched[:n_steps]]
            mask_true_total = float(fetched[n_steps:].astype(np.float64).sum())
            mask_total = float(rv_np.sum()) * float(staged_train.horizon)
            n_batches = n_steps
        else:
            step_losses, step_mask, step_total = [], [], []
            n_batches = 0
            # the next batches assembled on a thread while the card steps
            # (train.prefetch_factor, 0: off), released however the loop ends
            host_iter = Prefetcher(dl_train, prefetch) if prefetch > 0 else dl_train
            try:
                for i, batch in enumerate(host_iter):
                    dev_batch = to_device(batch)
                    if i == 0:
                        telemetry = dynamic_engine.collect_period_telemetry(state.params,
                                                                            dev_batch)
                        _log_period_telemetry(telemetry, inferred_freq, ep)
                        engine = maybe_freeze(ep, telemetry, engine)
                        t_probe = time.perf_counter()
                    do_update = ((i + 1) % accum_steps == 0) or ((i + 1) == batches_per_epoch)
                    state, loss, stats = engine.train_step(state, lr, generator, dev_batch,
                                                           do_update)
                    if debug_nans:
                        check_step(i + 1, stats["finite"])
                    step_losses.append(loss)
                    step_mask.append(stats["mask_true"])
                    step_total.append(stats["mask_total"])
                    n_batches += 1
            finally:
                if isinstance(host_iter, Prefetcher):
                    host_iter.close()
            if n_batches == 0:
                raise ValueError("Training split has no windows")
            fetched = torch.stack(
                [torch.stack(step_losses), torch.stack(step_mask).float(),
                 torch.stack(step_total).float()]).cpu().numpy()
            losses = [float(v) for v in fetched[0]]
            mask_true_total = float(fetched[1].astype(np.float64).sum())
            mask_total = float(fetched[2].astype(np.float64).sum())
        epoch_time = time.perf_counter() - t0
        coverage = mask_true_total / mask_total if mask_total > 0 else 0.0
        throughput = (n_batches * batch_size) / max(epoch_time, 1e-9)
        epoch_throughputs.append(float(throughput))
        mean_loss = float(np.mean(losses))
        if use_dp:  # global sums already; rank 0's values decide for every rank
            mean_loss, coverage = mesh.agree([mean_loss, coverage])

        if not np.isfinite(mean_loss):
            raise FloatingPointError(
                f"Non-finite training loss at epoch {ep}; check data scaling and lr."
            )
        if mask_total > 0 and coverage <= 0.0:
            # non-finite parameters mask out every element, so the masked
            # loss is an exactly finite 0.0: zero coverage on non-empty data
            # means the model has diverged
            raise FloatingPointError(
                f"Training mask coverage collapsed to 0 at epoch {ep}: the "
                "model has diverged (non-finite rate/dispersion); lower the "
                "lr or raise min_sigma."
            )
        step_regions = trace.step_regions()  # the traced epoch's steps, before its evaluation
        eval_params = state.ema if ema_decay > 0.0 else state.params
        t_eval = time.perf_counter()
        if use_resident:
            metrics = engine.evaluate_resident(
                eval_params, staged_val, val_idx, val_rv,
                max_dispatch_steps=resident_max_dispatch,
            )
        else:
            metrics = engine.evaluate(eval_params, (to_device(vb) for vb in dl_val))
        val_nll = float(metrics["nll"])
        val_smape = float(metrics["smape"])
        if use_dp:
            val_nll, val_smape = mesh.agree([val_nll, val_smape])
        for key, value in (("seconds", epoch_time), ("probe_seconds", t_probe - t0),
                           ("eval_seconds", time.perf_counter() - t_eval),
                           ("frozen", engine.cfg.frozen_periods is not None),
                           ("loss", mean_loss), ("val_nll", val_nll),
                           ("val_smape", val_smape)):
            history[key].append(value)
        _log(f"Epoch {ep} loss={mean_loss:.6f} val_nll={val_nll:.6f} "
             f"val_smape={val_smape:.6f} lr={lr:.3e} mask_cov={coverage:.4f} "
             f"windows/s={throughput:.1f} seconds={epoch_time:.3f}{step_regions}")
        if debug_memory and ep == start_epoch:
            _log_device_memory(f"epoch {ep}", device)
        written = trace.stop(os.path.join(str(profile_dir), f"torch_trace_epoch{ep}.json")
                             if profile_dir and mesh.is_main() else None)
        if written:
            _log(f"Profiler trace written to {written}")
        sel_value = val_nll if selection_metric == "nll" else val_smape
        lr_ctl.observe(sel_value)
        if sel_value < best_sel:
            best_sel = sel_value
            best_nll = val_nll
            best_smape = val_smape
            best_wsmape = wsmape_from_series_sums(
                metrics["series_sums"], metrics["series_cnts"], ids
            )
            best_params = {k: v.detach().clone() for k, v in eval_params.items()}
            best_epoch = ep
            best_frozen_spec = frozen_state["spec"]
            patience = 0
        else:
            patience += 1
            if patience_limit is not None and patience > int(patience_limit):
                _log(f"Early stopping at epoch {ep}; best epoch was {best_epoch} "
                     f"with val_{selection_metric}={best_sel:.6f} "
                     f"(val_nll={best_nll:.6f}, val_smape={best_smape:.6f})")
                break
        if epoch_hook is not None and mesh.agree([float(epoch_hook(ep, float(sel_value)))])[0]:
            _log(f"Pruned at epoch {ep} by the tuner (val_{selection_metric}={sel_value:.6f})")
            break
        if save_state_enabled:
            if best_params is not None and best_epoch == ep:
                whole = mesh.host_fetch(best_params, sharded)
                if mesh.is_main():
                    artifacts_io.save_checkpoint(
                        model_path,
                        convert.params_to_jax(whole, tn_cfg),
                        _checkpoint_aux(min_sigma_scalar, sigma_vector),
                    )
            artifacts_io.save_train_state(
                train_state_path,
                state,
                {
                    "epoch": ep,
                    "best_nll": best_nll,
                    "best_smape": best_smape,
                    "best_wsmape": best_wsmape,
                    "best_sel": best_sel,
                    "best_epoch": best_epoch,
                    "patience": patience,
                    "lr_state": lr_ctl.state_dict(),
                    # the spec active at the best snapshot ([] = dynamic)
                    "best_frozen_spec": (
                        _spec_lists(best_frozen_spec) if best_frozen_spec is not None else []
                    ),
                },
                sharded,
            )
            mesh.barrier()

    _log(f"Best epoch {best_epoch} with val_nll={best_nll:.6f} "
         f"(val_smape={best_smape:.6f}, val_wsmape={best_wsmape:.6f})")
    if best_params is None:
        best_params = state.ema if ema_decay > 0.0 else state.params
        best_frozen_spec = frozen_state["spec"]
    best_params = mesh.host_fetch(best_params, sharded)  # the whole table on every rank

    # --------------------------------------------------------------- artifacts
    # rank 0 writes them; the others wait at the barrier below
    t_artifacts = time.perf_counter()
    main = mesh.is_main()
    if main:
        os.makedirs(art_dir, exist_ok=True)
        artifacts_io.save_checkpoint(model_path, convert.params_to_jax(best_params, tn_cfg),
                                     _checkpoint_aux(min_sigma_scalar, sigma_vector))
    scaler_path = os.path.join(art_dir, cfg["artifacts"].get("scaler_file", "scaler.pkl"))
    schema_path = os.path.join(art_dir, cfg["artifacts"].get("schema_file", "schema.json"))
    cfg_path = os.path.join(art_dir, cfg["artifacts"].get("config_file", "config_used.yaml"))
    signature_path = os.path.join(art_dir, cfg["artifacts"]["signature_file"])
    metadata_path = os.path.join(art_dir, cfg["artifacts"]["metadata_file"])
    normalization_meta = {
        "method": norm_method,
        "per_series": norm_per_series,
        "eps": eps,
    }
    if freeze_enabled:
        # config_used.yaml describes the checkpoint being shipped, not the
        # last epoch trained
        if best_frozen_spec is not None:
            cfg["train"]["frozen_periods_spec"] = _spec_lists(best_frozen_spec)
        else:
            cfg["train"].pop("frozen_periods_spec", None)
    scaler_payload = {
            "scaler": scaler,
            "method": norm_method,
            "ids": ids,
            "static_features": series_static_np,
            "feature_names": static_feature_names,
            "time_features": time_feature_meta,
    }
    static_feature_dim = static_dim
    metadata_artifact = metadata_utils.MetadataArtifact.from_training(
        window=window_cfg,
        schema=schema,
        time_features=time_feature_meta,
        static_features={
            "feature_names": list(static_feature_names or []),
            "feature_dim": static_feature_dim,
        },
    )

    signature_payload = {
        "signature_version": 1,
        "window": window_cfg.to_dict(),
        "model": {
            "mode": str(cfg["model"]["mode"]),
            "d_model": int(cfg["model"]["d_model"]),
            "d_ff": int(cfg["model"]["d_ff"]),
            "n_layers": int(cfg["model"]["n_layers"]),
            "k_periods": int(cfg["model"]["k_periods"]),
            "min_period_threshold": int(cfg["model"].get("min_period_threshold", 1)),
            "id_embed_dim": int(cfg["model"].get("id_embed_dim", 32)),
            "static_proj_dim": pipeline_cfg.model.static_proj_dim,
        },
        "train": {
            "batch_size": batch_size,
            "channels_last": bool(cfg["train"].get("channels_last", False)),
            "use_checkpoint": bool(cfg["train"].get("use_checkpoint", False)),
            "min_sigma_effective": float(min_sigma_scalar),
            "min_sigma_method": min_sigma_method,
            "min_sigma_scale": float(min_sigma_scale),
        },
        "data": {
            "num_series": len(ids),
            "static_feature_dim": static_feature_dim,
            "time_feature_dim": int(time_feature_dim),
            "time_features_enabled": bool(time_features_enabled and time_feature_dim > 0),
            "time_feature_freq": inferred_freq,
        },
        "preprocess": {
            **normalization_meta,
            "schema_artifact_version": artifacts_io.SCHEMA_ARTIFACT_VERSION,
        },
    }
    if main:
        artifacts_io.save_pickle(scaler_payload, scaler_path)
        artifacts_io.save_schema_artifact(
            schema_path,
            schema,
            normalization=normalization_meta,
            extras={"time_features": time_feature_meta},
        )
        save_yaml(cfg, cfg_path)
        metadata_utils.save_metadata_artifact(metadata_artifact, metadata_path)
        metadata_utils.save_json(signature_payload, signature_path)
    mesh.barrier()  # the files exist when any rank returns
    t_end = time.perf_counter()
    _log(f"Saved: {model_path}, {scaler_path}, {schema_path}, {cfg_path}, "
         f"{signature_path}, {metadata_path}")
    return best_nll, {
        "model": model_path,
        "scaler": scaler_path,
        "schema": schema_path,
        "config": cfg_path,
        "signature": signature_path,
        "metadata": metadata_path,
        "metrics": {"nll": best_nll, "smape": best_smape, "wsmape": best_wsmape,
                    "epoch_windows_per_s": epoch_throughputs,
                    **{f"epoch_{k}": v for k, v in history.items()}, "best_epoch": best_epoch,
                    "input_pipeline": cfg["train"]["input_pipeline_effective"],
                    # host seconds around the epochs: reading, pivoting and
                    # staging the data and building the model; the loop less
                    # its epochs and evaluations; writing the artifacts
                    "setup_seconds": t_loop - t_start,
                    "between_epochs_seconds": (t_artifacts - t_loop - sum(history["seconds"])
                                               - sum(history["eval_seconds"])),
                    "artifact_seconds": t_end - t_artifacts,
                    "frozen_periods_spec": cfg["train"].get("frozen_periods_spec")},
    }


def _checkpoint_aux(min_sigma_scalar: float, sigma_vector: Optional[np.ndarray]) -> Dict[str, Any]:
    aux: Dict[str, Any] = {"min_sigma_effective": np.float32(min_sigma_scalar)}
    if sigma_vector is not None:
        aux["min_sigma_vector"] = sigma_vector.reshape(1, 1, -1)
    return aux

