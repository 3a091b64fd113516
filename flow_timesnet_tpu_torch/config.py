"""Typed pipeline configuration (counterpart of ``flow_timesnet_tpu/config.py``).

A copy of the JAX package's ``PipelineConfig`` and its typed sections
(``window``, ``model``, ``data`` with ``data.time_features``, ``train`` with
``train.val``), dotted overrides and cross-section validation. The YAML
files are read and written by ``utils/yaml_subset.py`` in place of PyYAML,
with PyYAML's ``safe_load`` resolution of plain scalars, so a config reads
to the same mapping in both packages and a written ``config_used.yaml``
reads back to the mapping it was written from.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from .utils import yaml_subset


# ---------------------------------------------------------------------------
# YAML + dotted-override helpers
# ---------------------------------------------------------------------------


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return yaml_subset.loads(f.read())


def save_yaml(obj: Mapping[str, Any], path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(yaml_subset.dumps(dict(obj)))


def _parse_scalar(text: str) -> Any:
    """Parse an override value using YAML scalar rules (bool/int/float/null)."""

    try:
        return yaml_subset.loads(text)
    except Exception:
        return text


def apply_overrides(cfg: Mapping[str, Any], overrides: Iterable[str]) -> Dict[str, Any]:
    """Apply dotted ``a.b.c=value`` overrides onto a nested mapping copy."""

    out: Dict[str, Any] = copy.deepcopy(dict(cfg))
    for item in overrides or []:
        if "=" not in item:
            continue
        key, raw = item.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for part in parts[:-1]:
            child = node.get(part)
            if not isinstance(child, dict):
                child = {}
                node[part] = child
            node = child
        node[parts[-1]] = _parse_scalar(raw.strip())
    return out


# ---------------------------------------------------------------------------
# Field coercion machinery
# ---------------------------------------------------------------------------


def _as_opt_int(v: Any) -> Optional[int]:
    return None if v is None else int(v)


def _as_bool(v: Any) -> bool:
    return bool(v)


def _as_str(v: Any) -> str:
    return str(v)


def _as_float(v: Any) -> float:
    return float(v)


def _as_int(v: Any) -> int:
    return int(v)


DEFAULT_TIME_FEATURES: Tuple[str, ...] = (
    "day_of_week",
    "day_of_month",
    "month",
    "day_of_year",
)


@dataclass(frozen=True)
class TimeFeatureConfig:
    """Calendar covariate configuration (``data.time_features``)."""

    enabled: bool = False
    features: Tuple[str, ...] = DEFAULT_TIME_FEATURES
    encoding: Any = "cyclical"
    normalize: bool = True
    freq: Optional[str] = None
    feature_dim: Optional[int] = None

    @classmethod
    def from_mapping(cls, mapping: Mapping[str, Any] | None) -> "TimeFeatureConfig":
        data = dict(mapping or {})
        enabled = bool(data.get("enabled", False))
        feats = data.get("features")
        if enabled and (not isinstance(feats, (list, tuple)) or not feats):
            raise ValueError(
                "data.time_features.features must be a non-empty list when enabled is true"
            )
        if isinstance(feats, (list, tuple)) and feats:
            features = tuple(str(f) for f in feats)
        else:
            features = DEFAULT_TIME_FEATURES
        return cls(
            enabled=enabled,
            features=features,
            encoding=data.get("encoding", "cyclical"),
            normalize=bool(data.get("normalize", True)),
            freq=data.get("freq"),
            feature_dim=_as_opt_int(data.get("feature_dim")),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "enabled": self.enabled,
            "features": list(self.features),
            "encoding": self.encoding,
            "normalize": self.normalize,
        }
        if self.freq is not None:
            out["freq"] = self.freq
        if self.feature_dim is not None:
            out["feature_dim"] = int(self.feature_dim)
        return out


@dataclass(frozen=True)
class WindowConfig:
    """Sliding window spec shared by training and inference."""

    input_len: int
    pred_len: int
    stride: int = 1
    short_series_strategy: str = "error"  # error | repeat | pad
    pad_value: float = 0.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "input_len", int(self.input_len))
        object.__setattr__(self, "pred_len", int(self.pred_len))
        object.__setattr__(self, "stride", max(1, int(self.stride)))
        strategy = str(self.short_series_strategy).lower()
        if strategy not in {"error", "repeat", "pad"}:
            raise ValueError(
                "window.short_series_strategy must be one of {'error', 'repeat', 'pad'}"
            )
        object.__setattr__(self, "short_series_strategy", strategy)
        object.__setattr__(self, "pad_value", float(self.pad_value))

    @property
    def total_length(self) -> int:
        return self.input_len + self.pred_len

    def to_dict(self) -> Dict[str, Any]:
        return {
            "input_len": self.input_len,
            "pred_len": self.pred_len,
            "stride": self.stride,
            "short_series_strategy": self.short_series_strategy,
            "pad_value": self.pad_value,
        }


@dataclass(frozen=True)
class ModelConfig:
    mode: str = "direct"
    d_model: int = 128
    d_ff: int = 512
    n_layers: int = 2
    k_periods: int = 2
    min_period_threshold: int = 1
    kernel_set: Tuple[Tuple[int, int], ...] = ((3, 3), (5, 5), (7, 7))
    dropout: float = 0.1
    activation: str = "gelu"
    bottleneck_ratio: float = 1.0
    use_embedding_norm: bool = True
    embed_norm_mode: Optional[str] = None
    id_embed_dim: int = 32
    static_proj_dim: Optional[int] = 32
    static_layernorm: bool = True
    use_zero_mean_context: bool = False
    context_rank: int = 0
    context_scale: float = 1e-2
    use_constant_context_bias: bool = False
    use_late_bias_head: bool = True
    period_max_unique: Any = None  # int | per-depth str schedule | None
    period_binning: Any = None  # log base | per-depth str schedule | None
    compute_dtype: str = "float32"  # float32 | bfloat16
    period_buckets: Any = None  # None | "auto" | cap list: bucketed fold programs
    period_cap: Any = None  # static max considered period (None = input_len)

    @classmethod
    def from_mapping(cls, mapping: Mapping[str, Any]) -> "ModelConfig":
        data = dict(mapping or {})
        mode = str(data.get("mode", "direct"))
        if mode not in {"direct", "recursive"}:
            raise ValueError("model.mode must be one of {'direct', 'recursive'}")
        d_model = int(data.get("d_model", 128))
        d_ff = int(data.get("d_ff", 4 * d_model))
        kernel_raw = data.get("kernel_set", data.get("inception_kernel_set"))
        if kernel_raw is None:
            kernel_raw = [(3, 3), (5, 5), (7, 7)]
        kernel_set = normalize_kernel_set(kernel_raw)
        static_proj_raw = data.get("static_proj_dim", 32)
        static_proj = None if static_proj_raw in {None, "null"} else int(static_proj_raw)
        return cls(
            mode=mode,
            d_model=d_model,
            d_ff=d_ff,
            n_layers=int(data.get("n_layers", 2)),
            k_periods=int(data.get("k_periods", 2)),
            min_period_threshold=int(data.get("min_period_threshold", 1)),
            kernel_set=kernel_set,
            dropout=float(data.get("dropout", 0.1)),
            activation=str(data.get("activation", "gelu")),
            bottleneck_ratio=float(data.get("bottleneck_ratio", 1.0)),
            use_embedding_norm=bool(data.get("use_embedding_norm", True)),
            embed_norm_mode=data.get("embed_norm_mode"),
            id_embed_dim=int(data.get("id_embed_dim", 32)),
            static_proj_dim=static_proj,
            static_layernorm=bool(data.get("static_layernorm", True)),
            use_zero_mean_context=bool(data.get("use_zero_mean_context", False)),
            context_rank=max(0, int(data.get("context_rank", 0))),
            context_scale=float(data.get("context_scale", 1e-2)),
            use_constant_context_bias=bool(data.get("use_constant_context_bias", False)),
            use_late_bias_head=bool(data.get("use_late_bias_head", True)),
            period_max_unique=data.get("period_max_unique"),
            period_binning=data.get("period_binning"),
            compute_dtype=str(data.get("compute_dtype", "float32")),
            period_buckets=data.get("period_buckets"),
            period_cap=data.get("period_cap"),
        )

    def to_dict(self, window: WindowConfig) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "input_len": window.input_len,
            "pred_len": window.pred_len,
            "d_model": self.d_model,
            "d_ff": self.d_ff,
            "n_layers": self.n_layers,
            "k_periods": self.k_periods,
            "min_period_threshold": self.min_period_threshold,
            "kernel_set": [list(k) for k in self.kernel_set],
            "dropout": self.dropout,
            "activation": self.activation,
            "bottleneck_ratio": self.bottleneck_ratio,
            "use_embedding_norm": self.use_embedding_norm,
            "id_embed_dim": self.id_embed_dim,
            "static_proj_dim": self.static_proj_dim,
            "static_layernorm": self.static_layernorm,
            "use_zero_mean_context": self.use_zero_mean_context,
            "context_rank": self.context_rank,
            "context_scale": self.context_scale,
            "use_constant_context_bias": self.use_constant_context_bias,
            "use_late_bias_head": self.use_late_bias_head,
            "period_max_unique": self.period_max_unique,
            "period_binning": self.period_binning,
            "compute_dtype": self.compute_dtype,
            "period_buckets": self.period_buckets,
            "period_cap": self.period_cap,
        }


def normalize_kernel_set(kernel_set: Any) -> Tuple[Tuple[int, int], ...]:
    """Coerce a kernel-set spec into ``((kh, kw), ...)`` pairs.

    Accepts ints (square kernels) and 2-element sequences, matching the
    reference's parsing in ``models/timesnet.py:609-621``.
    """

    if isinstance(kernel_set, tuple):
        kernel_set = list(kernel_set)
    if not isinstance(kernel_set, list) or not kernel_set:
        raise ValueError("model.kernel_set must be a non-empty list of kernel specs")
    parsed: List[Tuple[int, int]] = []
    for k in kernel_set:
        if isinstance(k, (list, tuple)):
            if len(k) != 2:
                raise ValueError("kernel_set entries must be (kh, kw) pairs")
            kh, kw = k
        else:
            kh = kw = int(k)
        parsed.append((int(kh), int(kw)))
    return tuple(parsed)


@dataclass(frozen=True)
class DataConfig:
    train_csv: str = ""
    test_dir: str = ""
    sample_submission: str = ""
    date_col: str = "date"
    target_col: str = "target"
    id_col: str = "id"
    min_context_days: Optional[int] = None
    horizon: Optional[int] = None
    fill_missing_dates: bool = True
    encoding: str = "utf-8"
    schema_detection_policy: str = "infer"
    schema_evolution_policy: str = "warn"
    time_features: TimeFeatureConfig = field(default_factory=TimeFeatureConfig)

    _SPEC = {
        "train_csv": _as_str,
        "test_dir": _as_str,
        "sample_submission": _as_str,
        "date_col": _as_str,
        "target_col": _as_str,
        "id_col": _as_str,
        "min_context_days": _as_opt_int,
        "horizon": _as_opt_int,
        "fill_missing_dates": _as_bool,
        "encoding": _as_str,
        "schema_detection_policy": _as_str,
        "schema_evolution_policy": _as_str,
    }

    @classmethod
    def from_mapping(cls, mapping: Mapping[str, Any]) -> "DataConfig":
        data = dict(mapping or {})
        kwargs: Dict[str, Any] = {}
        defaults = {f.name: f for f in fields(cls)}
        for name, coerce in cls._SPEC.items():
            if name in data and data[name] is not None:
                kwargs[name] = coerce(data[name])
            elif name in data:  # explicit null
                kwargs[name] = None if defaults[name].default is None else data[name]
        kwargs["time_features"] = TimeFeatureConfig.from_mapping(data.get("time_features"))
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "train_csv": self.train_csv,
            "test_dir": self.test_dir,
            "sample_submission": self.sample_submission,
            "date_col": self.date_col,
            "target_col": self.target_col,
            "id_col": self.id_col,
            "min_context_days": self.min_context_days,
            "horizon": self.horizon,
            "fill_missing_dates": self.fill_missing_dates,
            "encoding": self.encoding,
            "schema_detection_policy": self.schema_detection_policy,
            "schema_evolution_policy": self.schema_evolution_policy,
            "time_features": self.time_features.to_dict(),
        }


@dataclass(frozen=True)
class TrainConfig:
    device: str = "tpu"  # the JAX default; the port runs on the card for all but "cpu"
    epochs: int = 1
    batch_size: int = 1
    accumulation_steps: int = 1
    lr_warmup_steps: int = 0
    lr: float = 1e-3
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    early_stopping_patience: Optional[int] = None
    amp: bool = False  # retained for config compat; bf16 is model.compute_dtype
    compile: bool = False  # retained for config compat
    deterministic: bool = False
    cuda_graphs: bool = False  # retained for config compat; the card always replays graphs
    use_checkpoint: bool = False  # activation rematerialisation
    min_sigma: float = 1e-3
    min_sigma_method: str = "global"
    min_sigma_scale: float = 0.1
    matmul_precision: str = "medium"
    num_workers: int = 0  # retained for config compat; host pipeline is in-process
    pin_memory: bool = False
    persistent_workers: bool = False
    prefetch_factor: int = 2
    channels_last: bool = False  # retained for config compat
    use_loss_masking: bool = False
    dcn_slices: int = 1  # multi-slice data parallelism: the world must split into this many
    shard_embedding: str = "auto"  # auto|true|false: row-shard the id table
    val_strategy: str = "holdout"
    val_holdout_days: Optional[int] = None
    val_rolling_folds: Optional[int] = None
    val_rolling_step_days: Optional[int] = None

    _SPEC = {
        "device": _as_str,
        "epochs": _as_int,
        "accumulation_steps": lambda v: max(1, int(v)),
        "batch_size": lambda v: max(1, int(v)),
        "lr_warmup_steps": _as_int,
        "lr": _as_float,
        "weight_decay": _as_float,
        "grad_clip_norm": _as_float,
        "early_stopping_patience": _as_opt_int,
        "amp": _as_bool,
        "compile": _as_bool,
        "deterministic": _as_bool,
        "cuda_graphs": _as_bool,
        "use_checkpoint": _as_bool,
        "min_sigma": _as_float,
        "min_sigma_method": _as_str,
        "min_sigma_scale": _as_float,
        "matmul_precision": _as_str,
        "num_workers": _as_int,
        "pin_memory": _as_bool,
        "persistent_workers": _as_bool,
        "prefetch_factor": _as_int,
        "channels_last": _as_bool,
        "use_loss_masking": _as_bool,
        "dcn_slices": lambda v: max(1, int(v)),
        "shard_embedding": lambda v: str(v).lower(),
    }

    @classmethod
    def from_mapping(cls, mapping: Mapping[str, Any]) -> "TrainConfig":
        data = dict(mapping or {})
        kwargs: Dict[str, Any] = {}
        for name, coerce in cls._SPEC.items():
            if name in data and data[name] is not None:
                kwargs[name] = coerce(data[name])
        val = dict(data.get("val") or {})
        kwargs["val_strategy"] = str(val.get("strategy", "holdout"))
        kwargs["val_holdout_days"] = _as_opt_int(val.get("holdout_days"))
        kwargs["val_rolling_folds"] = _as_opt_int(val.get("rolling_folds"))
        kwargs["val_rolling_step_days"] = _as_opt_int(val.get("rolling_step_days"))
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        out = {name: getattr(self, name) for name in self._SPEC}
        out["val"] = {
            "strategy": self.val_strategy,
            "holdout_days": self.val_holdout_days,
            "rolling_folds": self.val_rolling_folds,
            "rolling_step_days": self.val_rolling_step_days,
        }
        return out


def _extract_window(base: Dict[str, Any]) -> WindowConfig:
    """Reconcile ``window.*`` with legacy ``model.input_len/pred_len`` keys.

    Mirrors the reference's ``_extract_window`` semantics
    (``config.py:413-433``): window section wins, model section is the
    fallback, and both are rewritten to the resolved values.
    """

    window_raw = dict(base.get("window") or {})
    model_raw = base.setdefault("model", {})
    input_len = window_raw.get("input_len", model_raw.get("input_len"))
    pred_len = window_raw.get("pred_len", model_raw.get("pred_len"))
    if input_len is None or pred_len is None:
        raise ValueError("Configuration must specify model.input_len and model.pred_len")
    window = WindowConfig(
        input_len=int(input_len),
        pred_len=int(pred_len),
        stride=int(window_raw.get("stride", window_raw.get("step", 1))),
        short_series_strategy=window_raw.get("short_series_strategy", "error"),
        pad_value=float(window_raw.get("pad_value", 0.0)),
    )
    base.setdefault("window", {}).update(window.to_dict())
    model_raw["input_len"] = window.input_len
    model_raw["pred_len"] = window.pred_len
    return window


@dataclass(frozen=True)
class PipelineConfig:
    """Normalised full-pipeline configuration with cross-section validation."""

    raw: Dict[str, Any]
    window: WindowConfig
    model: ModelConfig
    data: DataConfig
    train: TrainConfig

    @classmethod
    def from_files(
        cls, config_path: str, overrides: Iterable[str] | None = None
    ) -> "PipelineConfig":
        base = load_yaml(config_path)
        if overrides:
            base = apply_overrides(base, overrides)
        return cls.from_mapping(base)

    @classmethod
    def from_mapping(cls, mapping: Mapping[str, Any]) -> "PipelineConfig":
        base = copy.deepcopy(dict(mapping))
        model_section = base.setdefault("model", {})
        if "inception_kernel_set" in model_section and "kernel_set" not in model_section:
            model_section["kernel_set"] = model_section.pop("inception_kernel_set")
        model_section.setdefault("id_embed_dim", 32)
        model_section.setdefault("static_proj_dim", None)
        model_section.setdefault("static_layernorm", True)
        artifacts = base.setdefault("artifacts", {})
        artifacts.setdefault("signature_file", "model_signature.json")
        artifacts.setdefault("metadata_file", "metadata.json")
        window = _extract_window(base)
        model = ModelConfig.from_mapping(base.get("model", {}))
        data = DataConfig.from_mapping(base.get("data", {}))
        train = TrainConfig.from_mapping(base.get("train", {}))
        # always rewrite with the normalised dict, so artifacts store canonical settings
        base.setdefault("data", {})["time_features"] = data.time_features.to_dict()
        instance = cls(raw=base, window=window, model=model, data=data, train=train)
        instance.validate()
        return instance

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.raw)

    def apply_overrides(self, overrides: Iterable[str]) -> "PipelineConfig":
        if not overrides:
            return self
        return PipelineConfig.from_mapping(apply_overrides(self.raw, overrides))

    def validate(self) -> None:
        """Cross-section validation (mirrors reference ``config.py:489-528``)."""

        problems: List[str] = []
        if self.window.input_len <= 0:
            problems.append("window.input_len must be positive")
        if self.window.pred_len <= 0:
            problems.append("window.pred_len must be positive")
        if self.window.stride <= 0:
            problems.append("window.stride must be positive")
        if self.model.min_period_threshold > self.window.input_len:
            problems.append("model.min_period_threshold cannot exceed window.input_len")
        if (
            self.data.min_context_days is not None
            and self.data.min_context_days < self.window.input_len
        ):
            problems.append(
                "data.min_context_days must be at least window.input_len to ensure sufficient history"
            )
        if self.data.horizon is not None and self.data.horizon < self.window.pred_len:
            problems.append("data.horizon must be at least window.pred_len to cover the forecast horizon")
        if self.train.val_strategy in {"holdout", "rolling"}:
            if self.train.val_holdout_days is None:
                problems.append(
                    "train.val.holdout_days must be specified for holdout/rolling validation"
                )
            elif self.train.val_holdout_days < self.window.total_length:
                problems.append(
                    "train.val.holdout_days must be >= window.input_len + window.pred_len"
                )
        if self.train.batch_size <= 0:
            problems.append("train.batch_size must be positive")
        if self.model.compute_dtype not in {"float32", "bfloat16"}:
            problems.append("model.compute_dtype must be 'float32' or 'bfloat16'")
        if problems:
            raise ValueError(
                "Configuration validation failed with the following issues:\n"
                + "\n".join(f"- {p}" for p in problems)
            )

    def describe(self) -> str:
        payload = {
            "window": self.window.to_dict(),
            "model": self.model.to_dict(self.window),
            "data": self.data.to_dict(),
            "train": self.train.to_dict(),
        }
        return yaml_subset.dumps(payload)


# Backwards-compatible alias (the reference exports ``Config`` too).
Config = PipelineConfig
