"""The port's ``TimesNetConfig`` from a merged pipeline-config mapping
(counterpart of ``flow_timesnet_tpu/build.py``).

One function builds the static model config from the ``cfg`` dict shape
``train_once`` assembles (``model`` merged with ``window``, plus
``train``), so the trainer and ``chip_smoke.py`` derive the model from the
shipped YAML recipes. It builds the port's own
``models/timesnet.py::TimesNetConfig``, which has no ``use_pallas``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

from .models.timesnet import TimesNetConfig


def timesnet_config_from_dict(
    cfg: Mapping[str, Any],
    *,
    static_dim: int,
    time_feature_dim: int,
    id_vocab: int,
    min_sigma: Optional[float] = None,
) -> TimesNetConfig:
    """Build the static model config from a merged pipeline-config mapping.

    ``cfg`` must carry ``model`` (with ``input_len``/``pred_len`` merged in,
    as ``PipelineConfig.model.to_dict(window)`` produces) and optionally
    ``train`` (for ``use_checkpoint``). Data dimensions are explicit: they
    come from the dataset, never the YAML.
    """

    m = dict(cfg.get("model") or {})
    t = dict(cfg.get("train") or {})
    d_model = int(m["d_model"])
    d_ff = int(m.get("d_ff") or 4 * d_model)
    kernel_set = tuple(tuple(int(v) for v in k) for k in m["kernel_set"])
    spd_raw = m.get("static_proj_dim", 32)
    static_proj_dim = None if spd_raw in (None, "null") else int(spd_raw)
    if min_sigma is None:
        min_sigma = float(t.get("min_sigma_effective", t.get("min_sigma", 1e-3)))
    return TimesNetConfig(
        input_len=int(m["input_len"]),
        pred_len=int(m["pred_len"]),
        d_model=d_model,
        d_ff=d_ff,
        n_layers=int(m["n_layers"]),
        k_periods=int(m["k_periods"]),
        kernel_set=kernel_set,
        dropout=float(m["dropout"]),
        activation=str(m["activation"]),
        mode=str(m.get("mode", "direct")),
        bottleneck_ratio=float(m.get("bottleneck_ratio", 1.0)),
        min_period_threshold=int(m.get("min_period_threshold", 1)),
        use_checkpoint=bool(t.get("use_checkpoint", False)),
        use_embedding_norm=bool(m.get("use_embedding_norm", True)),
        embed_norm_mode=m.get("embed_norm_mode"),
        min_sigma=float(min_sigma),
        id_embed_dim=int(m.get("id_embed_dim", 32)),
        static_proj_dim=static_proj_dim,
        static_layernorm=bool(m.get("static_layernorm", True)),
        use_zero_mean_context=bool(m.get("use_zero_mean_context", False)),
        context_rank=max(0, int(m.get("context_rank", 0))),
        context_scale=float(m.get("context_scale", 1e-2)),
        use_constant_context_bias=bool(m.get("use_constant_context_bias", False)),
        use_late_bias_head=bool(m.get("use_late_bias_head", True)),
        c_in=1,
        static_dim=int(static_dim),
        time_features=int(time_feature_dim),
        id_vocab=max(1, int(id_vocab)),
        # the TIMES_PERIOD_* environment knobs; config values take precedence
        period_max_unique=(
            m.get("period_max_unique")
            if m.get("period_max_unique") is not None
            else os.environ.get("TIMES_PERIOD_MAX_UNIQ")
        ),
        period_binning=(
            m.get("period_binning")
            if m.get("period_binning") is not None
            else os.environ.get("TIMES_PERIOD_BINNING")
        ),
        compute_dtype=str(m.get("compute_dtype", "float32")),
        period_buckets=m.get("period_buckets"),
        period_cap=(int(m["period_cap"]) if m.get("period_cap") is not None else None),
    )


def merged_config_from_yaml(path: str, overrides=()) -> Dict[str, Any]:
    """Load a shipped YAML recipe into the merged-dict shape train_once uses."""

    from .config import PipelineConfig

    pipeline_cfg = PipelineConfig.from_files(path, overrides=list(overrides))
    cfg = pipeline_cfg.to_dict()
    window_cfg = pipeline_cfg.window
    cfg.setdefault("window", {}).update(window_cfg.to_dict())
    cfg.setdefault("model", {}).update(pipeline_cfg.model.to_dict(window_cfg))
    return cfg


def time_feature_dim_of(cfg: Mapping[str, Any]) -> int:
    """Feature dim implied by a recipe's ``data.time_features`` section.

    Exact by construction: runs the real extractor on two hourly stamps.
    """

    import numpy as np

    from .data.time_features import build_time_features

    tf = dict((cfg.get("data") or {}).get("time_features") or {})
    if not tf.get("enabled", False):
        return 0
    if tf.get("feature_dim") is not None:
        return int(tf["feature_dim"])
    stamps = np.datetime64("2024-01-01T00", "h") + np.arange(2)
    return int(build_time_features(stamps, tf).shape[1])
