"""Versioned metadata artifact bridging train -> predict (a copy of
``flow_timesnet_tpu/utils/metadata.py``, which imports no framework).

``meta_version`` "1" with window / schema / time_features / static_features
sections, a legacy ("0") migration, config-compatibility validation and
artifact cross-checks; ``save_json`` / ``load_json`` write and read the
JSON artifacts (``metadata.json``, ``model_signature.json``,
``schema.json``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Mapping, Sequence

import numpy as np

METADATA_ARTIFACT_VERSION = "1"
SUPPORTED_METADATA_VERSIONS: tuple = (METADATA_ARTIFACT_VERSION,)


def save_json(obj: Mapping[str, Any], path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=2)


def load_json(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _normalise_time_config(config: Mapping[str, Any]) -> Dict[str, Any]:
    out = {
        "enabled": bool(config.get("enabled", False)),
        "features": [str(f) for f in config.get("features", [])],
        "encoding": str(config.get("encoding", "cyclical")),
        "normalize": bool(config.get("normalize", True)),
    }
    if config.get("freq") is not None:
        out["freq"] = str(config["freq"])
    if config.get("feature_dim") is not None:
        out["feature_dim"] = int(config["feature_dim"])
    return out


def _coerce_window(obj: Mapping[str, Any]) -> Dict[str, Any]:
    missing = [k for k in ("input_len", "pred_len") if k not in obj]
    if missing:
        raise ValueError(
            "Metadata artifact window section missing keys: " + ", ".join(sorted(missing))
        )
    return {
        "input_len": int(obj["input_len"]),
        "pred_len": int(obj["pred_len"]),
        "stride": int(obj.get("stride", 1)),
        "short_series_strategy": str(obj.get("short_series_strategy", "error")).lower(),
        "pad_value": float(obj.get("pad_value", 0.0)),
    }


def _coerce_schema(obj: Mapping[str, Any]) -> Dict[str, str]:
    missing = [k for k in ("date", "id", "target") if k not in obj]
    if missing:
        raise ValueError(
            "Metadata artifact schema section missing keys: " + ", ".join(sorted(missing))
        )
    return {k: str(obj[k]) for k in ("date", "id", "target")}


def _coerce_time_features(obj: Mapping[str, Any]) -> Dict[str, Any]:
    config = _normalise_time_config(obj.get("config") if isinstance(obj.get("config"), Mapping) else {})
    enabled = bool(obj.get("enabled", config.get("enabled", False)))
    feature_dim = int(obj.get("feature_dim", config.get("feature_dim", 0)) or 0)
    payload: Dict[str, Any] = {
        "config": config,
        "enabled": enabled,
        "feature_dim": feature_dim,
    }
    freq = obj.get("freq", config.get("freq"))
    if freq is not None:
        payload["freq"] = str(freq)
    return payload


def _coerce_static_features(obj: Mapping[str, Any] | None) -> Dict[str, Any]:
    if obj is None:
        return {"feature_names": [], "feature_dim": 0}
    names_raw = obj.get("feature_names")
    if isinstance(names_raw, Iterable) and not isinstance(names_raw, str):
        names = [str(n) for n in names_raw]
    else:
        names = []
    dim = obj.get("feature_dim")
    if dim is None and names:
        dim = len(names)
    return {"feature_names": names, "feature_dim": int(dim or 0)}


def _upgrade_legacy(payload: Mapping[str, Any]) -> Dict[str, Any]:
    """Migrate a version-"0" payload (flat time/static sections) to "1"."""

    upgraded: Dict[str, Any] = dict(payload)
    tf = upgraded.get("time_features")
    if isinstance(tf, Mapping):
        config = dict(tf.get("config") or {})
        if "enabled" not in config and "enabled" in tf:
            config.setdefault("enabled", bool(tf["enabled"]))
        if tf.get("freq") is not None:
            config.setdefault("freq", tf.get("freq"))
        if tf.get("feature_dim") is not None:
            config.setdefault("feature_dim", tf.get("feature_dim"))
        upgraded["time_features"] = {
            "config": config,
            "enabled": bool(tf.get("enabled", config.get("enabled", False))),
            "feature_dim": int(tf.get("feature_dim", config.get("feature_dim", 0)) or 0),
        }
        if tf.get("freq") is not None:
            upgraded["time_features"]["freq"] = tf.get("freq")
    sf = upgraded.get("static_features")
    if isinstance(sf, Sequence) and not isinstance(sf, Mapping):
        names = [str(n) for n in sf]
        upgraded["static_features"] = {"feature_names": names, "feature_dim": len(names)}
    upgraded["meta_version"] = METADATA_ARTIFACT_VERSION
    return upgraded


METADATA_MIGRATIONS: Dict[str, Callable[[Mapping[str, Any]], Dict[str, Any]]] = {
    "0": _upgrade_legacy,
}


@dataclass
class MetadataArtifact:
    meta_version: str
    window: Dict[str, Any]
    schema: Dict[str, str]
    time_features: Dict[str, Any]
    static_features: Dict[str, Any]

    @classmethod
    def from_training(
        cls,
        *,
        window: Any,
        schema: Any,
        time_features: Mapping[str, Any],
        static_features: Mapping[str, Any] | None,
    ) -> "MetadataArtifact":
        window_dict = window.to_dict() if hasattr(window, "to_dict") else dict(window)
        return cls(
            meta_version=METADATA_ARTIFACT_VERSION,
            window=_coerce_window(window_dict),
            schema=_coerce_schema(schema.as_dict()),
            time_features=_coerce_time_features(time_features),
            static_features=_coerce_static_features(static_features),
        )

    @classmethod
    def from_payload(cls, payload: Mapping[str, Any]) -> "MetadataArtifact":
        def section(name: str) -> Dict[str, Any]:
            value = payload.get(name)
            if not isinstance(value, Mapping):
                raise ValueError(f"Metadata artifact missing '{name}' object")
            return dict(value)

        return cls(
            meta_version=str(payload.get("meta_version", "")),
            window=_coerce_window(section("window")),
            schema=_coerce_schema(section("schema")),
            time_features=_coerce_time_features(section("time_features")),
            static_features=_coerce_static_features(section("static_features")),
        )

    def to_payload(self) -> Dict[str, Any]:
        return {
            "meta_version": self.meta_version,
            "window": dict(self.window),
            "schema": dict(self.schema),
            "time_features": dict(self.time_features),
            "static_features": dict(self.static_features),
        }

    # -- validation ---------------------------------------------------------

    def validate_config(self, cfg) -> None:
        """Fail fast on window/schema/time-feature drift vs a PipelineConfig."""

        errors = []

        def check(label: str, configured, stored) -> None:
            if configured != stored:
                errors.append(f"{label}={configured!r} differs from metadata value {stored!r}")

        check("window.input_len", cfg.window.input_len, int(self.window["input_len"]))
        check("window.pred_len", cfg.window.pred_len, int(self.window["pred_len"]))
        check("window.stride", cfg.window.stride, int(self.window.get("stride", cfg.window.stride)))
        check(
            "window.short_series_strategy",
            cfg.window.short_series_strategy,
            str(self.window.get("short_series_strategy", "error")),
        )
        check("data.date_col", cfg.data.date_col, self.schema["date"])
        check("data.id_col", cfg.data.id_col, self.schema["id"])
        check("data.target_col", cfg.data.target_col, self.schema["target"])

        cfg_time = _normalise_time_config(cfg.data.time_features.to_dict())
        meta_cfg = _normalise_time_config(self.time_features.get("config", {}))
        check("data.time_features.enabled", bool(cfg_time["enabled"]), bool(self.time_features.get("enabled")))
        check("data.time_features.features", cfg_time["features"], meta_cfg["features"])
        check("data.time_features.encoding", cfg_time["encoding"], meta_cfg["encoding"])
        check("data.time_features.normalize", cfg_time["normalize"], meta_cfg["normalize"])
        meta_freq = self.time_features.get("freq")
        if meta_freq is not None and cfg_time.get("freq") not in {None, meta_freq}:
            errors.append(
                f"data.time_features.freq={cfg_time.get('freq')!r} differs from metadata value {meta_freq!r}"
            )
        cfg_dim = cfg.data.time_features.feature_dim
        if cfg_dim is not None:
            meta_dim = int(self.time_features.get("feature_dim", cfg_dim))
            if int(cfg_dim) != meta_dim:
                errors.append(
                    f"data.time_features.feature_dim={cfg_dim} differs from metadata value {meta_dim}"
                )
        if errors:
            raise ValueError(
                "Configuration incompatible with metadata artifact:\n"
                + "\n".join(f"- {e}" for e in errors)
            )

    def validate_artifacts(
        self,
        *,
        schema,
        scaler_meta: Mapping[str, Any],
        num_series: int | None = None,
    ) -> None:
        """Cross-check the scaler artifact contents against this metadata."""

        errors = []
        for key, expected in self.schema.items():
            actual = schema.as_dict().get(key)
            if actual != expected:
                errors.append(
                    f"Schema column '{key}' stored as '{actual}' but metadata expects '{expected}'"
                )
        expected_dim = int(self.static_features.get("feature_dim", 0))
        expected_names = list(self.static_features.get("feature_names", []))
        scaler_names = scaler_meta.get("feature_names")
        if expected_names:
            if scaler_names is None:
                errors.append(
                    f"Static feature names missing from scaler metadata; expected {expected_names}"
                )
            elif list(scaler_names) != expected_names:
                errors.append(
                    f"Static feature names {list(scaler_names)} differ from metadata value {expected_names}"
                )
        static_arr = scaler_meta.get("static_features")
        static_dim = None
        if static_arr is not None:
            arr = np.asarray(static_arr)
            static_dim = 1 if arr.ndim == 1 else int(arr.shape[1]) if arr.ndim >= 2 else None
        if expected_dim and static_dim is not None and static_dim != expected_dim:
            errors.append(
                f"Static feature dimension {static_dim} differs from metadata value {expected_dim}"
            )
        if expected_dim and static_arr is None:
            errors.append(
                f"Static feature matrix missing from scaler metadata; expected dimension {expected_dim}"
            )
        if num_series is not None and static_arr is not None:
            arr = np.asarray(static_arr)
            if arr.ndim >= 2 and arr.shape[0] not in {num_series, 0}:
                errors.append(
                    f"Static feature row count {arr.shape[0]} does not match number of series {num_series}"
                )
        tf = scaler_meta.get("time_features") or {}
        tf_cfg = tf.get("config", {}) if isinstance(tf, Mapping) else {}
        scaler_enabled = bool(tf.get("enabled", tf_cfg.get("enabled", False)))
        scaler_dim = int(tf.get("feature_dim", tf_cfg.get("feature_dim", 0)) or 0)
        scaler_freq = tf.get("freq")
        if bool(self.time_features.get("enabled")) != scaler_enabled:
            errors.append(
                f"Scaler metadata time feature enablement {scaler_enabled} differs from "
                f"metadata value {self.time_features.get('enabled')}"
            )
        meta_dim = int(self.time_features.get("feature_dim", scaler_dim))
        if scaler_dim and meta_dim and scaler_dim != meta_dim:
            errors.append(
                f"Scaler time feature dimension {scaler_dim} differs from metadata value {meta_dim}"
            )
        meta_freq = self.time_features.get("freq")
        if meta_freq is not None and scaler_freq is not None and str(meta_freq) != str(scaler_freq):
            errors.append(
                f"Scaler time feature frequency '{scaler_freq}' differs from metadata value '{meta_freq}'"
            )
        if errors:
            raise ValueError(
                "Stored artifacts incompatible with metadata artifact:\n"
                + "\n".join(f"- {e}" for e in errors)
            )


def save_metadata_artifact(artifact: MetadataArtifact, path: str) -> None:
    save_json(artifact.to_payload(), path)


def load_metadata_artifact(path: str) -> MetadataArtifact:
    payload = load_json(path)
    if not isinstance(payload, dict):
        raise ValueError("Metadata artifact must be a JSON object")
    version = str(payload.get("meta_version", "0"))
    visited = set()
    while version not in SUPPORTED_METADATA_VERSIONS:
        if version in visited:
            raise ValueError(
                f"Metadata artifact migration loop detected for version '{version}'"
            )
        migration = METADATA_MIGRATIONS.get(version)
        if migration is None:
            supported = ", ".join(sorted(SUPPORTED_METADATA_VERSIONS))
            raise ValueError(
                f"Metadata artifact version '{version}' is not supported. "
                f"Supported versions: {supported}"
            )
        visited.add(version)
        payload = migration(payload)
        version = str(payload.get("meta_version", "0"))
    return MetadataArtifact.from_payload(payload)
