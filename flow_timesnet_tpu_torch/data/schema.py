"""Data schema resolution: (date, id, target) column detection and policies
(counterpart of ``flow_timesnet_tpu/data/schema.py``, over a
:class:`~flow_timesnet_tpu_torch.data.csv_long.LongTable` in place of a
pandas frame).

- roles resolved from explicit overrides first, then from name-candidate
  lists (including the Korean retail columns), then from type heuristics
  (:func:`looks_datetime`, :func:`looks_identifier`, :func:`looks_numeric`
  over numpy arrays, as the JAX package's tests them on pandas columns);
- ``detection_policy`` in {strict, infer, manual}: strict errors on ambiguous
  auto-detection, manual requires all three overrides;
- ``evolution_policy`` in {ignore, warn, error} applied to temporal coverage
  analysis of extra feature columns.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional

import numpy as np

from .csv_long import LongTable, parse_datetimes

logger = logging.getLogger(__name__)

_DATE_NAMES = ["date", "datetime", "timestamp", "ds", "time", "영업일자"]
_ID_NAMES = [
    "id",
    "series",
    "series_id",
    "store_id",
    "store",
    "menu",
    "item",
    "영업장명_메뉴명",
    "영업장명",
]
_TARGET_NAMES = ["target", "value", "sales", "demand", "y", "매출수량", "qty"]

DETECTION_POLICIES = {"strict", "infer", "manual"}
EVOLUTION_POLICIES = {"ignore", "warn", "error"}


def _blank(value: Any) -> bool:
    return value is None or (isinstance(value, str) and not value.strip())


def _coerce_policy(value: Any, allowed: set, default: str, label: str) -> str:
    if _blank(value):
        return default
    policy = str(value).strip().lower()
    if policy not in allowed:
        raise ValueError(f"{label} must be one of {sorted(allowed)}")
    return policy


def _is_text(values: np.ndarray) -> bool:
    return np.asarray(values).dtype.kind in "OUS"


def looks_datetime(values: np.ndarray) -> bool:
    values = np.asarray(values)
    if np.issubdtype(values.dtype, np.datetime64):
        return True
    sample = values[:128]
    if _is_text(sample):
        parsed = parse_datetimes(sample)
        return int((~np.isnat(parsed)).sum()) >= max(1, int(0.6 * len(sample)))
    return False


def looks_identifier(values: np.ndarray) -> bool:
    return _is_text(values)


def looks_numeric(values: np.ndarray) -> bool:
    return np.asarray(values).dtype.kind in "biuf"


def _notna(values: np.ndarray) -> np.ndarray:
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return ~np.isnan(values)
    if values.dtype.kind == "M":
        return ~np.isnat(values)
    if values.dtype.kind == "O":
        return np.array([v is not None and v == v for v in values], dtype=bool)
    return np.ones(values.shape, dtype=bool)


def _iso(stamp: np.datetime64) -> str:
    """``pd.Timestamp.isoformat()`` of a whole-second stamp."""

    return str(stamp.astype("datetime64[s]"))


_ROLE_SPEC = {
    "date": (_DATE_NAMES, looks_datetime, "datetime_like"),
    "id": (_ID_NAMES, looks_identifier, "identifier_like"),
    "target": (_TARGET_NAMES, looks_numeric, "numeric_like"),
}


def _candidates_for(df: LongTable, role: str) -> List[Dict[str, str]]:
    names, predicate, fallback = _ROLE_SPEC[role]
    found: List[Dict[str, str]] = []
    seen: set = set()
    for name in names:
        if name in df.columns and predicate(df[name]):
            found.append({"column": name, "reason": "name_match"})
            seen.add(name)
    for column in df.columns:
        if column not in seen and predicate(df[column]):
            found.append({"column": column, "reason": fallback})
            seen.add(column)
    return found


def extract_schema_overrides(data_cfg: Mapping[str, Any]) -> Dict[str, str]:
    """Pull explicit role→column overrides from ``data.schema`` / ``data.*_col``."""

    overrides: Dict[str, str] = {}
    schema_cfg = data_cfg.get("schema", {}) if isinstance(data_cfg, Mapping) else {}
    if not isinstance(schema_cfg, Mapping):
        schema_cfg = {}
    for role in ("date", "id", "target"):
        explicit = schema_cfg.get(role)
        alt = data_cfg.get(f"{role}_col") if isinstance(data_cfg, Mapping) else None
        value = explicit if not _blank(explicit) else alt
        if not _blank(value):
            overrides[role] = str(value)
    return overrides


@dataclass
class DataSchema:
    """Resolved (date, id, target) columns plus provenance/diagnostics."""

    date_col: str
    id_col: str
    target_col: str
    sources: Dict[str, str] = field(default_factory=dict)
    detection: Dict[str, Any] = field(default_factory=dict)

    def __getitem__(self, role: str) -> str:
        try:
            return {"date": self.date_col, "id": self.id_col, "target": self.target_col}[role]
        except KeyError:
            raise KeyError(role)

    def as_dict(self) -> Dict[str, str]:
        return {"date": self.date_col, "id": self.id_col, "target": self.target_col}

    @classmethod
    def from_config(
        cls,
        data_cfg: Mapping[str, Any],
        sample_df: Optional[LongTable] = None,
        *,
        allow_auto: bool = True,
    ) -> "DataSchema":
        schema_cfg = data_cfg.get("schema") if isinstance(data_cfg, Mapping) else None
        schema_cfg = schema_cfg if isinstance(schema_cfg, Mapping) else {}
        detection_policy = _coerce_policy(
            schema_cfg.get("detection_policy", data_cfg.get("schema_detection_policy")),
            DETECTION_POLICIES,
            "infer",
            "schema_detection_policy",
        )
        evolution_policy = _coerce_policy(
            schema_cfg.get("evolution_policy", data_cfg.get("schema_evolution_policy")),
            EVOLUTION_POLICIES,
            "warn",
            "schema_evolution_policy",
        )
        overrides = extract_schema_overrides(data_cfg)
        auto = allow_auto and detection_policy != "manual"
        if detection_policy == "manual" and len(overrides) < 3:
            raise ValueError(
                "schema_detection_policy='manual' requires explicit date/id/target overrides"
            )
        if sample_df is None and auto and len(overrides) < 3:
            raise ValueError("DataSchema requires a sample dataframe to infer missing fields")

        resolved: Dict[str, str] = {}
        sources: Dict[str, str] = {}
        details: Dict[str, Any] = {}
        used: set = set()

        for role in ("date", "id", "target"):
            if role in overrides:
                column = overrides[role]
                if sample_df is not None and column not in sample_df.columns:
                    raise KeyError(
                        f"Configured {role}_col '{column}' not present in data columns"
                    )
                resolved[role] = column
                sources[role] = "override"
                used.add(column)

        if sample_df is not None and auto:
            for role in ("date", "id", "target"):
                if role in resolved:
                    continue
                candidates = _candidates_for(sample_df, role)
                available = [c for c in candidates if c["column"] not in used]
                if role == "target":
                    available = [
                        c
                        for c in available
                        if c["column"] != resolved.get("date")
                        and c["column"] != resolved.get("id")
                    ]
                if detection_policy == "strict" and len(available) > 1:
                    cols = ", ".join(sorted({c["column"] for c in available}))
                    raise ValueError(
                        f"Ambiguous auto-detection for '{role}' column; candidates: {cols}. "
                        "Provide an explicit override or switch detection policy to 'infer'."
                    )
                if available:
                    choice = available[0]
                    resolved[role] = choice["column"]
                    sources[role] = choice["reason"]
                    used.add(choice["column"])
                    details[role] = {
                        "reason": choice["reason"],
                        "candidates": candidates,
                        "available_candidates": available,
                    }

        missing = [r for r in ("date", "id", "target") if r not in resolved]
        if missing:
            raise ValueError(
                f"Unable to determine column for '{missing[0]}'. "
                f"Provide an override via data.{missing[0]}_col"
            )

        details["policies"] = {"detection": detection_policy, "evolution": evolution_policy}
        schema = cls(
            date_col=resolved["date"],
            id_col=resolved["id"],
            target_col=resolved["target"],
            sources=sources,
            detection=details,
        )
        if sample_df is not None:
            schema.require_columns(sample_df.columns)
            schema.analyze_temporal_coverage(sample_df, policy=evolution_policy)
        return schema

    @classmethod
    def from_fields(
        cls,
        fields_map: Mapping[str, Any],
        *,
        sources: Mapping[str, str] | None = None,
        detection: Mapping[str, Any] | None = None,
    ) -> "DataSchema":
        missing = [k for k in ("date", "id", "target") if k not in fields_map]
        if missing:
            raise ValueError(
                f"Schema artifact missing required fields: {', '.join(missing)}"
            )
        return cls(
            date_col=str(fields_map["date"]),
            id_col=str(fields_map["id"]),
            target_col=str(fields_map["target"]),
            sources=dict(sources or {}),
            detection=dict(detection or {}),
        )

    def require_columns(self, columns: Iterable[str], *, context: str | None = None) -> None:
        missing = [c for c in self.as_dict().values() if c not in set(columns)]
        if missing:
            where = f" in {context}" if context else ""
            raise KeyError(f"Missing required columns{where}: {', '.join(missing)}")

    def validate_overrides(self, data_cfg: Mapping[str, Any]) -> None:
        """Cross-check configured overrides against this (stored) schema."""

        overrides = extract_schema_overrides(data_cfg)
        bad: List[str] = []
        for role, configured in overrides.items():
            stored = self[role]
            if configured != stored:
                bad.append(f"{role}: configured='{configured}' stored='{stored}'")
        if bad:
            raise ValueError(
                "Configured schema columns do not match stored artifact: " + "; ".join(bad)
            )

    def analyze_temporal_coverage(self, df: LongTable, *, policy: str = "warn") -> None:
        """Flag feature columns whose observations do not span the timeline."""

        if policy == "ignore":
            return
        if self.date_col not in df.columns:
            return
        stamps = parse_datetimes(df[self.date_col])
        valid = ~np.isnat(stamps)
        if not valid.any():
            return
        start, end = stamps[valid].min(), stamps[valid].max()
        total_rows = int(valid.sum())
        coverage: Dict[str, Any] = {}
        warnings: List[str] = []
        feature_cols = [
            c for c in df.columns if c not in {self.date_col, self.id_col, self.target_col}
        ]
        for column in feature_cols:
            observed = _notna(df[column]) & valid
            n = int(observed.sum())
            entry: Dict[str, Any] = {"non_null_rows": n, "total_rows": total_rows}
            if n == 0:
                entry["status"] = "all_null"
                coverage[column] = entry
                continue
            first, last = stamps[observed].min(), stamps[observed].max()
            entry["first_timestamp"] = _iso(first)
            entry["last_timestamp"] = _iso(last)
            entry["coverage_ratio"] = n / total_rows
            if first > start:
                entry["missing_prefix"] = True
                warnings.append(
                    f"Column '{column}' is first observed at {_iso(first)[:10]} "
                    f"but data starts at {_iso(start)[:10]}"
                )
            if last < end:
                entry["missing_suffix"] = True
            coverage[column] = entry
        if coverage:
            policies = self.detection.setdefault("policies", {})
            policies.setdefault("detection", "infer")
            policies.setdefault("evolution", policy)
            self.detection["coverage"] = coverage
            self.detection["timeline"] = {"start": _iso(start), "end": _iso(end)}
        if warnings:
            message = "; ".join(warnings)
            if policy == "error":
                raise ValueError("Schema evolution detected that violates policy: " + message)
            logger.warning("Schema evolution detected: %s", message)
