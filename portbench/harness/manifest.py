"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[i]``) names a configuration, whose entry gives its
file, and a traffic mix, read from ``portbench/traffic/<traffic>.json``;
its limits are ``portbench/limits/<cell>.json``. A metric is read by
``portbench/metrics/<name>.py``, a module with ``read(ctx)`` that returns a
number, or None where it finds nothing to read. Adding a cell, a traffic
mix or a metric is adding files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]


def load(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict[str, Any], workload: str, root: Path = ROOT) -> Dict[str, Any]:
    """The cell's entry, configuration, traffic mix and limits."""

    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "portbench" / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    return {"workload": w, "config": config, "config_name": entry["name"], "traffic": traffic,
            "limits": limits}


def metrics(bench: Dict[str, Any], workload: str, traced: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``workload`` reports: the end-to-end ones, or
    with a trace the per-layer ones, each where its ``workloads`` (if any)
    lists the cell."""

    chosen = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in chosen if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""

    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
