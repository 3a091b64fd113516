"""``BENCHMARK.json`` against the benchmark's contract, and the files it names."""

import json
import math
import re
import shutil

import pytest
from helpers import ROOT

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits(bench):
    assert set(bench) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"] and all(PATH.match(p) for p in bench["paths"])
    assert 10 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    for kind, entries in (("config", bench["configs"]), ("workload", bench["workloads"])):
        for e in entries:
            assert set(e) == KEYS[kind]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert KEYS[kind] <= set(m) <= KEYS[kind] | {"workloads"}


def test_names_units_and_lines(bench):
    names = []
    for e in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(e["name"]), e["name"]
        names.append(e["name"])
    for group in ("configs", "workloads"):
        group_names = [e["name"] for e in bench[group]]
        assert len(group_names) == len(set(group_names))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in metric_names
    for m in bench["per_layer"]:
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_moves_target_is_reported_by_each_cell(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in cells:
            if _reports(m, cell):
                assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:  # set-up, one more end-to-end metric and one per-layer metric each
        reported = [m["name"] for m in bench["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(_reports(m, cell) for m in bench["per_layer"])


def test_every_named_file_exists(bench):
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["model"]
    for w in bench["workloads"]:
        found = manifest.cell(bench, w["name"])
        assert found["traffic"]["kind"] in ("train", "serve")
        assert found["limits"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_files_added_alone_are_found_by_name(tmp_path, bench):
    """A configuration, a traffic mix, a cell's limits and a metric added
    as new files, with their entries, are found without an edit."""

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    pb = tmp_path / "portbench"
    (pb / "configs" / "tiny.json").write_text(
        (pb / "configs" / "demand_benchmark.json").read_text())
    traffic = json.loads((pb / "traffic" / "closed_loop.json").read_text())
    traffic["cuts"] = 8
    (pb / "traffic" / "bursts.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tiny.bursts.json").write_text('{"forecast_gap": 0.5}')
    (pb / "metrics" / "requests_done.py").write_text("def read(ctx):\n    return ctx['requests']\n")
    new["configs"].append({"name": "tiny", "source": "x", "file": "portbench/configs/tiny.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "tiny.bursts", "config": "tiny", "traffic": "bursts",
                             "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                             "source": "host_clock", "layer": "forecaster",
                             "moves": "request_p50_ms", "workloads": ["tiny.bursts"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    loaded = manifest.load(tmp_path)
    found = manifest.cell(loaded, "tiny.bursts", root=tmp_path)
    assert found["traffic"]["cuts"] == 8 and found["limits"] == {"forecast_gap": 0.5}
    assert found["config_name"] == "tiny"
    names = [m["name"] for m in manifest.metrics(loaded, "tiny.bursts", True)]
    assert "requests_done" in names and "mfu.train" not in names
    assert manifest.reader("requests_done", tmp_path)({"requests": 7}) == 7


def test_configuration_added_alone_with_other_series_runs(tmp_path, bench):
    """A configuration added as a file alone, whose generator makes another
    number of series, loads and runs a training cell with no edit."""

    from helpers import SMALL, cpu_run

    from portbench.harness import data as hdata

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs" / "demand_benchmark.json").read_text())
    config["data"]["generator_args"].update(n_stores=2, n_menus=3, t_train=120)
    config["data"].update(series=6, steps=183, train_steps=120, holdout_steps=28)
    config["model"].update(SMALL["demand_benchmark"])
    del config["parameters"]
    (pb / "configs" / "few_stores.json").write_text(json.dumps(config))
    (pb / "limits" / "few_stores.train.json").write_text(
        (pb / "limits" / "flagship.train.json").read_text())
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "few_stores", "source": "x",
                           "file": "portbench/configs/few_stores.json", "reduced": [],
                           "why": "x"})
    new["workloads"].append({"name": "few_stores.train", "config": "few_stores",
                             "traffic": "resident_epochs", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    found = manifest.cell(manifest.load(tmp_path), "few_stores.train", root=tmp_path)
    ds = hdata.dataset(found["config"])
    assert ds.values.shape == (183, 6) and len(ds.ids) == 6 and ds.static.shape == (6, 5)
    found["config"]["train"]["batch_size"] = 8
    found["traffic"]["chunk_steps"] = 2
    run = cpu_run(found, seconds=0.2)
    # the run and its check went through (the limits are the full-size cell's,
    # not this CPU run's, so only their presence is asserted)
    assert run.attempted > 0 and run.failed == 0
    assert set(run.checks) == set(found["limits"])
    assert all(math.isfinite(c["value"]) for c in run.checks.values())


@pytest.mark.parametrize("workload,key", [("flagship.serve", "callers"),
                                          ("flagship.train", "batch_size")])
def test_a_traffic_key_no_cell_reads_is_refused(workload, key):
    """A mix that sets what its cell would not read fails before the run
    starts, so it never measures the same loop under another name."""

    import torch
    from helpers import found as found_cell

    from portbench import run as prun

    cell = found_cell(workload)
    cell["traffic"][key] = 4
    run = prun.Run(torch, cell, 7, 0.1, False, device="cpu")
    with pytest.raises(ValueError, match=key):
        prun.execute(run)
    assert run.marks == [] or [label for label, _ in run.marks] == ["imports"]


@pytest.mark.parametrize("name", ["closed_loop", "resident_epochs"])
def test_every_traffic_key_is_read(name):
    """The mixes here set only what their cell module reads."""

    import importlib

    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    module = importlib.import_module(f"portbench.harness.{traffic['kind']}")
    assert set(traffic) - {"kind"} == set(module.TRAFFIC_KEYS)
