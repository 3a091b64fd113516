"""``harness/regions.py`` and the readers of the program's capture counters,
on the CPU: a program without tracing reads as nothing, the counters add up
over kinds, and the regions and spans of a small cell count its units."""

import importlib

import pytest
import torch
from helpers import found

from portbench import run as prun
from portbench.harness import manifest, regions


@pytest.mark.parametrize("name,want", [("graph_captures", 3), ("graph_capture_s", 1.5)])
def test_the_capture_readers(monkeypatch, name, want):
    from flow_timesnet_tpu_torch import graphs

    read = manifest.reader(name)
    monkeypatch.setattr(graphs, "_captures", {"forward": 1, "epoch": 2})
    monkeypatch.setattr(graphs, "_capture_seconds", {"forward": 0.5, "epoch": 1.0})
    assert read({}) == pytest.approx(want)
    monkeypatch.setattr(regions, "_program", lambda: None)
    assert read({}) is None


def test_a_program_without_tracing_measures_nothing(monkeypatch):
    real = importlib.import_module

    def older(name, *a):
        if name == "flow_timesnet_tpu_torch.tracing":
            raise ImportError(name)
        return real(name, *a)

    monkeypatch.setattr(importlib, "import_module", older)
    assert regions.capture_totals() is None and regions.measure(object()) == {}


@pytest.mark.parametrize("workload", ["flagship.train", "flagship.serve"])
def test_regions_and_spans_count_the_units(workload):
    from flow_timesnet_tpu_torch import tracing

    cell_found = found(workload, small=True)
    run = prun.Run(torch, cell_found, 2147483659, 0.2, True, device="cpu")
    cell = importlib.import_module(f"portbench.harness.{run.traffic['kind']}").Cell(run)
    cell.setup()
    cell.window(0.2)
    got = regions.measure(cell)
    assert not tracing.enabled() and tracing.spans() == []
    n = got["region_units"]
    model = cell_found["config"]["model"]
    per_pass = model["n_layers"] * 2 * (2 * len(model["kernel_set"]) + 2)
    counts = {k: c for k, (c, _) in got["regions"].items()}
    if run.ctx["kind"] == "train":
        steps = {k: n for k in ("step.gather", "step.forward", "step.backward",
                                "step.optimizer")}
        assert counts == {**steps, "pointwise.fwd": n * per_pass, "pointwise.bwd": n * per_pass}
    else:
        assert counts == {"model.forward": n, "pointwise.fwd": n * per_pass}
        assert got["forecaster_host_s"] > 0
    # the CPU has no device activity: the whole span is one gap, under a program span
    assert set(got["idle_by_span"]) <= {"forecast", "forecast.prepare", "forecast.upload",
                                        "engine.replay", "forecast.fetch", "forecast.finish",
                                        "train.chunk", "outside"}
    assert got["profiled_regions"] == {k: (c, got["profiled_regions"][k][1])
                                       for k, (c, _) in got["regions"].items()}
    assert got["traced_unit_s"] > 0 and sum(got["idle_by_span"].values()) > 0
