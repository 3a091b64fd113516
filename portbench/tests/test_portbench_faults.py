"""A run with its timed path broken underneath comes out not correct, on
the CPU with the chip's look skipped: a step that leaves its state
unchanged, a loss over half of each batch, an answer altered where it is
produced. And the control, the reference in float8 put in the program's
place, fails a limit of each cell."""

import pytest
import torch
from helpers import cpu_run, found

from flow_timesnet_tpu_torch import engine as port_engine
from flow_timesnet_tpu_torch import optim as port_optim
from portbench import controls
from portbench import run as prun
from portbench.harness import manifest

TRAIN = [("flagship.train", False), ("long.train", True)]
SERVE = [("flagship.serve", False), ("long.serve", True)]


def _failed(run, names):
    assert run.correct is False
    over = [k for k, c in run.checks.items() if c["value"] > c["limit"]]
    assert set(names) & set(over), run.checks


@pytest.mark.parametrize("workload,small", TRAIN)
def test_step_that_leaves_the_state_unchanged(monkeypatch, workload, small):
    monkeypatch.setattr(port_optim.Optimizer, "step", lambda self, grads: None)
    _failed(cpu_run(found(workload, small)), {"grad_gap", "change_gap"})


@pytest.mark.parametrize("workload,small", TRAIN)
def test_loss_over_half_of_each_batch(monkeypatch, workload, small):
    whole = port_engine.Engine._loss

    def half(self, batch, generator):
        rows = batch["x"].shape[0] // 2
        cut = {k: (v[:rows] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * rows
                   else v) for k, v in batch.items()}
        return whole(self, cut, generator)

    monkeypatch.setattr(port_engine.Engine, "_loss", half)
    _failed(cpu_run(found(workload, small)), {"loss_gap", "grad_gap", "change_gap"})


@pytest.mark.parametrize("workload,small", SERVE)
def test_answer_altered_where_it_is_produced(monkeypatch, workload, small):
    forward = port_engine.Engine.forward

    def altered(self, *args, **kwargs):
        rate, disp = forward(self, *args, **kwargs)
        rate = rate.clone()
        rate[0, 0, 0] += 1.0
        return rate, disp

    monkeypatch.setattr(port_engine.Engine, "forward", altered)
    _failed(cpu_run(found(workload, small)), {"forecast_gap"})


@pytest.mark.parametrize("workload,small", TRAIN + [("flagship.serve", False),
                                                    ("long.serve", False)])
def test_control_fails_a_limit(workload, small):
    cell = found(workload, small)
    run = prun.Run(torch, cell, 2147483659, 0.5, False, device="cpu")
    if cell["traffic"]["kind"] == "train":
        readings = controls.control_train(run, cell, "control")
    else:
        readings = controls.control_serve(run, cell)
    assert any(readings[k] > limit for k, limit in cell["limits"].items() if k in readings), \
        (readings, cell["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flagship.train", "long.train", "flagship.serve",
                                      "long.serve"])
def test_control_fails_a_limit_on_the_card(workload):
    """At the cell's own size (``python -m pytest -m cuda portbench/tests``)."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = manifest.cell(manifest.load(), workload)
    run = prun.Run(torch, cell, 2147483659, 1.0, False)
    if cell["traffic"]["kind"] == "train":
        readings = controls.control_train(run, cell, "control")
    else:
        readings = controls.control_serve(run, cell)
    assert any(readings[k] > limit for k, limit in cell["limits"].items() if k in readings)
