"""``train.debug_nans`` and ``train.profile_dir`` in the port's
``train_once``, on the CPU.

- ``debug_nans`` on a poisoned run (an infinite learning rate: the first
  update makes parameters inf or NaN) raises ``FloatingPointError`` at the
  step where the JAX package's would (its ``jax_debug_nans`` stops the
  first program whose outputs hold a NaN; the JAX run is watched for that
  with the knob off, as its de-optimised re-run of a step takes a minute
  here): the host pipeline's first step, naming the epoch, the step and the
  first parameter that is not finite; the resident pipeline raises at the
  same step. With the knob off, the port trains the epoch through as the
  JAX package does (the non-finite rates are masked out of the loss) to
  the same infinite best NLL, and on a clean run the knob changes no loss.
- ``profile_dir`` writes a non-empty Chrome trace of the second epoch, and
  no profiler is left running after the run, nor after a run that raised
  inside the traced epoch.
"""

import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("pandas")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
sys.path.insert(0, os.path.dirname(__file__))

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu import train as jtrain  # noqa: E402
from flow_timesnet_tpu_torch import engine as pengine  # noqa: E402
from flow_timesnet_tpu_torch import train as ptrain  # noqa: E402

from test_torch_train_once import demand_config, one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    from make_demand_benchmark import write_benchmark

    out = tmp_path_factory.mktemp("demand")
    write_benchmark(str(out), seed=7, n_stores=2, n_menus=2, t_train=110)
    return out / "train.csv"


def _config(csv_path, art_dir, **train):
    cfg = demand_config(csv_path, epochs=1)
    cfg["model"]["n_layers"] = 1
    cfg["train"].update(freeze_periods=False, input_pipeline="host", **train)
    cfg["artifacts"]["dir"] = str(art_dir)
    return cfg


def test_a_poisoned_run_raises_at_the_step_jax_stops_at(monkeypatch, tmp_path, csv_path):
    """The JAX package trains the poisoned run through with its knob off;
    its ``jax_debug_nans`` would stop the first ``train_step`` program whose
    outputs hold a NaN, which the wrapper finds. The port, knob off, trains
    through the same steps to the same infinite best NLL; knob on, it
    raises at that step."""

    first_nan, steps = [], {}
    train_step = jengine.Engine.train_step

    def watched(self, *args, **kwargs):
        out = train_step(self, *args, **kwargs)
        leaves = jax.tree_util.tree_leaves((out[0].params, out[0].opt_state, out[1]))
        steps["jax"] = steps.get("jax", 0) + 1
        if not first_nan and any(np.isnan(np.asarray(v)).any() for v in leaves
                                 if np.issubdtype(np.asarray(v).dtype, np.floating)):
            first_nan.append(steps["jax"])
        return out

    def cfg(side, debug_nans):
        return _config(csv_path, tmp_path / side, lr=float("inf"), lr_warmup_steps=0,
                       debug_nans=debug_nans)

    with monkeypatch.context() as m:
        m.setattr(jengine.Engine, "train_step", watched)
        want, _ = jtrain.train_once(cfg("jax", False))
    count = []
    with monkeypatch.context() as m:
        real = pengine.Engine.train_step
        m.setattr(pengine.Engine, "train_step",
                  lambda self, *a, **k: count.append(1) or real(self, *a, **k))
        got, _ = ptrain.train_once(cfg("port", False))
        assert len(count) == steps["jax"] > 2 and got == want == float("inf")
        count.clear()
        with pytest.raises(FloatingPointError) as err:
            ptrain.train_once(cfg("port_debug", True))
    assert first_nan == [1] and len(count) == 1
    assert re.fullmatch(r"train\.debug_nans: \S+ after the update \(and \d+ more\) "
                        r"not finite at epoch 1, step 1", str(err.value)), str(err.value)


def test_the_resident_pipeline_raises_at_the_poisoned_step(tmp_path, csv_path):
    cfg = _config(csv_path, tmp_path, lr=float("inf"), lr_warmup_steps=0, debug_nans=True)
    cfg["train"]["input_pipeline"] = "device"
    with pytest.raises(FloatingPointError, match=r"at epoch 1, step 1$"):
        ptrain.train_once(cfg)


def test_debug_nans_changes_nothing_on_a_clean_run(tmp_path, csv_path):
    runs = []
    for pipeline in ("host", "device"):
        for debug_nans in (False, True):
            cfg = _config(csv_path, tmp_path / f"{pipeline}{debug_nans}", epochs=2,
                          debug_nans=debug_nans)
            cfg["train"]["input_pipeline"] = pipeline
            cfg["model"]["dropout"] = 0.1
            best, paths = ptrain.train_once(cfg)
            runs.append((best, paths["metrics"]["epoch_loss"]))
    assert runs[0] == runs[1] and runs[2] == runs[3]


def test_profile_dir_writes_a_trace_of_the_second_epoch(monkeypatch, tmp_path, csv_path):
    trace_dir = tmp_path / "trace"
    cfg = _config(csv_path, tmp_path / "art", epochs=2, profile_dir=str(trace_dir))
    cfg["train"]["input_pipeline"] = "device"
    ptrain.train_once(cfg)
    assert sorted(os.listdir(trace_dir)) == ["torch_trace_epoch2.json"]
    with open(trace_dir / "torch_trace_epoch2.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any("aten::" in n for n in names)
    assert not torch.autograd.profiler._is_profiler_enabled
    # a run that raises inside the traced epoch stops the trace on its way out
    poisoned = _config(csv_path, tmp_path / "art2", epochs=2, profile_dir=str(tmp_path / "t2"),
                       debug_nans=True)
    lr_for_epoch = ptrain.LRController.lr_for_epoch
    monkeypatch.setattr(ptrain.LRController, "lr_for_epoch",
                        lambda self, ep: float("inf") if ep == 2 else lr_for_epoch(self, ep))
    with pytest.raises(FloatingPointError, match="at epoch 2, step 1$"):
        ptrain.train_once(poisoned)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not (tmp_path / "t2").exists()  # stopped, not written: the epoch did not end
