"""The port's ``train_once`` against the JAX package's across a drift of
the period selection: the frozen path engages, the data's own selection
moves, the loop swaps the dynamic engine back in, and the selection
re-freezes.

The demand benchmark of ``tests/test_torch_train_once.py`` (8 series, 150
days, the same narrow model) trains for 5 epochs with ``freeze_periods``
after a 1-epoch warm-up, from the JAX run's initial weights. The
selection of the second layer moves as the features train: stable at
epochs 1-2 (frozen from epoch 2), moved at epoch 4 (back on the dynamic
path), stable again at epoch 5 (frozen again). Held, epoch by epoch, as
the 3-epoch case holds it: losses and validation metrics within 1e-4
relative, the same frozen spec, the same best epoch and artifacts;
``config_used.yaml`` records the drift's epoch.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
pytest.importorskip("pandas")

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_once import (  # noqa: E402,F401 (one_torch_thread: an autouse fixture)
    assert_same_artifacts, assert_same_runs, demand_config, demand_csv, one_torch_thread,
    run_both,
)


def test_train_once_matches_jax_across_a_drift_and_a_refreeze(monkeypatch, tmp_path, demand_csv):
    cfg = demand_config(demand_csv, epochs=5)
    cfg["train"]["freeze_after_epoch"] = 1
    want, got = run_both(monkeypatch, cfg, tmp_path)
    assert_same_runs(want, got)
    specs = [spec for spec, _ in got["epochs"]]
    assert [spec is not None for spec in specs] == [False, True, True, False, True]
    assert_same_artifacts(want["dir"], got["dir"])
    used = yaml.safe_load((got["dir"] / "config_used.yaml").read_text(encoding="utf-8"))
    assert used["train"]["freeze_periods_drift_epoch"] == 4
