"""The port's ``train_once`` loop control on the CPU: the frozen-period
engine swaps (a drift back to the dynamic engine, a re-freeze that takes
up the engine it swapped out, the ``train.freeze_max_recompiles`` cap),
early stopping and ``epoch_hook``.

The demand benchmark's CSV (``chip_smoke.py``'s writer, the generator's
bytes; 2 stores x 2 menus = 4 series, 150 days) trains a narrow model in
the port alone. The freeze decisions follow a script: each epoch's probe
runs the real telemetry and ``Engine.frozen_spec_from_telemetry``, and the
wrapper below hands the loop spec ``A`` (the first epoch's real spec) or
``B`` (the same slots with the layers in reverse order, another valid
spec), so that a drift and a re-freeze happen at known epochs. The
validation sMAPE the loop selects on follows a script the same way for
early stopping. ``tests/test_torch_train_once_drift.py`` holds a drift of
the data's own against the JAX package; ``tests/test_torch_cuda.py`` runs
the scripted swaps on the card with CUDA graphs and without.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

from flow_timesnet_tpu_torch import train as ptrain  # noqa: E402
from flow_timesnet_tpu_torch.engine import Engine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_csv(directory) -> str:
    path = os.path.join(str(directory), "train.csv")
    chip_smoke.write_demand_csv(np, path, 7, 2, 2, 150)
    return path


def control_config(csv_path, art_dir, epochs, **train):
    """A narrow model on the flagship recipe's shape: rolling validation,
    EMA, selection on sMAPE, ``freeze_periods`` from epoch 2 on."""

    cfg = {
        "data": {"train_csv": str(csv_path), "date_col": "영업일자", "id_col": "영업장명_메뉴명",
                 "target_col": "매출수량", "encoding": "utf-8-sig", "fill_missing_dates": True,
                 "time_features": {"enabled": True, "encoding": "cyclical", "normalize": True,
                                   "features": ["day_of_week", "day_of_month", "month",
                                                "day_of_year"]}},
        "preprocess": {"normalize": "none", "clip_negative": True},
        "window": {"input_len": 28, "pred_len": 7},
        "model": {"mode": "direct", "d_model": 16, "d_ff": 32, "n_layers": 2, "k_periods": 2,
                  "min_period_threshold": 7, "kernel_set": [[3, 3]], "dropout": 0.0,
                  "bottleneck_ratio": 4.0, "id_embed_dim": 4, "static_proj_dim": 4,
                  "use_zero_mean_context": True, "context_rank": 4, "context_scale": 0.05,
                  "compute_dtype": "float32"},
        "train": {"device": "cpu", "epochs": epochs, "batch_size": 32, "lr": 1e-3,
                  "lr_warmup_steps": 20, "weight_decay": 1e-6, "grad_clip_norm": 1.0,
                  "use_loss_masking": True, "ema_decay": 0.99, "selection_metric": "smape",
                  "freeze_periods": True, "freeze_after_epoch": 1, "data_parallel": "off",
                  "min_sigma_method": "per_series_median", "min_sigma_scale": 0.05,
                  "lr_scheduler": {"type": "cosine", "eta_min": 1e-5},
                  "val": {"strategy": "rolling", "rolling_folds": 2, "rolling_step_days": 7,
                          "holdout_days": 35}},
        "artifacts": {"dir": str(art_dir)},
        "tuning": {"seed": 7},
    }
    cfg["train"].update(train)
    return cfg


def script_specs(monkeypatch, script):
    """Make the loop's freeze decisions follow ``script`` (one letter an
    epoch): ``A`` is the first probe's real spec, ``B`` that spec with its
    layers reversed. Returns ``{"A": ..., "B": ...}``, filled by the first
    probe."""

    real = Engine.frozen_spec_from_telemetry
    specs, calls = {}, []

    def scripted(telemetry, n_layers):
        spec = real(telemetry, n_layers)
        if not specs:
            specs["A"], specs["B"] = spec, tuple(reversed(spec))
            assert specs["A"] != specs["B"], "the layers' selections must differ"
        calls.append(spec)
        return specs[script[len(calls) - 1]]

    monkeypatch.setattr(Engine, "frozen_spec_from_telemetry", staticmethod(scripted))
    return specs


def record_epochs(monkeypatch, smape_script=None):
    """Record, for every epoch, the engine that trained it, its frozen spec,
    its losses and its validation metrics; with ``smape_script`` the sMAPE
    the loop sees is the script's (one value an epoch)."""

    log = {"engines": [], "specs": [], "losses": [], "metrics": [], "built": []}
    epoch, evaluate, init = Engine.train_epoch_resident, Engine.evaluate_resident, Engine.__init__

    def train_epoch_resident(self, *args, **kwargs):
        out = epoch(self, *args, **kwargs)
        log["engines"].append(self)
        log["specs"].append(self.cfg.frozen_periods)
        log["losses"].append(out[1].detach().cpu().numpy().astype(np.float64))
        return out

    def evaluate_resident(self, *args, **kwargs):
        out = dict(evaluate(self, *args, **kwargs))
        if smape_script is not None:
            out["smape"] = smape_script[len(log["metrics"])]
        log["metrics"].append(out)
        return out

    def built(self, cfg, *args, **kwargs):
        init(self, cfg, *args, **kwargs)
        log["built"].append(cfg.frozen_periods)

    monkeypatch.setattr(Engine, "train_epoch_resident", train_epoch_resident)
    monkeypatch.setattr(Engine, "evaluate_resident", evaluate_resident)
    monkeypatch.setattr(Engine, "__init__", built)
    return log


@pytest.fixture(scope="module")
def demand_csv(tmp_path_factory):
    return write_csv(tmp_path_factory.mktemp("demand"))


# AABBAA: freeze A at epoch 2, drift at 3, freeze B at 4, drift at 5, and
# at 6 freeze A again on the engine built at epoch 2. With a cap of one
# frozen engine, B never gets one: epochs 4 and 5 stay on the dynamic
# engine, and the one drift is epoch 3's.
@pytest.mark.parametrize("cap,want,drift", [(3, [None, "A", None, "B", None, "A"], 5),
                                            (1, [None, "A", None, None, None, "A"], 3)],
                         ids=["cap3", "cap1"])
def test_drift_and_refreeze_follow_the_selection(monkeypatch, tmp_path, demand_csv, cap, want,
                                                 drift):
    specs = script_specs(monkeypatch, "AABBAA")
    log = record_epochs(monkeypatch)
    cfg = control_config(demand_csv, tmp_path, 6, freeze_max_recompiles=cap)
    best, paths = ptrain.train_once(cfg)

    assert log["specs"] == [None if k is None else specs[k] for k in want]
    # one dynamic engine, then one for each distinct spec the cap lets in
    frozen_built = [s for s in log["built"] if s is not None]
    assert log["built"][0] is None and frozen_built == sorted(
        {specs[k] for k in want if k is not None}, key=[specs["A"], specs["B"]].index)
    dynamic = log["engines"][0]
    assert all(log["engines"][i] is dynamic for i, k in enumerate(want) if k is None)
    assert log["engines"][5] is log["engines"][1]  # the swapped-out engine, taken up again
    assert paths["metrics"]["epoch_frozen"] == [k is not None for k in want]
    yaml = pytest.importorskip("yaml")
    used = yaml.safe_load(open(paths["config"], encoding="utf-8"))
    assert used["train"]["freeze_periods_drift_epoch"] == drift
    best_epoch = paths["metrics"]["best_epoch"]
    best_spec = specs.get(want[best_epoch - 1])
    assert used["train"].get("frozen_periods_spec") == (
        None if best_spec is None else [[list(slot) for slot in layer] for layer in best_spec])
    assert np.isfinite(best) and all(np.isfinite(v).all() for v in log["losses"])


def test_early_stopping_ends_the_run_after_patience(monkeypatch, tmp_path, demand_csv):
    script_specs(monkeypatch, "AAAAAA")
    smape = [0.9, 0.8, 0.85, 0.86, 0.7, 0.6]
    log = record_epochs(monkeypatch, smape_script=smape)
    cfg = control_config(demand_csv, tmp_path, 6, early_stopping_patience=1)
    best, paths = ptrain.train_once(cfg)

    # epoch 2 is the best; epochs 3 and 4 are worse, and the second of them
    # exceeds a patience of 1: epochs 5 and 6 never run
    assert len(log["losses"]) == len(log["metrics"]) == 4
    assert paths["metrics"]["epoch_val_smape"] == smape[:4]
    assert paths["metrics"]["best_epoch"] == 2
    assert paths["metrics"]["smape"] == 0.8
    assert best == float(log["metrics"][1]["nll"])
    assert os.path.exists(paths["model"])


@pytest.mark.parametrize("stop_at", [2, None], ids=["prunes", "never"])
def test_epoch_hook_sees_each_selection_value_and_prunes(monkeypatch, tmp_path, demand_csv,
                                                         stop_at):
    script_specs(monkeypatch, "AAA")
    log = record_epochs(monkeypatch)
    calls = []

    def hook(epoch, value):
        calls.append((epoch, value))
        return epoch == stop_at

    cfg = control_config(demand_csv, tmp_path, 3)
    best, paths = ptrain.train_once(cfg, epoch_hook=hook)

    ran = stop_at or 3
    assert len(log["losses"]) == ran
    assert calls == [(ep, float(m["smape"])) for ep, m in enumerate(log["metrics"], start=1)]
    assert [ep for ep, _ in calls] == list(range(1, ran + 1))
    assert all(os.path.exists(p) for k, p in paths.items() if k != "metrics")
