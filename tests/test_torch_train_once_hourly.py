"""The port's ``train_once`` on the long-context recipe's shape (holdout
validation, zscore scaling, hourly stamps, rematerialised blocks) against
the JAX package's, and the port's resume against an uninterrupted run.

- A reduced long-context CSV (``tools/make_long_context_benchmark.py``: 4
  series x 400 hours) trains a narrow model at L=48, H=24 with
  ``use_checkpoint`` and ``freeze_periods`` for 2 epochs in both packages,
  from the JAX run's initial weights: each epoch's loss and validation
  metrics within 1e-4 relative, the same frozen spec each epoch, equal
  artifacts (``freq`` ``h``), as ``tests/test_torch_train_once.py`` holds
  the flagship shape.
- Resume, in the port alone (as ``tests/test_resume.py`` in the JAX
  package): 2 epochs that save their training state, then a resumed run to
  3, equal 3 uninterrupted epochs, with dropout on (the generator is
  seeded per epoch) and the cosine horizon pinned.
- The subcommands of ``cli.py`` on a written config, with ``--override``:
  the recipes' ``device: tpu`` asks for the card (raising here),
  ``train.device=cpu`` trains; ``predict`` and ``evaluate`` read the
  artifacts, and a one-trial ``tune`` writes its study's files.
"""

import copy
import json
import os
import sys

import numpy as np

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
pytest.importorskip("pandas")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_once import (  # noqa: E402,F401 (one_torch_thread: an autouse fixture)
    assert_same_artifacts, assert_same_runs, demand_config, one_torch_thread, run_both,
)

from flow_timesnet_tpu_torch import train as ptrain  # noqa: E402
from flow_timesnet_tpu_torch.utils import artifacts  # noqa: E402


def long_config(csv_path):
    return {
        "data": {"train_csv": str(csv_path), "date_col": "date", "id_col": "id",
                 "target_col": "target", "encoding": "utf-8", "fill_missing_dates": True,
                 "time_features": {"enabled": True, "features": ["day_of_week", "hour"],
                                   "encoding": "cyclical", "normalize": True}},
        "preprocess": {"normalize": "zscore", "normalize_per_series": True, "eps": 1.0e-8,
                       "clip_negative": True},
        "window": {"input_len": 48, "pred_len": 24},
        "model": {"mode": "direct", "d_model": 16, "d_ff": 32, "n_layers": 2, "k_periods": 2,
                  "min_period_threshold": 4, "kernel_set": [[3, 3]], "dropout": 0.0,
                  "bottleneck_ratio": 4.0, "id_embed_dim": 4, "static_proj_dim": 4,
                  "use_zero_mean_context": True, "context_rank": 4, "context_scale": 0.05,
                  "period_binning": 2.0, "compute_dtype": "float32"},
        "train": {"device": "cpu", "epochs": 2, "batch_size": 32, "lr": 1e-3,
                  "lr_warmup_steps": 10, "weight_decay": 1e-6, "grad_clip_norm": 1.0,
                  "use_checkpoint": True, "use_loss_masking": True, "freeze_periods": True,
                  "data_parallel": "off", "min_sigma_method": "per_series_median",
                  "min_sigma_scale": 0.05, "lr_scheduler": {"type": "cosine", "eta_min": 1e-5},
                  "val": {"strategy": "holdout", "holdout_days": 96}},
        "artifacts": {"dir": "unset"},
        "tuning": {"seed": 5},
    }


def test_train_once_matches_jax_on_the_long_context_recipe_shape(monkeypatch, tmp_path):
    from make_long_context_benchmark import write_benchmark

    write_benchmark(str(tmp_path / "data"), seed=5, n_series=4, t_train=400)
    want, got = run_both(monkeypatch, long_config(tmp_path / "data" / "train.csv"), tmp_path)
    assert_same_runs(want, got)
    assert [spec is not None for spec, _ in got["epochs"]] == [False, True]
    assert_same_artifacts(want["dir"], got["dir"])
    cfg = yaml.safe_load((got["dir"] / "config_used.yaml").read_text(encoding="utf-8"))
    assert cfg["data"]["time_features"]["freq"] == "h"
    assert cfg["train"]["input_pipeline_effective"] == "device"


def test_resume_continues_from_the_saved_state(tmp_path):
    from make_demand_benchmark import write_benchmark

    write_benchmark(str(tmp_path / "data"), seed=7, n_stores=2, n_menus=2, t_train=110)
    base = demand_config(tmp_path / "data" / "train.csv")
    base["model"]["dropout"] = 0.1
    base["train"].update(freeze_periods=False, save_train_state=True,
                         lr_scheduler={"type": "cosine", "T_max": 3, "eta_min": 1e-5})

    def run(epochs, art_dir, resume=False):
        cfg = copy.deepcopy(base)
        cfg["train"].update(epochs=epochs, resume=resume)
        cfg["artifacts"]["dir"] = str(art_dir)
        return ptrain.train_once(cfg)

    full_nll, full = run(3, tmp_path / "full")
    run(2, tmp_path / "part")
    state_file = tmp_path / "part" / artifacts.TRAIN_STATE_FILE
    assert state_file.exists() and not (tmp_path / "part" / "train_state.msgpack").exists()
    resumed_nll, resumed = run(3, tmp_path / "part", resume=True)
    assert resumed["metrics"]["epoch_loss"] == full["metrics"]["epoch_loss"][2:]
    assert resumed_nll == full_nll
    assert resumed["metrics"]["smape"] == full["metrics"]["smape"]


def test_cli_trains_predicts_evaluates_and_tunes(tmp_path, capsys):
    from make_demand_benchmark import write_benchmark

    from flow_timesnet_tpu_torch import cli, dependency
    from flow_timesnet_tpu_torch.config import save_yaml

    write_benchmark(str(tmp_path / "data"), seed=3, n_stores=1, n_menus=2, t_train=100)
    cfg = demand_config(tmp_path / "data" / "train.csv", epochs=3)
    cfg["train"]["device"] = "tpu"  # as the recipes say: the card, which this host lacks
    cfg["artifacts"]["dir"] = str(tmp_path / "artifacts")
    path = tmp_path / "cfg.yaml"
    save_yaml(cfg, str(path))
    if not torch.cuda.is_available():  # no card: the recipe's device raises, nothing runs
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(["train", "--config", str(path)])
    cli.main(["train", "--config", str(path), "--override", "train.device=cpu",
              "--override", "train.epochs=1", "train.freeze_periods=off"])
    assert "Final best NLL" in capsys.readouterr().out
    used = yaml.safe_load((tmp_path / "artifacts" / "config_used.yaml").read_text("utf-8"))
    assert used["train"]["epochs"] == 1 and used["train"]["device"] == "cpu"
    # predict and evaluate read those artifacts; tune is not ported
    paths = [f"data.test_dir={tmp_path / 'data' / 'test'}",
             f"data.sample_submission={tmp_path / 'data' / 'sample_submission.csv'}",
             f"submission.out_path={tmp_path / 'sub.csv'}", "submission.format=row_key"]
    for command in ("predict", "evaluate"):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                cli.main([command, "--config", str(path), "--override", *paths])
        cli.main([command, "--config", str(path), "--override", "train.device=cpu", *paths])
    assert "Evaluation: nll=" in capsys.readouterr().out
    sub = (tmp_path / "sub.csv").read_text("utf-8-sig").splitlines()
    assert len(sub) == 1 + 5 * 7 and sub[1].startswith("TEST_00+D1,")
    space = tmp_path / "space.yaml"
    save_yaml({"train.lr": {"low": 1e-4, "high": 1e-2, "log": True, "type": "float"}}, str(space))
    tuned = tmp_path / "tuned"
    cli.main(["tune", "--config", str(path), "--search-space", str(space), "--n-trials", "1",
              "--override", "train.device=cpu", "train.epochs=1", "train.freeze_periods=off",
              f"artifacts.dir={tuned}"])
    best = json.loads((tuned / "best_params.json").read_text("utf-8"))
    assert list(best["best_params"]) == ["train.lr"] and np.isfinite(best["best_value"])
    best_cfg = yaml.safe_load((tuned / "best_config.yaml").read_text("utf-8"))
    assert best_cfg["train"]["lr"] == best["best_params"]["train.lr"]
    assert (tuned / "timesnet.msgpack").is_file()
    seed, devices = dependency.bootstrap(5)
    assert seed == 5 and len(devices) == torch.cuda.device_count()


def test_the_host_pipeline_trains_as_the_resident_one(tmp_path):
    """``train.input_pipeline=host`` (one ``Engine.train_step`` a host batch)
    against the default resident pipeline: the same shuffle (the batcher's
    and the plan's generators both draw ``default_rng([seed, epoch])``), the
    same windows and the same math, so the same losses, metrics and freeze,
    to float32 rounding; accumulation takes the host pipeline."""

    from make_demand_benchmark import write_benchmark

    write_benchmark(str(tmp_path / "data"), seed=7, n_stores=2, n_menus=2, t_train=110)
    base = demand_config(tmp_path / "data" / "train.csv", epochs=3)
    runs = {}
    for pipeline, accum in (("auto", 1), ("host", 1), ("auto", 2)):
        cfg = copy.deepcopy(base)
        cfg["train"].update(input_pipeline=pipeline, accumulation_steps=accum)
        cfg["artifacts"]["dir"] = str(tmp_path / f"{pipeline}{accum}")
        runs[pipeline, accum] = ptrain.train_once(cfg)[1]["metrics"]
    resident, host, accumulated = runs["auto", 1], runs["host", 1], runs["auto", 2]
    assert resident["input_pipeline"] == "device"
    assert host["input_pipeline"] == accumulated["input_pipeline"] == "host"
    assert host["epoch_frozen"] == resident["epoch_frozen"] == [False, False, True]
    for key in ("epoch_loss", "epoch_val_nll", "epoch_val_smape"):
        assert host[key] == pytest.approx(resident[key], rel=1e-6), key
    assert all(abs(v) < float("inf") for v in accumulated["epoch_loss"])
