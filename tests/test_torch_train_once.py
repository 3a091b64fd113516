"""The port's ``train_once`` against the JAX package's on the same CSV and
config, on the CPU, with the same initial weights.

A generated demand benchmark (2 stores x 4 menus = 8 series, 150 days,
``tools/make_demand_benchmark.py``) trains a narrow flagship-shaped model
(d_model 16, 2 layers, 3x3 kernels, float32, dropout 0, B=32) for 3 epochs
with rolling validation (2 folds), EMA, ``selection_metric: smape`` and
``freeze_periods`` after a 2-epoch warm-up, so the freeze engages at epoch
3. Both packages choose the device-resident pipeline. The JAX run's
initial parameters (``Engine.init_state``) are recorded and handed to the
port's one init call (``convert.init_params``) with ``monkeypatch``; each
package's resident epoch and evaluation are wrapped to record what every
epoch did. Held to:

- each epoch's mean training loss, validation NLL and sMAPE within 1e-4
  relative; the same epochs on the frozen path with the same spec;
- the same best epoch, ``best_nll`` within 1e-4 relative;
- ``config_used.yaml`` equal (``min_sigma_vector`` and the stored frozen
  spec included) but for ``artifacts.dir``, the one key that names a path
  of its own in each run;
- the scaler pickle, ``metadata.json`` and ``model_signature.json`` equal.

``tests/test_torch_train_once_hourly.py`` holds the holdout / zscore /
hourly case and the port's resume.
"""

import copy
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
pytest.importorskip("pandas")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu import train as jtrain  # noqa: E402
from flow_timesnet_tpu_torch import convert  # noqa: E402
from flow_timesnet_tpu_torch import engine as pengine  # noqa: E402
from flow_timesnet_tpu_torch import train as ptrain  # noqa: E402
from flow_timesnet_tpu_torch.utils import metadata  # noqa: E402

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU suite runs several workers on a few cores; a torch thread pool
    as wide as the machine in each worker oversubscribes them, and the
    port's small CPU steps then take many times longer."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# config_used.yaml keys that name each run's own path
PATH_KEYS = (("artifacts", "dir"),)


def demand_config(csv_path, epochs=3):
    return {
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
                  "freeze_periods": True, "freeze_after_epoch": 2, "data_parallel": "off",
                  "min_sigma_method": "per_series_median", "min_sigma_scale": 0.05,
                  "lr_scheduler": {"type": "cosine", "eta_min": 1e-5},
                  "val": {"strategy": "rolling", "rolling_folds": 2, "rolling_step_days": 7,
                          "holdout_days": 35}},
        "artifacts": {"dir": "unset"},
        "tuning": {"seed": 7},
    }


def _record(monkeypatch, engine_cls, log):
    """Wrap ``engine_cls``'s resident epoch and evaluation: every epoch
    appends (the engine's frozen spec, its losses) and its metrics."""

    epoch, evaluate = engine_cls.train_epoch_resident, engine_cls.evaluate_resident

    def train_epoch_resident(self, *args, **kwargs):
        out = epoch(self, *args, **kwargs)
        log["epochs"].append((self.cfg.frozen_periods, np.asarray(out[1], np.float64)))
        return out

    def evaluate_resident(self, *args, **kwargs):
        out = evaluate(self, *args, **kwargs)
        log["metrics"].append(out)
        return out

    monkeypatch.setattr(engine_cls, "train_epoch_resident", train_epoch_resident)
    monkeypatch.setattr(engine_cls, "evaluate_resident", evaluate_resident)


def run_both(monkeypatch, cfg, tmp_path):
    """``train_once`` of the JAX package, then of the port on the JAX run's
    initial parameters: (jax log, port log), each with its result."""

    logs = {}
    for side in ("jax", "port"):
        log = logs[side] = {"epochs": [], "metrics": []}
        run_cfg = copy.deepcopy(cfg)
        run_cfg["artifacts"]["dir"] = str(tmp_path / side)
        with monkeypatch.context() as m:
            if side == "jax":
                _record(m, jengine.Engine, log)
                init_state = jengine.Engine.init_state

                def capture(self, *args, **kwargs):
                    state = init_state(self, *args, **kwargs)
                    log["init"] = jax.tree_util.tree_map(np.asarray, state.params)
                    return state

                m.setattr(jengine.Engine, "init_state", capture)
                log["result"] = jtrain.train_once(run_cfg)
            else:
                _record(m, pengine.Engine, log)
                tree = logs["jax"]["init"]
                m.setattr(convert, "init_params",
                          lambda tn_cfg, generator: convert.params_from_jax(tree, tn_cfg))
                log["result"] = ptrain.train_once(run_cfg)
        log["dir"] = tmp_path / side
        log["selection"] = cfg["train"].get("selection_metric", "nll")
    return logs["jax"], logs["port"]


def _without(mapping, keys):
    out = copy.deepcopy(mapping)
    for path in keys:
        node = out
        for part in path[:-1]:
            node = node[part]
        node.pop(path[-1])
    return out


def assert_same_runs(want, got):
    assert len(got["epochs"]) == len(want["epochs"]) > 0
    for ep, ((spec_w, loss_w), (spec_g, loss_g)) in enumerate(zip(want["epochs"], got["epochs"]),
                                                            start=1):
        assert spec_g == spec_w, f"epoch {ep}: frozen spec"
        assert loss_g.mean() == pytest.approx(loss_w.mean(), rel=RTOL), f"epoch {ep}: loss"
    for ep, (mw, mg) in enumerate(zip(want["metrics"], got["metrics"]), start=1):
        for key in ("nll", "smape"):
            assert mg[key] == pytest.approx(mw[key], rel=RTOL), f"epoch {ep}: val {key}"
    best_w, paths_w = want["result"]
    best_g, paths_g = got["result"]
    assert best_g == pytest.approx(best_w, rel=RTOL)
    assert paths_g["metrics"]["smape"] == pytest.approx(paths_w["metrics"]["smape"], rel=RTOL)
    assert paths_g["metrics"]["best_epoch"] == int(np.argmin(
        [m[want["selection"]] for m in want["metrics"]])) + 1


def assert_same_artifacts(want_dir, got_dir):
    def cfg_of(d):
        with open(d / "config_used.yaml", encoding="utf-8") as f:
            return _without(yaml.safe_load(f), PATH_KEYS)

    assert cfg_of(got_dir) == cfg_of(want_dir)
    for name in ("metadata.json", "model_signature.json"):
        assert metadata.load_json(got_dir / name) == metadata.load_json(want_dir / name), name
    with open(want_dir / "scaler.pkl", "rb") as f:
        want = pickle.load(f)
    with open(got_dir / "scaler.pkl", "rb") as f:
        got = pickle.load(f)
    np.testing.assert_array_equal(got.pop("static_features"), want.pop("static_features"))
    assert got == want


@pytest.fixture(scope="module")
def demand_csv(tmp_path_factory):
    from make_demand_benchmark import write_benchmark

    out = tmp_path_factory.mktemp("demand")
    write_benchmark(str(out), seed=7, n_stores=2, n_menus=4, t_train=150)
    return out / "train.csv"


def test_train_once_matches_jax_on_the_flagship_recipe_shape(monkeypatch, tmp_path, demand_csv):
    want, got = run_both(monkeypatch, demand_config(demand_csv), tmp_path)
    assert_same_runs(want, got)
    # the freeze engages at epoch 3, after the 2-epoch warm-up
    assert [spec is not None for spec, _ in got["epochs"]] == [False, False, True]
    assert_same_artifacts(want["dir"], got["dir"])
    cfg = yaml.safe_load((got["dir"] / "config_used.yaml").read_text(encoding="utf-8"))
    assert cfg["train"]["input_pipeline_effective"] == "device"
    assert cfg["data"]["time_features"]["freq"] == "D"
    assert len(cfg["train"]["min_sigma_vector"]) == 8
