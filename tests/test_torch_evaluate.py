"""The port's ``evaluate_once`` against the JAX package's on the same
artifacts, on the CPU: the direct count-space set and the recursive zscore
set of ``tests/test_torch_predict.py`` (trained by the port's
``train_once``), scored on the last 42 days of the training CSV. The NLL,
sMAPE and wsMAPE within 1e-4 relative, the same window count and holdout,
on the device-resident route (the default: staged, gathered on the device)
and on the host route (``train.input_pipeline: host``); the quantile
calibration's coverage and pinball within 1e-4, nb and normal; the result
saved as JSON where ``evaluation.out_path`` says."""

import copy
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("pandas")

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_predict import one_torch_thread, train_artifact_sets  # noqa: E402,F401

from flow_timesnet_tpu import evaluate as jevaluate  # noqa: E402
from flow_timesnet_tpu_torch import evaluate as pevaluate  # noqa: E402

RTOL = 1e-4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_artifact_sets(tmp_path_factory.mktemp("evaluate"))


def both(cfg, tmp_path):
    """Both packages' results on ``cfg`` (each saving its own JSON)."""

    out = {}
    for side, fn in (("jax", jevaluate.evaluate_once), ("port", pevaluate.evaluate_once)):
        side_cfg = copy.deepcopy(cfg)
        side_cfg.setdefault("evaluation", {})["out_path"] = str(tmp_path / f"{side}.json")
        out[side] = fn(side_cfg)
        with open(tmp_path / f"{side}.json", encoding="utf-8") as f:
            assert json.load(f) == json.loads(json.dumps(out[side]))
    return out["jax"], out["port"]


@pytest.mark.parametrize("pipeline", ["auto", "host"])
@pytest.mark.parametrize("which", ["direct", "recursive"])
def test_metrics_equal_jax(trained, tmp_path, which, pipeline):
    _, sets = trained
    cfg = copy.deepcopy(sets[which])
    cfg["train"]["input_pipeline"] = pipeline
    want, got = both(cfg, tmp_path)
    assert set(got) == set(want) == {"nll", "smape", "wsmape", "windows", "holdout_days"}
    assert (got["windows"], got["holdout_days"]) == (want["windows"], want["holdout_days"])
    assert got["windows"] == 6 * (42 - 35 + 1)
    for key in ("nll", "smape", "wsmape"):
        assert got[key] == pytest.approx(want[key], rel=RTOL), key


@pytest.mark.parametrize("which,method", [("direct", "nb"), ("recursive", "normal")])
def test_quantile_calibration_equal_jax(trained, tmp_path, which, method):
    _, sets = trained
    levels = [0.1, 0.5, 0.9]
    cfg = copy.deepcopy(sets[which])
    cfg["evaluation"] = {"quantiles": levels}
    want, got = both(cfg, tmp_path)
    assert got["quantile_method"] == want["quantile_method"] == method
    assert list(got["quantiles"]) == list(want["quantiles"]) == [str(q) for q in levels]
    for q in got["quantiles"]:
        for key in ("coverage", "pinball"):
            assert got["quantiles"][q][key] == pytest.approx(want["quantiles"][q][key],
                                                             rel=RTOL, abs=1e-4), (q, key)
    coverage = [got["quantiles"][str(q)]["coverage"] for q in levels]
    assert all(0.0 <= c <= 1.0 for c in coverage) and coverage == sorted(coverage)
    # predict.quantiles stands in where evaluation.quantiles is unset
    cfg.pop("evaluation")
    cfg["predict"]["quantiles"] = levels
    assert pevaluate.evaluate_once(cfg)["quantiles"] == got["quantiles"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_metrics_equal_jax(seed):
    """``smape_mean`` and ``wsmape_grouped``: zeros in the actuals (skipped),
    all-zero items (scored 0), store weights and an unweighted store."""

    import numpy as np

    from flow_timesnet_tpu.utils import metrics as jmetrics
    from flow_timesnet_tpu_torch.utils import metrics as pmetrics

    rng = np.random.default_rng(seed)
    y = rng.poisson(3.0, (14, 6)).astype(np.float64)
    y[:, 2] = 0.0
    pred = np.abs(y + rng.normal(0, 1.5, y.shape))
    ids = ["A_1", "A_2", "A_3", "B_1", "B_2", "C"]
    assert pmetrics.smape_mean(y, pred) == jmetrics.smape_mean(y, pred)
    assert pmetrics.smape_mean(np.zeros(3), np.ones(3)) == jmetrics.smape_mean(np.zeros(3),
                                                                              np.ones(3))
    for weights in (None, {"A": 2.0, "B": 1.0}, {"A": 0.0, "B": 0.0, "C": 0.0}):
        assert (pmetrics.wsmape_grouped(y, pred, ids, weights)
                == jmetrics.wsmape_grouped(y, pred, ids, weights))
