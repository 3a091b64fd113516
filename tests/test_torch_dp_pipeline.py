"""``train_once`` and ``predict_once`` on two gloo ranks against the JAX
package's on its mesh, on the CPU.

A generated demand benchmark (2 stores x 4 menus = 8 series, 120 training
days, five TEST files and the sample template,
``tools/make_demand_benchmark.py``) trains a tiny flagship-shaped model
(d_model 8, one layer, 3x3, float32, dropout 0, B=32) for 2 epochs with
``freeze_periods`` after a 1-epoch warm-up. The JAX package's
``train_once`` runs with ``train.data_parallel: auto`` on the suite's 8
virtual devices; the port's on 2 ranks (``parallel/mesh.launch``, from the
JAX run's initial parameters), once with ``shard_embedding: true`` (8 rows
over 2 ranks: 4 a rank) and once with it off. Held to: each epoch's mean
loss and validation NLL and sMAPE within 1e-4 relative, the same frozen
spec on the same epochs, the same best epoch; the artifacts equal to JAX's
(``config_used.yaml`` but its ``artifacts.dir``, ``metadata.json``,
``model_signature.json``, the scaler), the sharded run's checkpoint equal
to the replicated run's within 1e-5. Then ``predict_once`` of the sharded
run's artifacts on the 2 ranks agrees with one process's within one float32
ulp, and with the JAX package's predict of the same artifacts within 1e-4
/ 1e-5.
"""

import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
pd = pytest.importorskip("pandas")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

import torch_dp_worker as worker  # noqa: E402
from test_torch_train_once import assert_same_artifacts  # noqa: E402

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu import predict as jpredict  # noqa: E402
from flow_timesnet_tpu import train as jtrain  # noqa: E402
from flow_timesnet_tpu_torch import predict as ppredict  # noqa: E402
from flow_timesnet_tpu_torch.parallel import mesh  # noqa: E402
from flow_timesnet_tpu_torch.utils import artifacts  # noqa: E402

RTOL = 1e-4


def base_config(data, art_dir, shard):
    return {
        "data": {"train_csv": f"{data}/train.csv", "test_dir": f"{data}/test",
                 "sample_submission": f"{data}/sample_submission.csv", "date_col": "영업일자",
                 "id_col": "영업장명_메뉴명", "target_col": "매출수량", "encoding": "utf-8-sig",
                 "fill_missing_dates": True, "horizon": 7,
                 "time_features": {"enabled": True, "encoding": "cyclical", "normalize": True,
                                   "features": ["day_of_week", "day_of_month", "month",
                                                "day_of_year"]}},
        "preprocess": {"normalize": "none", "clip_negative": True},
        "window": {"input_len": 28, "pred_len": 7},
        "model": {"mode": "direct", "d_model": 8, "d_ff": 16, "n_layers": 1, "k_periods": 2,
                  "min_period_threshold": 7, "kernel_set": [[3, 3]], "dropout": 0.0,
                  "id_embed_dim": 4, "static_proj_dim": 4, "use_zero_mean_context": True,
                  "context_rank": 2, "compute_dtype": "float32"},
        "train": {"device": "cpu", "epochs": 2, "batch_size": 32, "lr": 3e-3,
                  "lr_warmup_steps": 5, "use_loss_masking": True, "ema_decay": 0.9,
                  "grad_clip_norm": 1.0, "freeze_periods": True, "freeze_after_epoch": 1,
                  "data_parallel": "auto", "shard_embedding": "true" if shard else "false",
                  "min_sigma_method": "per_series_median", "min_sigma_scale": 0.05,
                  "val": {"strategy": "holdout", "holdout_days": 42}},
        "predict": {"data_parallel": "auto"},
        "artifacts": {"dir": str(art_dir)},
        "submission": {"out_path": str(art_dir.parent / "submission.csv"), "format": "row_key"},
        "tuning": {"seed": 7},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from make_demand_benchmark import write_benchmark

    root = tmp_path_factory.mktemp("dp_pipeline")
    data = root / "data"
    write_benchmark(str(data), seed=3, n_stores=2, n_menus=4, t_train=120)
    cfgs = {name: base_config(data, root / name, shard) for name, shard in
            (("jax", True), ("sharded", True), ("replicated", False))}

    # the JAX package on its mesh, recording its initial parameters
    jlog = {"epochs": [], "metrics": []}
    epoch, evaluate, init = (jengine.Engine.train_epoch_resident,
                             jengine.Engine.evaluate_resident, jengine.Engine.init_state)
    with pytest.MonkeyPatch.context() as m:
        def train_epoch_resident(self, *args, **kwargs):
            out = epoch(self, *args, **kwargs)
            jlog["epochs"].append((self.cfg.frozen_periods, np.asarray(out[1], np.float64)))
            return out

        def evaluate_resident(self, *args, **kwargs):
            out = evaluate(self, *args, **kwargs)
            jlog["metrics"].append({k: out[k] for k in ("nll", "smape")})
            return out

        def init_state(self, *args, **kwargs):
            state = init(self, *args, **kwargs)
            jlog["init"] = jax.tree_util.tree_map(np.asarray, state.params)
            return state

        m.setattr(jengine.Engine, "train_epoch_resident", train_epoch_resident)
        m.setattr(jengine.Engine, "evaluate_resident", evaluate_resident)
        m.setattr(jengine.Engine, "init_state", init_state)
        best, paths = jtrain.train_once(copy.deepcopy(cfgs["jax"]))
    jlog["result"] = (best, paths["metrics"])

    predict_cfg = copy.deepcopy(cfgs["sharded"])
    predict_cfg["submission"]["out_path"] = str(root / "sub.ranks.csv")
    ranks = mesh.launch(worker.train_and_predict,
                        2, {k: cfgs[k] for k in ("sharded", "replicated")}, jlog["init"],
                        predict_cfg, threads=2)
    return root, cfgs, jlog, ranks


@pytest.mark.parametrize("name", ["sharded", "replicated"])
def test_train_once_on_two_ranks_matches_jax(runs, name):
    root, cfgs, want, ranks = runs
    for r, out in enumerate(ranks):
        got = out[name]
        assert len(got["epochs"]) == len(want["epochs"]) == 2
        for ep, ((spec_w, loss_w), (spec_g, loss_g)) in enumerate(
                zip(want["epochs"], got["epochs"]), start=1):
            assert spec_g == spec_w, f"rank {r} epoch {ep}: frozen spec"
            assert loss_g.mean() == pytest.approx(loss_w.mean(), rel=RTOL), f"epoch {ep} loss"
        for ep, (mw, mg) in enumerate(zip(want["metrics"], got["metrics"]), start=1):
            for key in ("nll", "smape"):
                assert mg[key] == pytest.approx(float(mw[key]), rel=RTOL), f"epoch {ep} {key}"
        best, _, metrics = got["result"]
        assert best == pytest.approx(want["result"][0], rel=RTOL)
        assert metrics["best_epoch"] == int(np.argmin([m["nll"] for m in want["metrics"]])) + 1
    # the freeze engaged at epoch 2 on both sides
    assert want["epochs"][0][0] is None and want["epochs"][1][0] is not None


def test_artifacts_equal_jax_and_the_replicated_run(runs):
    root, cfgs, _, ranks = runs
    assert_same_artifacts(root / "jax", root / "sharded")
    with open(root / "sharded" / "config_used.yaml", encoding="utf-8") as f:
        used = yaml.safe_load(f)
    assert used["train"]["shard_embedding_effective"] is True
    tree_s, _ = artifacts.load_checkpoint(str(root / "sharded" / "timesnet.msgpack"))
    tree_r, _ = artifacts.load_checkpoint(str(root / "replicated" / "timesnet.msgpack"))
    emb = tree_s["series_embedding"]["embedding"]
    assert np.asarray(emb).shape == (8, 4)  # the assembled table

    def leaves(t, prefix=""):
        for k, v in t.items():
            yield from (leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])

    rep = dict(leaves(tree_r))
    for k, v in leaves(tree_s):
        np.testing.assert_allclose(np.asarray(v), np.asarray(rep[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_predict_on_two_ranks_matches_one_process(runs, tmp_path):
    """The two ranks' submission against one process's: the same header,
    keys and order, and every value within one float32 ulp. Not byte for
    byte on the CPU: PyTorch's CPU softplus takes a vectorised path for all
    but a tensor's last elements and a scalar one for those, which round
    differently in the last bit, so a row's rate depends on where the row
    sits in its block (the card's element-wise kernels do not: there
    ``chip_smoke.py`` holds the bytes equal)."""

    root, cfgs, _, ranks = runs
    assert ranks[0]["submission"] == ranks[1]["submission"]
    two = ranks[0]["submission"]
    cfg = copy.deepcopy(cfgs["sharded"])
    cfg["submission"]["out_path"] = str(tmp_path / "sub.one.csv")
    one = pd.read_csv(ppredict.predict_once(cfg), encoding="utf-8-sig")
    got = pd.read_csv(two, encoding="utf-8-sig")
    assert list(got.columns) == list(one.columns)
    assert list(got.iloc[:, 0]) == list(one.iloc[:, 0])
    np.testing.assert_array_max_ulp(got.iloc[:, 1:].to_numpy(np.float32),
                                    one.iloc[:, 1:].to_numpy(np.float32), maxulp=1)
    cfg["submission"]["out_path"] = str(tmp_path / "sub.jax.csv")
    cfg["predict"]["data_parallel"] = "off"
    want = pd.read_csv(jpredict.predict_once(cfg), encoding="utf-8-sig")
    got = pd.read_csv(two, encoding="utf-8-sig")
    assert list(got.columns) == list(want.columns)
    assert list(got.iloc[:, 0]) == list(want.iloc[:, 0])
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(float), want.iloc[:, 1:].to_numpy(float),
                               rtol=1e-4, atol=1e-5)
