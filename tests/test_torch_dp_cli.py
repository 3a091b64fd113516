"""``cli tune`` on two ranks started as ``torchrun`` starts them (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), on the
CPU, against the same study in one process.

A generated demand CSV (2 stores x 2 menus), a narrow one-layer model for
one epoch, ``train.lr`` and ``train.ema_decay`` searched at random over two
trials: each rank trains every trial on its rows (``train_once`` under
data parallelism), the samplers agree, and rank 0 alone logs and writes
``best_params.json`` and ``best_config.yaml``. The study's best value
within 1e-4 relative of the one-process study's, the same parameters.
"""

import copy
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pandas")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from flow_timesnet_tpu_torch import cli  # noqa: E402
from flow_timesnet_tpu_torch.config import save_yaml  # noqa: E402
from flow_timesnet_tpu_torch.parallel import mesh  # noqa: E402

from test_torch_train_once import demand_config, one_torch_thread  # noqa: E402,F401


def test_cli_tune_on_two_ranks_from_torchruns_environment(tmp_path):
    from make_demand_benchmark import write_benchmark

    write_benchmark(str(tmp_path / "data"), seed=7, n_stores=2, n_menus=2, t_train=110)
    cfg = demand_config(tmp_path / "data" / "train.csv", epochs=1)
    cfg["model"]["n_layers"] = 1
    cfg["train"].update(freeze_periods=False, data_parallel="auto")
    cfg["tuning"].update(sampler="random", objective="val_nll")
    space = tmp_path / "space.yaml"
    save_yaml({"train.lr": {"low": 1e-4, "high": 3e-3, "log": True, "type": "float"},
               "train.ema_decay": {"choices": [0.0, 0.9], "type": "categorical"}}, str(space))
    results = {}
    for name in ("one", "ranks"):
        run = copy.deepcopy(cfg)
        run["artifacts"]["dir"] = str(tmp_path / name)
        save_yaml(run, str(tmp_path / f"{name}.yaml"))
        argv = ["tune", "--config", str(tmp_path / f"{name}.yaml"), "--search-space",
                str(space), "--n-trials", "2"]
        if name == "one":
            cli.main(argv)
        else:
            port = mesh.free_port()
            procs = []
            for r in range(2):
                env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                           MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "flow_timesnet_tpu_torch.cli", *argv], cwd=REPO,
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            outs = [p.communicate(timeout=300)[0] for p in procs]
            for p, out in zip(procs, outs):
                assert p.returncode == 0, out[-3000:]
            assert "Data parallel: batch 32 sharded over mesh {'data': 2}" in outs[0]
            assert "Best trial:" in outs[0] and "Best trial:" not in outs[1]
        with open(tmp_path / name / "best_params.json") as f:
            results[name] = json.load(f)
    one, ranks = results["one"], results["ranks"]
    assert ranks["best_params"] == one["best_params"]
    assert ranks["best_value"] == pytest.approx(one["best_value"], rel=1e-4)
    assert (tmp_path / "ranks" / "best_config.yaml").is_file()


def test_cli_train_and_predict_as_the_cli_spawns_its_ranks(tmp_path):
    """What ``cli train`` and ``cli predict`` run on each rank they spawn,
    one per card (``cli._rank_command`` under ``mesh.launch``), here on two
    gloo ranks on the CPU: rank 0 writes the artifacts and the submission,
    whose values agree with one process's predict of the same artifacts
    within one float32 ulp (see ``tests/test_torch_dp_pipeline.py``)."""

    import numpy as np
    import pandas as pd

    from make_demand_benchmark import write_benchmark

    write_benchmark(str(tmp_path / "data"), seed=3, n_stores=2, n_menus=2, t_train=110)
    cfg = demand_config(tmp_path / "data" / "train.csv", epochs=1)
    cfg["model"]["n_layers"] = 1
    cfg["data"].update(test_dir=str(tmp_path / "data" / "test"),
                       sample_submission=str(tmp_path / "data" / "sample_submission.csv"))
    cfg["train"].update(freeze_periods=False, data_parallel="auto")
    cfg["artifacts"]["dir"] = str(tmp_path / "artifacts")
    save_yaml(cfg, str(tmp_path / "cfg.yaml"))
    base = ["--config", str(tmp_path / "cfg.yaml"), "--override"]
    mesh.launch(cli._rank_command, 2, ["train", *base], threads=1)
    assert (tmp_path / "artifacts" / "timesnet.msgpack").is_file()
    mesh.launch(cli._rank_command, 2,
                ["predict", *base, f"submission.out_path={tmp_path / 'two.csv'}"], threads=1)
    cli.main(["predict", *base, f"submission.out_path={tmp_path / 'one.csv'}"])
    two, one = (pd.read_csv(tmp_path / f"{n}.csv", encoding="utf-8-sig") for n in ("two", "one"))
    assert list(two.columns) == list(one.columns) and list(two.iloc[:, 0]) == list(one.iloc[:, 0])
    np.testing.assert_array_max_ulp(two.iloc[:, 1:].to_numpy(np.float32),
                                    one.iloc[:, 1:].to_numpy(np.float32), maxulp=1)
