"""The port's hyper-parameter search (``tune.py``, ``tpe.py``, ``cli tune``)
against the JAX package's, on the CPU.

- ``TPESampler``: the same suggestions as the JAX package's over 30
  observations on each shipped search space (same seed, same values).
- ``MedianPruner``: the same decisions on the same seeded trial curves.
- ``tune`` with ``train_once`` replaced in both packages by one
  deterministic objective (a hash of the trial's parameters read back from
  its config): ``best_params.json`` and ``best_config.yaml`` byte for byte
  the JAX package's, in the random and the TPE branch, on the flagship
  recipe and ``configs/search_space_flagship3.yaml`` (nested lists, dotted
  paths into ``data.augment``); the optuna branch through a stand-in module,
  as ``tests/test_tune.py`` drives the JAX package's; a diverged trial
  scoring ``inf``; ``tuning.timeout_min`` on a stepped clock.
- One real two-trial study of a narrow model on a generated demand CSV in
  both packages, the port on the JAX run's initial weights: each trial's
  value within 1e-4 relative.
- ``cli tune`` on a written config and search space.
"""

import copy
import json
import math
import os
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
pytest.importorskip("pandas")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.dirname(__file__))

import flow_timesnet_tpu.tune as jtune  # noqa: E402
from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu import tpe as jtpe  # noqa: E402
from flow_timesnet_tpu.config import PipelineConfig as JConfig  # noqa: E402
from flow_timesnet_tpu_torch import cli, convert, tpe  # noqa: E402
from flow_timesnet_tpu_torch import tune as ptune  # noqa: E402
from flow_timesnet_tpu_torch.config import PipelineConfig, save_yaml  # noqa: E402

from test_torch_train_once import demand_config, one_torch_thread  # noqa: E402,F401

SPACES = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                if f.startswith("search_space"))
RECIPE = os.path.join(REPO, "configs", "demand_benchmark.yaml")
FLAGSHIP3 = os.path.join(REPO, "configs", "search_space_flagship3.yaml")


def _space(name):
    with open(os.path.join(REPO, "configs", name), encoding="utf-8") as f:
        return yaml.safe_load(f)


def _value(params):
    """A deterministic objective of a trial's parameters, in [0, 1)."""

    return zlib.crc32(repr(sorted(params.items())).encode()) / 2**32


def _dotted(raw, path):
    node = raw
    for part in path.split("."):
        node = node[part]
    return node


def _fake_train_once(space, log, diverge=lambda params: False):
    """``train_once`` replaced: the objective of the parameters the trial's
    config carries, reported to ``epoch_hook`` over two epochs."""

    def train_once(cfg, epoch_hook=None):
        params = {path: _dotted(cfg.raw, path) for path in space}
        log.append((params, cfg.raw["train"]["resume"]))
        if diverge(params):
            raise FloatingPointError("diverged")
        value = _value(params)
        for ep in (1, 2):
            if epoch_hook is not None and epoch_hook(ep, value + 1.0 / ep):
                break
        return value, {"metrics": {"smape": value / 2}}

    return train_once


@pytest.mark.parametrize("name", SPACES)
def test_tpe_suggestions_equal_jax(name):
    space = _space(name)
    want, got = jtpe.TPESampler(space, seed=3, n_startup=5), tpe.TPESampler(space, seed=3,
                                                                             n_startup=5)
    for _ in range(30):
        params = want.suggest()
        assert got.suggest() == params
        want.observe(_value(params), params)
        got.observe(_value(params), params)


def test_median_pruner_decisions_equal_jax():
    rng = np.random.default_rng(0)
    pruners = (jtune.MedianPruner(n_startup=3, warmup_epochs=1),
               ptune.MedianPruner(n_startup=3, warmup_epochs=1))
    decisions = {0: [], 1: []}
    for _ in range(12):
        hooks = [p.hook() for p in pruners]
        curve = np.cumsum(rng.uniform(-0.3, 0.2, size=8)) + rng.uniform(0, 1)
        for side, hook in enumerate(hooks):
            for ep, value in enumerate(curve, start=1):
                stop = hook(ep, float(value))
                decisions[side].append(stop)
                if stop:
                    break
    assert decisions[1] == decisions[0] and any(decisions[0]) and not all(decisions[0])


def _study(monkeypatch, tmp_path, sampler, trials, **tuning):
    """``tune`` of each package on the flagship recipe and phase 3's space,
    ``train_once`` replaced by the same objective: {side: (result, log, dir)}."""

    space = _space("search_space_flagship3.yaml")
    out = {}
    for side, mod, cfg_cls in (("jax", jtune, JConfig), ("port", ptune, PipelineConfig)):
        base = cfg_cls.from_files(RECIPE, overrides=[f"tuning.sampler={sampler}"] + [
            f"tuning.{k}={v}" for k, v in tuning.items()])
        log = []
        with monkeypatch.context() as m:
            m.setattr(mod, "HAS_OPTUNA", False)
            m.setattr(mod, "train_once", _fake_train_once(space, log))
            result = mod.tune(base, FLAGSHIP3, n_trials=trials, out_dir=str(tmp_path / side))
        out[side] = (result, log, tmp_path / side)
    return out


@pytest.mark.parametrize("sampler", ["random", "tpe_multivariate"])
def test_study_files_are_byte_for_byte_jax(monkeypatch, tmp_path, sampler):
    out = _study(monkeypatch, tmp_path, sampler, 8)
    (want, want_log, want_dir), (got, got_log, got_dir) = out["jax"], out["port"]
    assert got_log == want_log and len(got_log) == 8
    assert all(resume is False for _, resume in got_log)
    assert got == want and math.isfinite(got["best_value"])
    for name in ("best_params.json", "best_config.yaml"):
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name
    best = PipelineConfig.from_files(str(got_dir / "best_config.yaml"))
    assert best.raw["data"]["augment"] == {
        k.split(".")[-1]: v for k, v in got["best_params"].items() if k.startswith("data.")}


def test_a_diverged_trial_scores_inf(monkeypatch, tmp_path):
    space = _space("search_space_flagship3.yaml")
    log = []
    monkeypatch.setattr(ptune, "HAS_OPTUNA", False)
    monkeypatch.setattr(ptune, "train_once", _fake_train_once(
        space, log, diverge=lambda params: len(log) % 2 == 1))
    values = []
    observe = tpe.TPESampler.observe
    monkeypatch.setattr(tpe.TPESampler, "observe",
                        lambda self, v, p: values.append(v) or observe(self, v, p))
    base = PipelineConfig.from_files(RECIPE)
    result = ptune.tune(base, FLAGSHIP3, n_trials=4, out_dir=str(tmp_path))
    assert [math.isinf(v) for v in values] == [True, False, True, False]
    assert math.isfinite(result["best_value"]) and result["best_value"] == min(values)
    saved = json.loads((tmp_path / "best_params.json").read_text())
    assert saved["best_value"] == result["best_value"]


class _SteppedClock:
    """``time`` with a ``monotonic`` that moves 30 s at each trial."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now


@pytest.mark.parametrize("minutes,trials", [("1", 2), ("0", 0), ("null", 5)])
def test_timeout_min_is_honoured(monkeypatch, tmp_path, minutes, trials):
    space = _space("search_space_flagship.yaml")
    ran = {}
    for side, mod, cfg_cls in (("jax", jtune, JConfig), ("port", ptune, PipelineConfig)):
        clock, log = _SteppedClock(), []
        fake = _fake_train_once(space, log)

        def timed(cfg, epoch_hook=None, fake=fake, clock=clock):
            clock.now += 30.0
            return fake(cfg, epoch_hook)

        base = cfg_cls.from_files(RECIPE, overrides=["tuning.sampler=random",
                                                     f"tuning.timeout_min={minutes}"])
        with monkeypatch.context() as m:
            m.setattr(mod, "HAS_OPTUNA", False)
            m.setattr(mod, "train_once", timed)
            m.setattr(mod, "time", clock)
            mod.tune(base, os.path.join(REPO, "configs", "search_space_flagship.yaml"),
                     n_trials=5, out_dir=str(tmp_path / side))
        ran[side] = log
    assert ran["port"] == ran["jax"] and len(ran["port"]) == trials


def test_optuna_branch_with_a_stand_in(monkeypatch, tmp_path):
    """The optuna branch through a stand-in module (``tests/test_tune.py``'s
    for the JAX package): the sampler and pruner it asks for, each trial's
    per-epoch reports, a pruned trial raising ``TrialPruned``."""

    class Trial:
        def __init__(self, rng, prune):
            self.rng, self.prune = rng, prune
            self.params, self.reported = {}, {}

        def report(self, value, step):
            self.reported[step] = value

        def should_prune(self):
            return self.prune and len(self.reported) >= 1

        def suggest_categorical(self, name, choices):
            self.params[name] = choices[int(self.rng.integers(len(choices)))]
            return self.params[name]

        def suggest_int(self, name, low, high, step=1):
            self.params[name] = int(low + self.rng.integers(0, (high - low) // step + 1) * step)
            return self.params[name]

        def suggest_float(self, name, low, high, log=False):
            self.params[name] = float(self.rng.uniform(low, high))
            return self.params[name]

    class Study:
        def __init__(self):
            self.best_value, self.best_params, self.trials, self.pruned = None, {}, [], 0

        def optimize(self, objective, n_trials, timeout=None):
            rng = np.random.default_rng(0)
            for i in range(n_trials):
                trial = Trial(rng, prune=i == 1)
                self.trials.append(trial)
                try:
                    value = objective(trial)
                except FakeOptuna.TrialPruned:
                    self.pruned += 1
                    continue
                if self.best_value is None or value < self.best_value:
                    self.best_value, self.best_params = value, dict(trial.params)

    class FakeOptuna:
        class TrialPruned(Exception):
            pass

        made = []

        class samplers:
            @staticmethod
            def TPESampler(seed=None, multivariate=False):
                FakeOptuna.made.append(("tpe", seed, multivariate))

            @staticmethod
            def RandomSampler(seed=None):
                FakeOptuna.made.append(("random", seed))

        class pruners:
            @staticmethod
            def MedianPruner():
                FakeOptuna.made.append("median")

            @staticmethod
            def NopPruner():
                FakeOptuna.made.append("nop")

        study = None

        @classmethod
        def create_study(cls, direction, sampler, pruner):
            assert direction == "minimize"
            cls.study = Study()
            return cls.study

    space = _space("search_space_flagship.yaml")
    log = []
    monkeypatch.setattr(ptune, "optuna", FakeOptuna)
    monkeypatch.setattr(ptune, "HAS_OPTUNA", True)
    monkeypatch.setattr(ptune, "train_once", _fake_train_once(space, log))
    base = PipelineConfig.from_files(RECIPE, overrides=["tuning.sampler=tpe_multivariate"])
    result = ptune.tune(base, os.path.join(REPO, "configs", "search_space_flagship.yaml"),
                        n_trials=3, out_dir=str(tmp_path))
    study = FakeOptuna.study
    assert FakeOptuna.made == [("tpe", 2025, True), "median"]
    assert [list(t.reported) for t in study.trials] == [[1, 2], [1], [1, 2]]
    assert study.pruned == 1 and result["best_value"] == study.best_value
    assert set(result["best_params"]) == set(space)
    saved = json.loads((tmp_path / "best_params.json").read_text())
    assert saved == {"best_value": study.best_value, "objective": "val_nll",
                     "best_params": study.best_params}


def test_a_real_study_matches_jax(monkeypatch, tmp_path):
    """Two trials of ``train_once`` on a generated demand CSV (4 series), a
    narrow one-layer model for one epoch, lr and EMA searched at random in
    both packages; the port's trials start from the JAX trials' initial
    weights. The same parameters, and each trial's value within 1e-4
    relative."""

    from make_demand_benchmark import write_benchmark

    write_benchmark(str(tmp_path / "data"), seed=7, n_stores=2, n_menus=2, t_train=110)
    cfg = demand_config(tmp_path / "data" / "train.csv", epochs=1)
    cfg["model"]["n_layers"] = 1
    cfg["train"]["freeze_periods"] = False
    cfg["tuning"].update(sampler="random", objective="val_smape")
    space_path = tmp_path / "space.yaml"
    save_yaml({"train.lr": {"low": 1e-4, "high": 3e-3, "log": True, "type": "float"},
               "train.ema_decay": {"choices": [0.0, 0.9], "type": "categorical"}},
              str(space_path))
    runs, inits = {}, []
    for side, mod, cfg_cls in (("jax", jtune, JConfig), ("port", ptune, PipelineConfig)):
        values = []
        run = copy.deepcopy(cfg)
        run["artifacts"]["dir"] = str(tmp_path / side)
        with monkeypatch.context() as m:
            m.setattr(mod, "HAS_OPTUNA", False)
            train_once = mod.train_once

            def recorded(trial_cfg, epoch_hook=None, train_once=train_once, values=values):
                out = train_once(trial_cfg, epoch_hook=epoch_hook)
                values.append((out[0], out[1]["metrics"]["smape"]))
                return out

            m.setattr(mod, "train_once", recorded)
            if side == "jax":
                init_state = jengine.Engine.init_state

                def capture(self, *args, **kwargs):
                    state = init_state(self, *args, **kwargs)
                    inits.append(jax.tree_util.tree_map(np.asarray, state.params))
                    return state

                m.setattr(jengine.Engine, "init_state", capture)
            else:
                trees = iter(list(inits))
                m.setattr(convert, "init_params",
                          lambda tn_cfg, generator: convert.params_from_jax(next(trees), tn_cfg))
            result = mod.tune(cfg_cls.from_mapping(run), str(space_path), n_trials=2)
        runs[side] = (result, values)
    (want, want_values), (got, got_values) = runs["jax"], runs["port"]
    assert len(inits) == len(got_values) == len(want_values) == 2
    assert got["best_params"] == want["best_params"]
    for (nll_g, smape_g), (nll_w, smape_w) in zip(got_values, want_values):
        assert nll_g == pytest.approx(nll_w, rel=1e-4)
        assert smape_g == pytest.approx(smape_w, rel=1e-4)
    assert got["best_value"] == pytest.approx(want["best_value"], rel=1e-4)


def test_cli_tune_writes_the_study(monkeypatch, tmp_path):
    space = _space("search_space_flagship.yaml")
    log = []
    monkeypatch.setattr(ptune, "HAS_OPTUNA", False)
    monkeypatch.setattr(ptune, "train_once", _fake_train_once(space, log))
    cli.main(["tune", "--config", RECIPE, "--search-space",
              os.path.join(REPO, "configs", "search_space_flagship.yaml"), "--n-trials", "3",
              "--override", f"artifacts.dir={tmp_path}", "train.device=cpu"])
    assert len(log) == 3
    saved = json.loads((tmp_path / "best_params.json").read_text())
    assert saved["best_value"] == min(_value(p) for p, _ in log)
    best = PipelineConfig.from_files(str(tmp_path / "best_config.yaml"))
    assert best.raw["train"]["device"] == "cpu"
    assert {k: _dotted(best.raw, k) for k in space} == saved["best_params"]
    args = cli.build_parser().parse_args(["tune"])
    assert args.search_space == "configs/search_space.yaml" and args.n_trials is None


# each shipped search space and the recipe it tunes
SPACE_RECIPES = {"search_space.yaml": "default.yaml",
                 "search_space_flagship.yaml": "demand_benchmark.yaml",
                 "search_space_flagship2.yaml": "demand_benchmark.yaml",
                 "search_space_flagship3.yaml": "demand_benchmark.yaml",
                 "search_space_long_context.yaml": "long_context.yaml"}


def _values(space, recipe, path):
    """Every value ``path`` takes in a study of ``space`` on ``recipe``."""

    spec = space.get(path)
    if spec is None:
        return [_dotted(recipe, path)]
    if spec.get("type") == "categorical":
        return list(spec["choices"])
    return list(range(int(spec["low"]), int(spec["high"]) + 1, int(spec.get("step", 1))))


@pytest.mark.parametrize("name", sorted(SPACE_RECIPES))
def test_bf16_plans_take_every_shape_a_search_space_reaches(name):
    """The bf16 fold-conv kernels' plan mirrors (forward and dh:
    ``fold_mma_plan``; dW: ``dw_mma_plan``, both bands) accept every shape a
    study of the space reaches: the branches' bottleneck width
    ``ceil(min(d_model, d_ff) / bottleneck_ratio)``, each kernel size, K =
    k_periods, the batch, and Lp = 2L - 1 at p_cap L - 1 on the dynamic
    path, or the exact extent of a frozen period (K = 1)."""

    from flow_timesnet_tpu_torch.ops import cuda_fold

    space = _space(name)
    with open(os.path.join(REPO, "configs", SPACE_RECIPES[name]), encoding="utf-8") as f:
        recipe = yaml.safe_load(f)
    ratio = float(recipe["model"]["bottleneck_ratio"])
    mids = {math.ceil(min(dm, dff) / ratio)
            for dm in _values(space, recipe, "model.d_model")
            for dff in _values(space, recipe, "model.d_ff")}
    sizes = {tuple(k) for ks in _values(space, recipe, "model.kernel_set") for k in ks}
    shapes = set()
    for L in _values(space, recipe, "model.input_len"):
        extents = [(1, L + (-L) % p, p) for p in (7, 14, 24, 25, 27, 168, 171) if p < L]
        for K in _values(space, recipe, "model.k_periods"):
            for B in _values(space, recipe, "train.batch_size"):
                for k, lp, p_max in [(K, 2 * L - 1, L - 1)] + extents:
                    shapes |= {(k, B, lp, c, kh, kw, p_max) for c in mids for kh, kw in sizes}
    for K, B, Lp, c, kh, kw, p_max in sorted(shapes):
        for sign in (1, -1):
            cuda_fold.fold_mma_plan(sign, K, B, Lp, c, c, kh, kw, p_max)
        cuda_fold.dw_mma_plan(K, B, Lp, c, c, kh, kw, p_max)
    assert len(shapes) >= 16
