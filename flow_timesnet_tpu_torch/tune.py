"""Hyper-parameter search around ``train_once`` (counterpart of
``flow_timesnet_tpu/tune.py``).

Optuna is used where it is importable; otherwise the in-repo samplers run:
a seeded random search (``tuning.sampler: random``) or the TPE of
``tpe.py`` (any other sampler), each with the per-epoch
:class:`MedianPruner` unless ``tuning.pruner: none``. The search-space YAML
holds typed specs by dotted config path: int ranges with an optional step,
float ranges with an optional ``log``, and ``categorical`` choices.
``tuning.objective`` is ``val_nll`` (default) or ``val_smape``, both the
value at the selected checkpoint; ``tuning.timeout_min`` caps the study's
wall clock. Each trial trains from scratch (``train.resume`` off), a
diverged trial (``FloatingPointError``) scores ``inf``, and
``best_params.json`` and ``best_config.yaml`` are written into the
artifacts directory on every improvement and at the end, as the JAX
package writes them.

Under data parallelism (a group of ``parallel/mesh.py``; ``cli tune``
spawns one rank per visible card) every trial's ``train_once`` runs on
every rank. The sampler runs on every rank from the same seed and history,
and each suggestion is checked against rank 0's; the timeout and each
pruning are rank 0's decisions; rank 0 alone writes ``best_params.json``
and ``best_config.yaml``.

Between trials everything a trial held on the card is released: its
engines, CUDA graphs and their memory pools, its staged folds and
parameters are garbage once ``train_once`` returns, and are collected
before the next trial starts.
"""

from __future__ import annotations

import gc
import math
import os
import random
import time
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from .config import PipelineConfig, load_yaml, save_yaml
from .parallel import mesh
from .train import train_once
from .utils.metadata import save_json

try:  # optuna where the environment has it; the in-repo samplers otherwise
    import optuna

    HAS_OPTUNA = True
except ImportError:
    optuna = None
    HAS_OPTUNA = False


def _log(msg: str) -> None:
    if mesh.is_main():
        print(msg, flush=True)


def _same_on_every_rank(params: Mapping[str, Any]) -> Dict[str, Any]:
    """``params``, checked equal to rank 0's suggestion: ranks that
    trained different trials would deadlock in their first collective."""

    first = mesh.broadcast_object(dict(params))
    if first != dict(params):
        raise RuntimeError(f"rank {mesh.rank()} suggested {dict(params)}, rank 0 {first}")
    return dict(params)


def _set_dotted(cfg: Dict[str, Any], path: str, value: Any) -> None:
    node = cfg
    parts = path.split(".")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _sample_spec(rng: random.Random, spec: Mapping[str, Any]) -> Any:
    kind = str(spec.get("type", "float"))
    if kind == "categorical":
        return rng.choice(list(spec["choices"]))
    if kind == "int":
        low, high = int(spec["low"]), int(spec["high"])
        step = int(spec.get("step", 1))
        n = (high - low) // step
        return low + rng.randint(0, n) * step
    low, high = float(spec["low"]), float(spec["high"])
    if spec.get("log"):
        return math.exp(rng.uniform(math.log(low), math.log(high)))
    return rng.uniform(low, high)


def _suggest_optuna(trial, path: str, spec: Mapping[str, Any]) -> Any:
    kind = str(spec.get("type", "float"))
    if kind == "categorical":
        return trial.suggest_categorical(path, list(spec["choices"]))
    if kind == "int":
        return trial.suggest_int(
            path, int(spec["low"]), int(spec["high"]), step=int(spec.get("step", 1))
        )
    return trial.suggest_float(
        path, float(spec["low"]), float(spec["high"]), log=bool(spec.get("log", False))
    )


class MedianPruner:
    """Per-epoch median pruning for the in-repo samplers (the optuna
    ``MedianPruner`` analogue, wired through ``train_once``'s ``epoch_hook``).

    A trial stops as soon as its best-so-far selection value at epoch k is
    worse than the median of the previous trials' best-so-far values at
    epoch k. The first ``n_startup`` trials and the first ``warmup_epochs``
    epochs are never pruned. Peers that stopped before epoch k contribute
    their final best.
    """

    def __init__(self, n_startup: int = 4, warmup_epochs: int = 3) -> None:
        self.n_startup = int(n_startup)
        self.warmup_epochs = int(warmup_epochs)
        self._histories: List[Dict[int, float]] = []

    @staticmethod
    def _best_up_to(history: Mapping[int, float], ep: int) -> float | None:
        vals = [v for e, v in history.items() if e <= ep]
        return min(vals) if vals else None

    def hook(self):
        """A fresh per-trial ``epoch_hook(ep, value) -> should_stop``."""

        completed = list(self._histories)  # previous trials only
        hist: Dict[int, float] = {}
        self._histories.append(hist)

        def epoch_hook(ep: int, value: float) -> bool:
            hist[ep] = float(value)
            if len(completed) < self.n_startup or ep <= self.warmup_epochs:
                return False
            peers = [b for h in completed if (b := self._best_up_to(h, ep)) is not None]
            if len(peers) < self.n_startup:
                return False
            mine = self._best_up_to(hist, ep)
            return mine is not None and mine > float(np.median(peers))

        return epoch_hook


def _release_device() -> None:
    """Collect what the last trial left (its engines and graphs sit in
    reference cycles, a diverged trial's in its traceback's frames) and hand
    the freed blocks back from the caching allocator."""

    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _train_trial(cfg: PipelineConfig, epoch_hook) -> tuple:
    """``train_once`` of one trial, or ``(inf, None)`` where it diverged."""

    try:
        return train_once(cfg, epoch_hook=epoch_hook)
    except FloatingPointError as err:
        # a diverged trial is a valid (terrible) observation for the sampler,
        # not a reason to end the study
        _log(f"trial diverged: {err}")
        return float("inf"), None


def tune(
    base_cfg: PipelineConfig,
    search_space_path: str,
    n_trials: int | None = None,
    out_dir: str | None = None,
) -> Dict[str, Any]:
    space: Dict[str, Mapping[str, Any]] = load_yaml(search_space_path) or {}
    tuning_cfg = dict(base_cfg.raw.get("tuning") or {})
    trials = int(n_trials or tuning_cfg.get("n_trials", 30))
    seed = int(tuning_cfg.get("seed", 2025))
    out_dir = out_dir or base_cfg.raw.get("artifacts", {}).get("dir", "outputs/artifacts")
    os.makedirs(out_dir, exist_ok=True)

    # val_nll, or val_smape: pair it with train.selection_metric: smape and
    # the tuner optimises what checkpoint selection optimises
    objective_key = str(tuning_cfg.get("objective", "val_nll")).lower()
    if objective_key not in ("val_nll", "nll", "val_smape", "smape"):
        raise ValueError(
            f"tuning.objective must be val_nll or val_smape, got {objective_key!r}"
        )

    def run_with(params: Mapping[str, Any], epoch_hook=None) -> float:
        params = _same_on_every_rank(params)
        cfg_dict = base_cfg.to_dict()
        for path, value in params.items():
            _set_dotted(cfg_dict, path, value)
        # trials share one artifacts directory: none may resume from the
        # training state the last one left there
        cfg_dict.setdefault("train", {})["resume"] = False
        best_nll, info = _train_trial(PipelineConfig.from_mapping(cfg_dict), epoch_hook)
        _release_device()
        if info is not None and objective_key in ("val_smape", "smape"):
            return float(info["metrics"]["smape"])
        return float(best_nll)

    timeout_min = tuning_cfg.get("timeout_min")
    timeout_s = float(timeout_min) * 60.0 if timeout_min is not None else None
    t_start = time.monotonic()

    def _timed_out() -> bool:
        late = timeout_s is not None and (time.monotonic() - t_start) >= timeout_s
        return bool(mesh.agree([float(late)])[0])

    def _persist_best(value: float, params: Mapping[str, Any]) -> None:
        # on every improvement, so that a study cut mid-trial leaves its best so far
        if not mesh.is_main():
            return
        save_json({"best_value": value, "objective": objective_key, "best_params": params},
                  os.path.join(out_dir, "best_params.json"))
        cfg_out = base_cfg.to_dict()
        for path, v in params.items():
            _set_dotted(cfg_out, path, v)
        save_yaml(PipelineConfig.from_mapping(cfg_out).to_dict(),
                  os.path.join(out_dir, "best_config.yaml"))

    sampler_name = str(tuning_cfg.get("sampler", "tpe")).lower()
    if HAS_OPTUNA:
        if sampler_name.startswith("random"):
            sampler = optuna.samplers.RandomSampler(seed=seed)
        else:
            sampler = optuna.samplers.TPESampler(
                seed=seed, multivariate="multivariate" in sampler_name
            )
        pruner = (
            optuna.pruners.MedianPruner()
            if tuning_cfg.get("pruner", "median") == "median"
            else optuna.pruners.NopPruner()
        )
        study = optuna.create_study(direction="minimize", sampler=sampler, pruner=pruner)

        def objective(trial):
            params = {path: _suggest_optuna(trial, path, spec) for path, spec in space.items()}

            def epoch_hook(ep: int, value: float) -> bool:
                # per-epoch reports, so that the pruner has curves to prune on
                trial.report(float(value), step=int(ep))
                return bool(trial.should_prune())

            value = run_with(params, epoch_hook=epoch_hook)
            if trial.should_prune():
                raise optuna.TrialPruned()
            return value

        if mesh.world() > 1:  # the timeout is rank 0's decision: one trial at a time
            for _ in range(trials):
                if _timed_out():
                    break
                study.optimize(objective, n_trials=1)
        else:
            study.optimize(objective, n_trials=trials, timeout=timeout_s)
        best_params = dict(study.best_params)
        best_value = float(study.best_value)
    else:
        pruner = (
            MedianPruner()
            if str(tuning_cfg.get("pruner", "median")).lower() == "median"
            else None
        )
        if sampler_name.startswith("random"):
            _log("built-in seeded random search.")
            rng = random.Random(seed)

            def suggest() -> Dict[str, Any]:
                return {path: _sample_spec(rng, spec) for path, spec in space.items()}

            def observe(value: float, params: Dict[str, Any]) -> None:
                pass
        else:
            from .tpe import TPESampler

            _log("optuna unavailable; using the built-in TPE sampler.")
            tpe = TPESampler(space, seed=seed, n_startup=min(5, max(2, trials // 3)))
            suggest, observe = tpe.suggest, tpe.observe
        best_params: Dict[str, Any] = {}
        best_value = float("inf")
        for i in range(trials):
            if _timed_out():
                _log("tuning.timeout_min reached; stopping.")
                break
            params = suggest()
            value = run_with(params, epoch_hook=pruner.hook() if pruner else None)
            observe(value, params)
            _log(f"trial {i + 1}/{trials}: {objective_key}={value:.6f} {params}")
            if value < best_value:
                best_value = value
                best_params = dict(params)
                _persist_best(best_value, best_params)

    _persist_best(best_value, best_params)
    mesh.barrier()  # the files exist when any rank returns
    _log(f"Best trial: {objective_key}={best_value:.6f} params={best_params}")
    return {"best_value": best_value, "best_params": best_params}
