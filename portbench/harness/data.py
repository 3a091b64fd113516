"""A configuration's data: the series its generator makes, the training
fold and its per-series inputs, and the serving requests.

Everything here is made by the benchmark and handed, the same, to the
program and to the reference: the series, the scaler's statistics, the
static features, the dispersion floors and the training fold's calendar
features. What the program derives from them inside its own entry points
(the staged folds, a request's scaling and calendar features) the
reference works out again from these.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from portbench.harness import generators
from portbench.reference import inputs


@dataclass
class Dataset:
    stamps: np.ndarray  # [T] datetime64
    values: np.ndarray  # [T, N] float32, 0 where not observed
    observed: np.ndarray  # [T, N] float32
    ids: list
    mean: Optional[np.ndarray]  # [N] z-score statistics of the training fold, or None
    std: Optional[np.ndarray]
    train_end: int  # the training fold is [0, train_end)
    static: np.ndarray  # [N, 5] float32
    floors: np.ndarray  # [N] float32 dispersion floors in model space
    features: list  # calendar feature names
    freq: str


def static_features(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[N, 5]: masked mean, std and first-difference std, the share of the
    strongest non-DC rFFT bin in the non-DC power, and the period of that
    bin."""

    T = values.shape[0]
    count = np.maximum(mask.sum(axis=0), 1.0)
    mean = (values * mask).sum(axis=0) / count
    std = np.sqrt((((values - mean) * mask) ** 2).sum(axis=0) / count)
    diff, dmask = np.diff(values, axis=0), mask[1:] * mask[:-1]
    dcount = np.maximum(dmask.sum(axis=0), 1.0)
    dmean = (diff * dmask).sum(axis=0) / dcount
    dstd = np.sqrt((((diff - dmean) * dmask) ** 2).sum(axis=0) / dcount)
    power = np.abs(np.fft.rfft(np.where(mask > 0, values - mean, 0.0), axis=0))[1:] ** 2
    peak = power.argmax(axis=0)
    strength = power.max(axis=0) / np.maximum(power.sum(axis=0), 1e-6)
    period = T / (peak + 1.0)
    return np.stack([mean, std, dstd, strength, period], axis=1).astype(np.float32)


def dataset(config: dict) -> Dataset:
    """The configuration's series, made by ``data.generator`` from
    ``data.generator_args`` and checked against the sizes it states."""

    d, train = config["data"], config["train"]
    make = getattr(generators, d["generator"])
    stamps, ids, demand, observed = make(np, **d["generator_args"])
    if demand.shape != (int(d["steps"]), int(d["series"])):
        raise ValueError(f"the generator made {demand.shape}, the configuration states "
                         f"({d['steps']}, {d['series']})")
    observed = observed.astype(np.float32)
    values = (demand * observed).astype(np.float32)
    end = int(d["train_steps"]) - int(d["holdout_steps"])
    fold, mask = values[:end], observed[:end]
    # the series features of the raw training fold, which ``train_once`` always builds
    static = static_features(fold, mask)
    mean = std = None
    if d["normalize"] == "zscore":
        count = np.maximum(mask.sum(axis=0), 1.0)
        mean = ((fold * mask).sum(axis=0) / count).astype(np.float32)
        std = np.sqrt((((fold - mean) * mask) ** 2).sum(axis=0) / count).astype(np.float32)
        std = np.where(std > 0, std, 1.0).astype(np.float32)
        fold = inputs.zscore(fold, mean, std) * mask
    elif d["normalize"] != "none":
        raise ValueError(f"unknown normalize {d['normalize']!r}")
    count = np.maximum(mask.sum(axis=0), 1.0)
    spread = np.sqrt((((fold - (fold * mask).sum(axis=0) / count) * mask) ** 2).sum(axis=0)
                     / count)
    floors = np.maximum(spread * float(train["min_sigma_scale"]),
                        float(train["min_sigma"])).astype(np.float32)
    return Dataset(stamps, values, observed, list(ids), mean, std, end, static, floors,
                   list(d["time_features"]), d["freq"])


def training_fold(ds: Dataset):
    """``(X, M, marks)`` of the training fold, in model space."""

    X = ds.values[:ds.train_end]
    M = ds.observed[:ds.train_end]
    if ds.mean is not None:
        X = inputs.zscore(X, ds.mean, ds.std) * M
    return (np.ascontiguousarray(X, np.float32), np.ascontiguousarray(M, np.float32),
            inputs.calendar(ds.stamps[:ds.train_end], ds.features))


def windows_total(ds: Dataset, L: int, H: int) -> int:
    return (ds.train_end - L - H + 1) * ds.values.shape[1]


class Plan:
    """Training batches: each epoch a permutation of every window, drawn
    from the seed; ``take(n)`` gives the next ``n`` full batches."""

    def __init__(self, total: int, batch: int, seed: int) -> None:
        self.total, self.batch, self.seed = total, batch, seed
        self.epoch, self.rows, self.at = 0, None, 0

    def _next_epoch(self) -> None:
        order = np.random.default_rng([self.seed, self.epoch]).permutation(self.total)
        steps = self.total // self.batch
        self.rows = order[:steps * self.batch].reshape(steps, self.batch).astype(np.int32)
        self.epoch += 1
        self.at = 0

    def take(self, n: int) -> np.ndarray:
        out = []
        while n > 0:
            if self.rows is None or self.at == len(self.rows):
                self._next_epoch()
            part = self.rows[self.at:self.at + n]
            self.at += len(part)
            n -= len(part)
            out.append(part)
        return np.concatenate(out)


def cuts(ds: Dataset, L: int, n: int, seed: int) -> np.ndarray:
    """``n`` request ends, drawn from the seed: a request's history is the
    ``L`` steps before its end."""

    return np.random.default_rng([seed, 1]).integers(L, ds.values.shape[0] + 1, size=n)
