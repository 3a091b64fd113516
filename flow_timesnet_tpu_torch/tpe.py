"""Self-contained Tree-structured Parzen Estimator sampler (counterpart of
``flow_timesnet_tpu/tpe.py``, pure Python; the same suggestions for the
same seed and observations).

The independent-TPE algorithm (Bergstra et al. 2011, the same family as
``optuna.samplers.TPESampler`` with ``multivariate=False``), for
environments without optuna:

- observations are split into "good" (best ``gamma`` quantile) and "bad";
- each dimension gets two 1-D Parzen densities ``l(x)`` (good) / ``g(x)``
  (bad): Gaussian kernels at the observed values (log-space for log params)
  with a range-scaled bandwidth plus a flat prior kernel over the range;
- candidates are drawn from ``l`` and the one maximising ``l(x)/g(x)`` wins;
- categorical dimensions use smoothed category frequencies instead.

Deterministic given the seed. The first ``n_startup`` trials are random
(there is nothing to model yet), exactly like optuna's startup phase.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Mapping, Sequence, Tuple


def _to_unit(spec: Mapping[str, Any], value: Any) -> float:
    """Map a parameter value into the continuous modelling space."""

    if spec.get("log"):
        return math.log(float(value))
    return float(value)


def _from_unit(spec: Mapping[str, Any], u: float) -> Any:
    kind = str(spec.get("type", "float"))
    if spec.get("log"):
        u = math.exp(u)
    low, high = float(spec["low"]), float(spec["high"])
    u = min(max(u, low), high)
    if kind == "int":
        step = int(spec.get("step", 1))
        lo = int(spec["low"])
        k = round((u - lo) / step)
        return int(min(max(lo + k * step, lo), int(spec["high"])))
    return float(u)


def _bounds(spec: Mapping[str, Any]) -> Tuple[float, float]:
    lo, hi = float(spec["low"]), float(spec["high"])
    if spec.get("log"):
        return math.log(lo), math.log(hi)
    return lo, hi


class _Parzen:
    """1-D Gaussian mixture over observations + a flat-prior kernel."""

    def __init__(self, points: Sequence[float], lo: float, hi: float) -> None:
        self.points = list(points)
        self.lo, self.hi = lo, hi
        span = max(hi - lo, 1e-12)
        n = max(len(self.points), 1)
        # Bandwidth ~ span/n with a 10%-of-range floor: tight enough to
        # exploit clusters, wide enough that a single good point still
        # generalises (Scott-style range bandwidths were too wide and let TPE
        # degrade to random search).
        self.bw = max(span / n, span * 0.1, 1e-12)
        self.prior_weight = 1.0  # one pseudo-observation spread over the range

    def sample(self, rng: random.Random) -> float:
        total = len(self.points) + self.prior_weight
        if rng.random() < self.prior_weight / total:
            return rng.uniform(self.lo, self.hi)
        c = self.points[rng.randrange(len(self.points))]
        for _ in range(16):
            x = rng.gauss(c, self.bw)
            if self.lo <= x <= self.hi:
                return x
        return min(max(rng.gauss(c, self.bw), self.lo), self.hi)

    def logpdf(self, x: float) -> float:
        span = max(self.hi - self.lo, 1e-12)
        acc = self.prior_weight / span
        inv = 1.0 / (self.bw * math.sqrt(2 * math.pi))
        for c in self.points:
            z = (x - c) / self.bw
            acc += inv * math.exp(-0.5 * z * z)
        return math.log(acc / (len(self.points) + self.prior_weight))


class TPESampler:
    """Independent TPE over a dict of {dotted-path: spec} dimensions."""

    def __init__(
        self,
        space: Mapping[str, Mapping[str, Any]],
        seed: int = 0,
        gamma: float = 0.25,
        n_startup: int = 5,
        n_candidates: int = 48,
    ) -> None:
        self.space = dict(space)
        self.rng = random.Random(seed)
        self.gamma = float(gamma)
        self.n_startup = int(n_startup)
        self.n_candidates = int(n_candidates)
        self.history: List[Tuple[float, Dict[str, Any]]] = []

    # -- public API ---------------------------------------------------------

    def suggest(self) -> Dict[str, Any]:
        if len(self.history) < self.n_startup:
            return {p: self._random(spec) for p, spec in self.space.items()}
        ordered = sorted(self.history, key=lambda t: t[0])
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        good = [params for _, params in ordered[:n_good]]
        bad = [params for _, params in ordered[n_good:]] or good
        return {
            p: self._suggest_dim(p, spec, good, bad)
            for p, spec in self.space.items()
        }

    def observe(self, value: float, params: Mapping[str, Any]) -> None:
        self.history.append((float(value), dict(params)))

    # -- internals ----------------------------------------------------------

    def _random(self, spec: Mapping[str, Any]) -> Any:
        kind = str(spec.get("type", "float"))
        if kind == "categorical":
            return self.rng.choice(list(spec["choices"]))
        lo, hi = _bounds(spec)
        return _from_unit(spec, self.rng.uniform(lo, hi))

    def _suggest_dim(self, path, spec, good, bad) -> Any:
        kind = str(spec.get("type", "float"))
        if kind == "categorical":
            choices = list(spec["choices"])

            def freq(obs):
                counts = {repr(c): 1.0 for c in choices}  # +1 smoothing
                for params in obs:
                    key = repr(params.get(path))
                    if key in counts:
                        counts[key] += 1.0
                total = sum(counts.values())
                return {k: v / total for k, v in counts.items()}

            lf, gf = freq(good), freq(bad)
            # sample candidates from l, keep the best l/g ratio
            keys = list(lf)
            weights = [lf[k] for k in keys]
            best_key, best_score = None, -math.inf
            for _ in range(self.n_candidates):
                key = self.rng.choices(keys, weights=weights)[0]
                score = math.log(lf[key]) - math.log(gf[key])
                if score > best_score:
                    best_key, best_score = key, score
            return next(c for c in choices if repr(c) == best_key)

        lo, hi = _bounds(spec)
        l_pts = [_to_unit(spec, p[path]) for p in good if path in p]
        g_pts = [_to_unit(spec, p[path]) for p in bad if path in p]
        l_est = _Parzen(l_pts, lo, hi)
        g_est = _Parzen(g_pts, lo, hi)
        best_x, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            x = l_est.sample(self.rng)
            score = l_est.logpdf(x) - g_est.logpdf(x)
            if score > best_score:
                best_x, best_score = x, score
        return _from_unit(spec, best_x)
