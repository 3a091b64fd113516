"""Predictive quantiles for the NB2 head (counterpart of
``flow_timesnet_tpu/utils/quantiles.py``, host numpy as there).

The model emits NB2 with mean ``mu`` and dispersion ``alpha`` per cell
(``Var = mu + alpha * mu^2``, the parameterisation of
``losses.negative_binomial_nll``). This module turns (mu, alpha) into
quantiles for ``predict`` and ``Forecaster.forecast_quantiles``.

Two methods:

- ``"nb"``: the exact NB2 inverse CDF (integer-valued, count space), by
  scipy's ``nbinom.ppf`` when scipy imports, else an exact pmf accumulation
  in numpy (``FLOW_TIMESNET_NO_SCIPY`` set forces it).
- ``"normal"``: the moment-matched Gaussian ``mu + z_q * sqrt(mu +
  alpha*mu^2)``, for pipelines whose targets were normalised before
  training (the NB integer grid means nothing in z-score space).

``"auto"`` resolves to ``"nb"`` for un-normalised (count-space) pipelines
and ``"normal"`` otherwise.
"""

from __future__ import annotations

import os
from statistics import NormalDist
from typing import Sequence

import numpy as np

_EPS = 1e-8
# Fallback search bound: beyond mean + 40*std the NB tail mass is
# negligible for any practically requested quantile.
_FALLBACK_STD_SPAN = 40.0
_FALLBACK_KMAX = 2_000_000


def resolve_method(method: str, normalize: str) -> str:
    """Resolve a configured quantile method against the scaler in effect."""

    m = str(method or "auto").lower()
    if m not in ("auto", "nb", "normal"):
        raise ValueError(
            f"quantile method must be 'auto', 'nb' or 'normal', got {method!r}"
        )
    if m == "auto":
        return "nb" if str(normalize or "none").lower() == "none" else "normal"
    return m


def normal_ppf(q: float) -> float:
    """Standard-normal inverse CDF (stdlib; no scipy dependency)."""

    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    return NormalDist().inv_cdf(float(q))


def _nb2_params(mu: np.ndarray, alpha: np.ndarray):
    """(n, p) of scipy's nbinom for NB2(mean=mu, Var=mu+alpha*mu^2)."""

    mu = np.clip(np.asarray(mu, np.float64), _EPS, None)
    alpha = np.clip(np.asarray(alpha, np.float64), _EPS, None)
    n = 1.0 / alpha
    p = n / (n + mu)
    return mu, alpha, n, p


def _nb2_ppf_numpy(q: float, mu: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Exact NB2 inverse CDF by pmf accumulation (vectorised, scipy-free).

    pmf recurrence: ``pmf(k+1) = pmf(k) * (k + n) / (k + 1) * (1 - p)`` with
    ``pmf(0) = p^n`` (computed in log space to survive large ``n``).
    """

    mu, alpha, n, p = _nb2_params(mu, alpha)
    shape = mu.shape
    mu_f, n_f, p_f = mu.ravel(), n.ravel(), p.ravel()
    var = mu_f + alpha.ravel() * mu_f**2
    kmax = int(
        min(
            _FALLBACK_KMAX,
            np.ceil((mu_f + _FALLBACK_STD_SPAN * np.sqrt(var)).max()) + 1,
        )
    )
    pmf = np.exp(n_f * np.log(p_f))
    cdf = pmf.copy()
    out = np.zeros_like(mu_f)
    done = cdf >= q
    for k in range(kmax):
        if done.all():
            break
        pmf = pmf * ((k + n_f) / (k + 1.0)) * (1.0 - p_f)
        cdf = cdf + pmf
        newly = ~done & (cdf >= q)
        out[newly] = k + 1.0
        done |= newly
    out[~done] = float(kmax)  # tail overflow guard; practically unreachable
    return out.reshape(shape)


def nb2_ppf(q: float, mu: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Exact NB2 quantile (integer-valued, float dtype)."""

    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    if os.environ.get("FLOW_TIMESNET_NO_SCIPY"):  # test hook for the fallback
        return _nb2_ppf_numpy(q, mu, alpha)
    try:
        from scipy.stats import nbinom
    except ImportError:
        return _nb2_ppf_numpy(q, mu, alpha)
    _, _, n, p = _nb2_params(mu, alpha)
    return np.asarray(nbinom.ppf(q, n, p), np.float64)


def nb2_normal_ppf(q: float, mu: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Moment-matched Gaussian quantile of NB2 (continuous, unclipped).

    No zero-clip here: this method is selected for *normalised* pipelines,
    where model space is centered and a low quantile is legitimately
    negative — clipping in model space would collapse lower quantiles to the
    series mean after the inverse transform. Callers clip in final units
    after inverse-transforming (predict.py does).
    """

    mu, alpha, _, _ = _nb2_params(mu, alpha)
    sd = np.sqrt(mu + alpha * mu**2)
    return mu + normal_ppf(q) * sd


def predictive_quantiles(
    quantiles: Sequence[float],
    mu: np.ndarray,
    alpha: np.ndarray,
    method: str = "nb",
) -> dict:
    """{q: quantile array} for each requested level, via the given method."""

    fn = nb2_ppf if method == "nb" else nb2_normal_ppf
    return {float(q): fn(float(q), mu, alpha) for q in quantiles}


def quantile_label(q: float) -> str:
    """File-name label for a quantile level: 0.1 -> 'q10', 0.975 -> 'q97.5'."""

    return f"q{100.0 * float(q):g}"


def quantile_out_path(path: str, q: float) -> str:
    """Derive the per-quantile submission path from the main one."""

    root, ext = os.path.splitext(str(path))
    return f"{root}.{quantile_label(q)}{ext or '.csv'}"


def parse_quantile_config(predict_cfg: dict, normalize: str):
    """Validate ``predict.quantiles`` / ``predict.quantile_method``.

    Returns (sorted unique levels, resolved method); ([], method) when the
    feature is off.
    """

    raw = (predict_cfg or {}).get("quantiles") or []
    if isinstance(raw, (int, float, str)):
        raw = [raw]
    levels = sorted({float(q) for q in raw})
    for q in levels:
        if not 0.0 < q < 1.0:
            raise ValueError(
                f"predict.quantiles entries must be in (0, 1), got {q}"
            )
    method = resolve_method(
        (predict_cfg or {}).get("quantile_method", "auto"), normalize
    )
    return levels, method
