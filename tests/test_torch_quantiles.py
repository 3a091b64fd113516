"""The port's ``utils/quantiles.py`` against the JAX package's on the same
seeded (mu, alpha): every function, the exact NB2 inverse CDF (scipy's and
the numpy fallback's) equal, the moment-matched Gaussian within 1e-6
relative, and the config parsing and file naming equal, errors included."""

import numpy as np
import pytest

pytest.importorskip("jax")

from flow_timesnet_tpu.utils import quantiles as jq  # noqa: E402
from flow_timesnet_tpu_torch.utils import quantiles as pq  # noqa: E402

LEVELS = (0.025, 0.1, 0.5, 0.9, 0.975)


def mu_alpha(seed, shape=(12, 7)):
    """Means over five decades (near-zero included) and dispersions from
    near-Poisson to heavy."""

    rng = np.random.default_rng(seed)
    mu = (10.0 ** rng.uniform(-3, 2, shape)).astype(np.float32)
    alpha = (10.0 ** rng.uniform(-4, 0.5, shape)).astype(np.float32)
    return mu, alpha


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("no_scipy", [False, True])
def test_nb_quantiles_equal(monkeypatch, seed, no_scipy):
    if no_scipy:
        monkeypatch.setenv("FLOW_TIMESNET_NO_SCIPY", "1")
    mu, alpha = mu_alpha(seed)
    for q in LEVELS:
        np.testing.assert_array_equal(pq.nb2_ppf(q, mu, alpha), jq.nb2_ppf(q, mu, alpha))
    got = pq.predictive_quantiles(LEVELS, mu, alpha, method="nb")
    want = jq.predictive_quantiles(LEVELS, mu, alpha, method="nb")
    assert list(got) == list(want)
    for q in LEVELS:
        np.testing.assert_array_equal(got[q], want[q])


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_quantiles_within_1e6(seed):
    mu, alpha = mu_alpha(seed)
    for q in LEVELS:
        assert pq.normal_ppf(q) == jq.normal_ppf(q)
        np.testing.assert_allclose(pq.nb2_normal_ppf(q, mu, alpha),
                                   jq.nb2_normal_ppf(q, mu, alpha), rtol=1e-6, atol=0)
    got = pq.predictive_quantiles(LEVELS, mu, alpha, method="normal")
    want = jq.predictive_quantiles(LEVELS, mu, alpha, method="normal")
    for q in LEVELS:
        np.testing.assert_allclose(got[q], want[q], rtol=1e-6, atol=0)
    # the levels are ordered in every cell
    stacked = np.stack([got[q] for q in LEVELS])
    assert (np.diff(stacked, axis=0) >= 0).all()


@pytest.mark.parametrize("method,normalize", [
    ("auto", "none"), ("auto", "zscore"), ("auto", None), ("NB", "zscore"), ("normal", "none"),
    (None, "minmax"), ("bogus", "none"),
])
def test_resolve_method(method, normalize):
    try:
        want = jq.resolve_method(method, normalize)
    except ValueError as err:
        with pytest.raises(ValueError, match="quantile method"):
            pq.resolve_method(method, normalize)
        assert "quantile method" in str(err)
    else:
        assert pq.resolve_method(method, normalize) == want


@pytest.mark.parametrize("q", [0.0, 1.0, -0.5, 1.5])
def test_levels_outside_the_unit_interval_raise(q):
    mu, alpha = mu_alpha(0, (2,))
    for fn in (lambda: pq.normal_ppf(q), lambda: pq.nb2_ppf(q, mu, alpha)):
        with pytest.raises(ValueError, match="quantile must be in"):
            fn()


@pytest.mark.parametrize("q,path", [(0.1, "out/sub.csv"), (0.975, "sub"), (0.5, "a.b/c.tsv"),
                                    (0.05, "/x/y.csv")])
def test_labels_and_paths(q, path):
    assert pq.quantile_label(q) == jq.quantile_label(q)
    assert pq.quantile_out_path(path, q) == jq.quantile_out_path(path, q)


@pytest.mark.parametrize("cfg,normalize", [
    ({}, "none"), ({"quantiles": [0.9, 0.1, 0.5, 0.1]}, "none"),
    ({"quantiles": 0.5, "quantile_method": "normal"}, "none"),
    ({"quantiles": ["0.25", 0.75]}, "zscore"), ({"quantiles": [0.5, 1.0]}, "none"),
    (None, "zscore"),
])
def test_parse_quantile_config(cfg, normalize):
    try:
        want = jq.parse_quantile_config(cfg, normalize)
    except ValueError:
        with pytest.raises(ValueError, match="entries must be in"):
            pq.parse_quantile_config(cfg, normalize)
    else:
        assert pq.parse_quantile_config(cfg, normalize) == want
