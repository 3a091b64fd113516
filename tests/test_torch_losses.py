"""The port's losses and metric sums against the JAX package's.

The NB-NLL, its mask and its gradients with respect to rate and dispersion
agree with JAX within 1e-5 and with a float64 ``scipy.special.gammaln``
oracle; the metric sums agree within 1e-5. Masked, non-finite and
all-masked inputs included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
special = pytest.importorskip("scipy.special")

from flow_timesnet_tpu import losses as jlosses  # noqa: E402
from flow_timesnet_tpu.utils import metrics as jmetrics  # noqa: E402
from flow_timesnet_tpu_torch import losses  # noqa: E402
from flow_timesnet_tpu_torch.utils import metrics  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _nb_inputs(seed, shape=(6, 7, 1), min_disp=0.1):
    rng = np.random.default_rng(seed)
    rate = rng.gamma(2.0, 4.0, shape).astype(np.float32) + 0.05
    disp = rng.uniform(min_disp, 1.5, shape).astype(np.float32)
    y = rng.poisson(rate).astype(np.float32)
    mask = (rng.random(shape) < 0.8).astype(np.float32)
    return y, rate, disp, mask


def _nb_oracle(y, rate, disp, valid):
    """float64 NB2 log-likelihood with scipy's gammaln, averaged over valid."""

    y, mu, a = (np.asarray(v, np.float64)[valid] for v in (y, rate, disp))
    inv = 1.0 / a
    ll = (special.gammaln(y + inv) - special.gammaln(inv) - special.gammaln(y + 1.0)
          - inv * np.log1p(a * mu) + y * (np.log(a) + np.log(mu) - np.log1p(a * mu)))
    return -ll.sum() / max(1.0, float(valid.sum()))


def _nb_oracle_grad_disp(y, rate, disp, valid):
    """float64 d(NLL)/d(dispersion) with scipy's digamma."""

    y, mu, a = (np.asarray(v, np.float64) for v in (y, rate, disp))
    inv = 1.0 / a
    dll = (inv**2 * (special.digamma(inv) - special.digamma(y + inv) + np.log1p(a * mu))
           - inv * mu / (1.0 + a * mu) + y * (inv - mu / (1.0 + a * mu)))
    return np.where(valid, -dll, 0.0) / max(1.0, float(valid.sum()))


def _jax_nll(y, rate, disp, mask):
    def f(r, d):
        m = jlosses.negative_binomial_mask(jnp.asarray(y), r, d, jnp.asarray(mask) > 0)
        return jlosses.negative_binomial_nll(jnp.asarray(y), r, d, m)

    loss, (gr, gd) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(rate), jnp.asarray(disp))
    return float(loss), np.asarray(gr), np.asarray(gd)


def _port_nll(y, rate, disp, mask):
    r = torch.from_numpy(rate).requires_grad_()
    d = torch.from_numpy(disp).requires_grad_()
    yt = torch.from_numpy(y)
    m = losses.negative_binomial_mask(yt, r, d, torch.from_numpy(mask) > 0)
    loss = losses.negative_binomial_nll(yt, r, d, m)
    loss.backward()
    return float(loss.detach()), r.grad.numpy(), d.grad.numpy(), m.numpy()


@pytest.mark.parametrize("seed", range(3))
def test_nb_nll_and_grads_match_jax_and_the_float64_oracle(seed):
    y, rate, disp, mask = _nb_inputs(seed)
    want, want_gr, want_gd = _jax_nll(y, rate, disp, mask)
    got, gr, gd, valid = _port_nll(y, rate, disp, mask)
    np.testing.assert_array_equal(valid, (mask > 0) & np.isfinite(y))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    assert abs(got - _nb_oracle(y, rate, disp, valid)) <= 1e-5 * max(1.0, abs(want))
    np.testing.assert_allclose(gr, want_gr, **TOL)
    np.testing.assert_allclose(gd, want_gd, **TOL)


def test_small_dispersion_gradient_is_as_good_as_jax():
    """Below a dispersion of about 0.05 the float32 gradient with respect to
    it loses digits on both sides: lgamma(y + 1/a) - lgamma(1/a) cancels, and
    its derivative is scaled by 1/a**2 (1e4 at a = 0.01), so the two sides
    differ by up to about 1e-4 here. Each is held to the float64 oracle
    instead: the port no further from it than twice JAX's distance, or 1e-5."""

    for seed in range(3):
        y, rate, disp, mask = _nb_inputs(seed, min_disp=0.01)
        _, _, want_gd = _jax_nll(y, rate, disp, mask)
        _, _, gd, valid = _port_nll(y, rate, disp, mask)
        oracle = _nb_oracle_grad_disp(y, rate, disp, valid)
        jax_err = np.abs(want_gd - oracle).max()
        assert np.abs(gd - oracle).max() <= max(2.0 * jax_err, 1e-5)


def test_masked_and_non_finite_elements():
    """A NaN target, an inf rate and a NaN dispersion, each in a masked or
    unmasked position, leave the loss finite. Where JAX's gradient is finite
    the port's equals it; at a masked NaN target JAX's gradient is NaN (0
    times the NaN derivative of the unselected branch), the port's is 0."""

    y, rate, disp, mask = _nb_inputs(5, shape=(2, 7, 1))
    y[0, 1, 0] = np.nan
    mask[0, 1, 0] = 0.0  # masked NaN target
    y[1, 2, 0] = np.nan  # unmasked NaN target: dropped by the finite mask
    rate[1, 4, 0] = np.inf
    disp[0, 5, 0] = np.nan
    want, want_gr, want_gd = _jax_nll(y, rate, disp, mask)
    got, gr, gd, valid = _port_nll(y, rate, disp, mask)
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * max(1.0, abs(want))
    assert abs(got - _nb_oracle(y, rate, disp, valid)) <= 1e-5 * max(1.0, abs(want))
    assert np.isfinite(gr).all() and np.isfinite(gd).all()
    finite = np.isfinite(want_gr) & np.isfinite(want_gd)
    assert not finite.all()  # the JAX package's NaN gradient is real
    np.testing.assert_allclose(gr[finite], want_gr[finite], **TOL)
    np.testing.assert_allclose(gd[finite], want_gd[finite], **TOL)
    assert not gr[~valid].any() and not gd[~valid].any()


def test_all_masked_batch():
    y, rate, disp, mask = _nb_inputs(6)
    mask[:] = 0.0
    want, _, _ = _jax_nll(y, rate, disp, mask)
    got, gr, gd, valid = _port_nll(y, rate, disp, mask)
    assert got == want == 0.0 and not valid.any()
    assert not gr.any() and not gd.any()


def test_mask_broadcasts_from_the_left():
    y, rate, disp, _ = _nb_inputs(7)
    row_mask = np.array([1, 0, 1, 1, 0, 1], bool)
    want = np.asarray(jlosses.negative_binomial_mask(
        jnp.asarray(y), jnp.asarray(rate), jnp.asarray(disp), jnp.asarray(row_mask)))
    got = losses.negative_binomial_mask(
        torch.from_numpy(y), torch.from_numpy(rate), torch.from_numpy(disp),
        torch.from_numpy(row_mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("min_sigma", [0.0, 0.3, "vector"])
def test_gaussian_nll_matches_jax(min_sigma):
    rng = np.random.default_rng(8)
    mu, target = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    sigma = rng.uniform(0.05, 2.0, (4, 3, 5)).astype(np.float32)
    floor = rng.uniform(0.1, 0.5, (1, 1, 5)).astype(np.float32) if min_sigma == "vector" else min_sigma
    want = np.asarray(jlosses.gaussian_nll_loss(
        jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(target),
        jnp.asarray(floor) if min_sigma == "vector" else floor))
    got = losses.gaussian_nll_loss(
        torch.from_numpy(mu), torch.from_numpy(sigma), torch.from_numpy(target),
        torch.from_numpy(floor) if min_sigma == "vector" else floor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_metric_sums_match_jax():
    rng = np.random.default_rng(9)
    B, H, N, num_series = 6, 7, 1, 10
    y = rng.poisson(3.0, (B, H, N)).astype(np.float32)
    pred = rng.gamma(2.0, 2.0, (B, H, N)).astype(np.float32)
    keep = (rng.random((B, H, N)) < 0.7).astype(np.float32)
    y, pred = y * keep, pred * keep  # masked entries zeroed, as the eval step does
    sid = rng.integers(0, num_series, (B, N)).astype(np.int32)
    want = jmetrics.smape_batch_sums(jnp.asarray(y), jnp.asarray(pred))
    got = metrics.smape_batch_sums(torch.from_numpy(y), torch.from_numpy(pred))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want = jmetrics.wsmape_batch_sums(jnp.asarray(y), jnp.asarray(pred), jnp.asarray(sid),
                                      num_series)
    got = metrics.wsmape_batch_sums(torch.from_numpy(y), torch.from_numpy(pred),
                                    torch.from_numpy(sid), num_series)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    ids = [f"store{i % 3}_item{i}" for i in range(num_series)]
    sums, cnts = (g.numpy() for g in got)
    for weights in (None, {"store0": 2.0, "store1": 1.0}):
        assert metrics.wsmape_from_series_sums(sums, cnts, ids, weights) == pytest.approx(
            jmetrics.wsmape_from_series_sums(sums, cnts, ids, weights), rel=1e-6)
