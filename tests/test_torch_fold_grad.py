"""The port's fold-conv backward against the JAX package's.

The port's ``TapConv`` on the CPU (plain adjoint and plain weight gradient)
against ``jax.grad`` through the JAX ``tap_conv`` (its XLA custom VJP) and
through ``tap_conv_pallas`` in interpret mode with the Pallas backward
(``FLOW_TIMESNET_PALLAS_BWD=1``). The cotangent is random over all Lp rows:
rows beyond L carry data into the next conv, so their cotangent is not 0.
float32 within 2e-5, the JAX package's own fold-conv gradient tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flow_timesnet_tpu.ops import fold as jfold  # noqa: E402
from flow_timesnet_tpu.ops.pallas_fold import tap_conv_pallas  # noqa: E402
from flow_timesnet_tpu_torch.ops import cuda_fold, fold  # noqa: E402

# those of tests/test_pallas_fold.py:77, plus 7x7, p=1 and Cin != Cout
GEOMETRIES = [
    (3, 3, [5], 4, 4), (5, 5, [4, 7], 4, 4), (3, 5, [6, 11, 3], 4, 4),
    (7, 7, [7, 13], 4, 4), (3, 3, [1, 27], 4, 4), (5, 3, [4, 9], 3, 6),
]
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, periods, L, Cin, Cout, kh, kw, B=2):
    rng = np.random.default_rng(seed)
    K, Lp = len(periods), L + L - 1
    h = rng.standard_normal((K, B, Lp, Cin)).astype(np.float32)
    kernel = rng.standard_normal((kh, kw, Cin, Cout)).astype(np.float32) * 0.3
    bias = rng.standard_normal(Cout).astype(np.float32) * 0.1
    ct = rng.standard_normal((K, B, Lp, Cout)).astype(np.float32)
    return h, kernel, bias, ct


def _jax_grads(conv, h, kernel, bias, ct):
    def loss(h_, k_, b_):
        return jnp.sum(conv(h_, k_, b_) * jnp.asarray(ct))

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(h), jnp.asarray(kernel),
                                              jnp.asarray(bias))
    return [np.asarray(g) for g in grads]


def _port_grads(h, kernel, bias, ct, periods, L, kh, kw, dtype=torch.float32):
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    args = [torch.from_numpy(a).requires_grad_() for a in (h, kernel, bias)]
    out = cuda_fold.tap_conv(args[0].to(dtype), geom, args[1], args[2], kh, kw)
    out.backward(torch.from_numpy(ct))
    return [a.grad.numpy() for a in args], geom


@pytest.mark.parametrize("kh,kw,periods,cin,cout", GEOMETRIES)
def test_tap_conv_grads_match_jax_xla_and_pallas(kh, kw, periods, cin, cout, monkeypatch):
    L = 18
    h, kernel, bias, ct = _inputs(7, periods, L, cin, cout, kh, kw)
    jgeom = jfold.make_geometry(jnp.asarray(periods, jnp.int32), L, p_cap=L - 1)
    want = _jax_grads(lambda h_, k_, b_: jfold.tap_conv(h_, jgeom, k_, b_, kh, kw),
                      h, kernel, bias, ct)
    monkeypatch.setenv("FLOW_TIMESNET_PALLAS_BWD", "1")
    want_pallas = _jax_grads(
        lambda h_, k_, b_: tap_conv_pallas(h_, jgeom, k_, b_, kh, kw, interpret=True),
        h, kernel, bias, ct)

    for counter in (cuda_fold.launches, cuda_fold.launches_dh, cuda_fold.launches_dw):
        counter.clear()
    got, geom = _port_grads(h, kernel, bias, ct, periods, L, kh, kw)
    for name, g, w, wp in zip(("dh", "dW", "db"), got, want, want_pallas):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)
        np.testing.assert_allclose(g, wp, **TOL, err_msg=f"{name} (Pallas backward)")
    # dh is exactly 0 at and beyond each candidate's fold extent
    for k, total in enumerate(geom.total.tolist()):
        assert not got[0][k, :, total:].any()
    # the CPU backward runs the plain versions: no kernel launch is counted
    for counter in (cuda_fold.launches, cuda_fold.launches_dh, cuda_fold.launches_dw):
        assert sum(counter.values()) == 0


@pytest.mark.parametrize("kh,kw,periods,cin,cout", GEOMETRIES)
def test_adjoint_identity(kh, kw, periods, cin, cout):
    """<tap_conv(h) - bias, ct> == <h, tap_conv_dh(ct)> in float64 sums."""

    L = 18
    h, kernel, bias, ct = _inputs(11, periods, L, cin, cout, kh, kw)
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    out = fold.tap_conv(torch.from_numpy(h), geom, torch.from_numpy(kernel),
                        torch.zeros(cout), kh, kw).numpy()
    dh = fold.tap_conv_dh(torch.from_numpy(ct), geom, torch.from_numpy(kernel), kh, kw).numpy()
    lhs = float(np.sum(out.astype(np.float64) * ct))
    rhs = float(np.sum(h.astype(np.float64) * dh))
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))
    # and the weight gradient is the contraction of the same forward taps
    dw = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct), kh, kw).numpy()
    assert abs(float(np.sum(dw.astype(np.float64) * kernel)) - lhs) <= 1e-5 * max(1.0, abs(lhs))


def test_bwd_mask_matches_jax():
    L, periods = 20, [1, 3, 7, 19]
    jgeom = jfold.make_geometry(jnp.asarray(periods, jnp.int32), L, p_cap=L - 1)
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    for dj in range(-3, 4):
        want = np.asarray(jfold._bwd_mask(jgeom.periods, jgeom.cycles, jgeom.col, jgeom.Lp, 0, dj))
        np.testing.assert_array_equal(fold._bwd_mask(geom, dj).numpy(), want, err_msg=str(dj))


def test_tap_conv_grads_bf16_round_like_jax():
    """bf16: the cotangent is rounded to bf16 before dh and dW, not before db;
    dh comes back in bf16 and dW in float32. Both sides round at the same
    points; the float32 sums are taken in another order, so a dh value can
    land on the other side of a bf16 rounding step (2**-8 relative)."""

    kh, kw, periods, L, C = 3, 5, [4, 9], 18, 6
    h, kernel, bias, ct = _inputs(3, periods, L, C, C, kh, kw)
    jgeom = jfold.make_geometry(jnp.asarray(periods, jnp.int32), L, p_cap=L - 1)

    def loss(h_, k_, b_):
        out = jfold.tap_conv(h_.astype(jnp.bfloat16), jgeom, k_, b_, kh, kw)
        return jnp.sum(out * jnp.asarray(ct))

    want = [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(kernel), jnp.asarray(bias))]
    got, _ = _port_grads(h, kernel, bias, ct, periods, L, kh, kw, dtype=torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
