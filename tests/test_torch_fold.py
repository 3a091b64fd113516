"""The port's fold conv (plain version and wrapper) against the JAX package.

Same inputs, made with numpy, go through ``flow_timesnet_tpu.ops.fold`` (and
its Pallas kernel in interpret mode) and ``flow_timesnet_tpu_torch.ops``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from flow_timesnet_tpu.ops import fold as jfold  # noqa: E402
from flow_timesnet_tpu.ops.pallas_fold import tap_conv_pallas  # noqa: E402
from flow_timesnet_tpu_torch.ops import cuda_fold, fold  # noqa: E402

GEOMETRIES = [
    (kh, kw, periods)
    for kh, kw in [(3, 3), (5, 5), (1, 3), (7, 7)]
    for periods in ([7], [4, 13, 27], [1, 27])
]


def _inputs(seed, K, B, L, Lp, Cin, Cout, kh, kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, Cin)).astype(np.float32)
    # non-zero garbage beyond L: a later conv in the stack reads it as grid cells
    tail = rng.standard_normal((K, B, Lp - L, Cin)).astype(np.float32)
    h = np.concatenate([np.broadcast_to(x[None], (K, B, L, Cin)), tail], axis=2)
    kernel = (rng.standard_normal((kh, kw, Cin, Cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(Cout) * 0.1).astype(np.float32)
    return np.ascontiguousarray(h), kernel, bias


@pytest.mark.parametrize("kh,kw,periods", GEOMETRIES)
def test_tap_conv_matches_jax_and_pallas(kh, kw, periods):
    B, L, Cin, Cout = 4, 28, 8, 8
    K = len(periods)
    jgeom = jfold.make_geometry(jnp.asarray(periods, jnp.int32), L, p_cap=L - 1)
    h, kernel, bias = _inputs(0, K, B, L, jgeom.Lp, Cin, Cout, kh, kw)
    want = np.asarray(jfold.tap_conv(jnp.asarray(h), jgeom, jnp.asarray(kernel),
                                     jnp.asarray(bias), kh, kw))
    want_pallas = np.asarray(tap_conv_pallas(jnp.asarray(h), jgeom, jnp.asarray(kernel),
                                             jnp.asarray(bias), kh, kw, interpret=True))

    cuda_fold.launches.clear()
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, p_cap=L - 1)
    got = cuda_fold.tap_conv(torch.from_numpy(h), geom, torch.from_numpy(kernel),
                             torch.from_numpy(bias), kh, kw)
    assert got.dtype == torch.float32 and got.shape == (K, B, jgeom.Lp, Cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5, atol=1e-5)
    # the CPU path is the plain version: no kernel launch is counted
    assert sum(cuda_fold.launches.values()) == 0


def test_tap_conv_bf16_rounds_like_jax():
    """bf16 inputs: the kernel is rounded to bf16, products summed in fp32."""

    kh, kw, periods, B, L, C = 3, 3, [5, 9], 3, 20, 6
    jgeom = jfold.make_geometry(jnp.asarray(periods, jnp.int32), L, p_cap=L - 1)
    h, kernel, bias = _inputs(3, len(periods), B, L, jgeom.Lp, C, C, kh, kw)
    want = np.asarray(jfold.tap_conv(jnp.asarray(h, jnp.bfloat16), jgeom,
                                     jnp.asarray(kernel), jnp.asarray(bias), kh, kw))
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, p_cap=L - 1)
    got = fold.tap_conv(torch.from_numpy(h).to(torch.bfloat16), geom,
                        torch.from_numpy(kernel), torch.from_numpy(bias), kh, kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("periods,L,p_cap", [([7, 14], 28, 27), ([0, 5, 40], 21, 20), ([3], 9, 1)])
def test_make_geometry_matches_jax(periods, L, p_cap):
    jg = jfold.make_geometry(jnp.asarray(periods, jnp.int32), L, p_cap)
    g = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, p_cap)
    assert (g.Lp, g.L) == (jg.Lp, jg.L)
    for name in ("periods", "total", "cycles", "col", "row"):
        got = getattr(g, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jg, name)), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pointwise_conv_and_combine_residuals(dtype):
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 3, 11, 16)).astype(np.float32)
    kernel = rng.standard_normal((16, 24)).astype(np.float32) * 0.3
    bias = rng.standard_normal(24).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jfold.pointwise_conv(jnp.asarray(h, jdt), jnp.asarray(kernel),
                                           jnp.asarray(bias)))
    got = fold.pointwise_conv(torch.from_numpy(h).to(tdt), torch.from_numpy(kernel),
                              torch.from_numpy(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    deltas = rng.standard_normal((2, 3, 11, 24)).astype(np.float32)
    weights = rng.dirichlet(np.ones(2), size=3).astype(np.float32)
    x = rng.standard_normal((3, 11, 24)).astype(np.float32)
    want = np.asarray(jfold.combine_residuals(jnp.asarray(deltas), jnp.asarray(weights),
                                              jnp.asarray(x)))
    got = fold.combine_residuals(torch.from_numpy(deltas), torch.from_numpy(weights),
                                 torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_other_devices():
    geom = fold.make_geometry(torch.tensor([4], dtype=torch.int32), 8, 7)
    h = torch.zeros((1, 1, geom.Lp, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_fold.tap_conv(h, geom, torch.zeros(3, 3, 2, 2), torch.zeros(2), 3, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fold.tap_conv_cuda(torch.zeros((1, 1, geom.Lp, 2)), geom,
                                torch.zeros(3, 3, 2, 2), torch.zeros(2), 3, 3)
