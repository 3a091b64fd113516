"""The port's period selector and grouper against the JAX package.

Inputs are tie-free (a strong seasonal component, continuous random
amplitudes), so the selections cannot flip on last-bit FFT rounding:
integer outputs must match exactly, floats within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flow_timesnet_tpu.models import period as jperiod  # noqa: E402
from flow_timesnet_tpu_torch.models import period  # noqa: E402


def _seasonal(rng, B, L, C):
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    f = int(rng.integers(1, max(2, L // 4)))
    return x + 3.0 * np.sin(2 * np.pi * f * np.arange(L) / L)[None, :, None].astype(np.float32)


@pytest.mark.parametrize("seed", range(8))
def test_select_periods_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, L, C = 3, int(rng.integers(12, 48)), int(rng.integers(1, 6))
    k = int(rng.integers(1, 4))
    min_thresh = int(rng.integers(1, 8))
    x = _seasonal(rng, B, L, C)
    row_weight = None if seed % 2 else np.array([1.0, 0.0, 1.0], np.float32)
    want = jperiod.select_periods(
        jnp.asarray(x), k, L, min_thresh,
        row_weight=None if row_weight is None else jnp.asarray(row_weight),
    )
    got = period.select_periods(
        torch.from_numpy(x), k, L, min_thresh,
        row_weight=None if row_weight is None else torch.from_numpy(row_weight),
    )
    for name in ("periods", "freq_indices"):
        assert getattr(got, name).dtype == torch.int32
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.amplitudes.numpy(), np.asarray(want.amplitudes),
                               rtol=1e-5, atol=1e-5)


# one compiled program per shape: far fewer compiles than op-by-op dispatch
_jax_group = jax.jit(
    jperiod.group_periods,
    static_argnames=("seq_len", "min_period", "max_period", "log_base", "max_unique"),
)


def _group_both(periods, amps, valid, L, **kw):
    row_weight = kw.pop("row_weight", None)
    want = _jax_group(
        jnp.asarray(periods, jnp.int32), jnp.asarray(amps), jnp.asarray(valid), seq_len=L,
        row_weight=None if row_weight is None else jnp.asarray(row_weight), **kw,
    )
    got = period.group_periods(
        torch.tensor(periods, dtype=torch.int32), torch.from_numpy(amps),
        torch.from_numpy(valid), L,
        row_weight=None if row_weight is None else torch.from_numpy(row_weight), **kw,
    )
    return got, want


def _assert_grouped_equal(got, want, ctx):
    for name in ("periods", "canonical", "group_count"):
        assert getattr(got, name).dtype == torch.int32, (name, ctx)
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=f"{name} {ctx}")
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid), err_msg=str(ctx))
    assert bool(got.any_valid) == bool(want.any_valid), ctx
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-5, atol=1e-5, err_msg=str(ctx))


@pytest.mark.parametrize("log_base", [None, 1.5, 2.0])
@pytest.mark.parametrize("max_unique", [None, 1, 2])
def test_group_periods_fuzz_matches_jax(log_base, max_unique):
    rng = np.random.default_rng(17 + 3 * (max_unique or 0) + int(10 * (log_base or 0)))
    for trial in range(6):
        K = int(rng.integers(1, 7))
        L = int(rng.integers(8, 64))
        B = 2
        periods = rng.integers(0, max(2, L), size=K).tolist()
        amps = rng.gamma(2.0, 1.0, size=(B, K)).astype(np.float32)
        valid = rng.random(K) < 0.85
        kw = dict(log_base=log_base, max_unique=max_unique)
        if trial % 3 == 1:
            kw.update(min_period=int(rng.integers(1, 5)), max_period=int(rng.integers(10, 40)))
        if trial % 4 == 2:
            kw["row_weight"] = (rng.random(B) < 0.7).astype(np.float32)
        ctx = (trial, periods, L, kw)
        got, want = _group_both(periods, amps, valid, L, **kw)
        _assert_grouped_equal(got, want, ctx)


def test_group_periods_all_masked_gives_zero_weights():
    amps = np.random.default_rng(0).gamma(2.0, 1.0, size=(2, 3)).astype(np.float32)
    got, want = _group_both([5, 6, 7], amps, np.zeros(3, bool), 20)
    _assert_grouped_equal(got, want, "all masked")
    assert not bool(got.any_valid) and float(got.weights.abs().sum()) == 0.0


def test_safe_softmax_and_logsumexp_match_jax_on_masked_rows():
    ninf = -np.inf
    x = np.array([[0.5, ninf, 2.0], [ninf, ninf, ninf], [1.0, 1.0, ninf]], np.float32)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            period.logsumexp(torch.from_numpy(x), axis).numpy(),
            np.asarray(jperiod.jax_logsumexp(jnp.asarray(x), axis)),
        )
        np.testing.assert_allclose(
            period.softmax_safe(torch.from_numpy(x), axis).numpy(),
            np.asarray(jperiod.jax_softmax_safe(jnp.asarray(x), axis)), rtol=1e-6,
        )


@pytest.mark.parametrize(
    "raw,depth",
    [(None, 0), (3, 1), ("0:4,2:8,default:2", 1), ("0:4,2:8,default:2", 3), ("5", 0),
     ("log", 0), ("log:3", 2), ("off", 0), ("1:log,default:off", 0), ("1:log,default:off", 1),
     ("x:3", 0), ("", 0), (1.0, 0), ("-2", 0)],
)
def test_resolvers_match_jax(raw, depth):
    assert period.resolve_scheduled(raw, depth) == jperiod.resolve_scheduled(raw, depth)
    assert period.resolve_max_unique(raw, depth) == jperiod.resolve_max_unique(raw, depth)
    assert period.resolve_log_base(raw, depth) == jperiod.resolve_log_base(raw, depth)
