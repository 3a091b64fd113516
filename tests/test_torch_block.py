"""The port's DataEmbedding and TimesBlock against the JAX package.

The JAX modules are initialised, perturbed with seeded numpy noise and
loaded into the port's modules under their flax names; both sides then run
the same numpy inputs. The TimesBlock runs the flagship's kernel set (3x3,
5x5, 7x7, bottleneck 4) against the JAX block with its Pallas kernel (in
interpret mode on the CPU) and with its XLA tap conv, in float32 within
1e-4, the tolerance the JAX package holds its own reference parity to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import load_tree, perturb  # noqa: E402

from flow_timesnet_tpu.models import embedding as jemb  # noqa: E402
from flow_timesnet_tpu.models import period as jperiod  # noqa: E402
from flow_timesnet_tpu.models import timesblock as jtb  # noqa: E402
from flow_timesnet_tpu_torch.models import embedding, period, timesblock  # noqa: E402


@pytest.mark.parametrize("mode", ["none", "layer", "rms", "decoupled"])
def test_data_embedding_matches_jax(mode):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 11, 2)).astype(np.float32)
    marks = rng.uniform(-1, 1, (3, 11, 8)).astype(np.float32)
    jmod = jemb.DataEmbedding(c_in=2, d_model=10, dropout=0.0, time_features=8,
                              embed_norm_mode=mode)
    tree = perturb(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(marks))["params"],
                   seed=4, scale=0.3)
    want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x), jnp.asarray(marks)))
    port = load_tree(embedding.DataEmbedding(2, 10, 8, mode), tree)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(marks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_embedding_helpers_match_jax():
    np.testing.assert_allclose(embedding.positional_encoding(13, 10).numpy(),
                               np.asarray(jemb.positional_encoding(13, 10)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(embedding.lrtc_basis(28, 8).numpy(),
                               np.asarray(jemb.lrtc_basis(28, 8)), rtol=0, atol=1e-6)
    for use_norm, mode in [(True, None), (False, None), (True, "RMS"), (False, "layer")]:
        assert embedding.resolve_embed_norm_mode(use_norm, mode) == \
            jemb.resolve_embed_norm_mode(use_norm, mode)
    with pytest.raises(ValueError):
        embedding.resolve_embed_norm_mode(True, "batch")


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
def test_timesblock_matches_jax(use_pallas):
    rng = np.random.default_rng(5)
    L, d_model = 28, 16
    x = rng.standard_normal((4, L, d_model)).astype(np.float32)
    x += 2.0 * np.sin(2 * np.pi * np.arange(L) / 7)[None, :, None].astype(np.float32)
    kw = dict(d_model=d_model, d_ff=64, kernel_set=((3, 3), (5, 5), (7, 7)),
              bottleneck_ratio=4.0, min_period=2, max_period=L, p_cap=L - 1)
    jblock = jtb.TimesBlock(**kw, dropout=0.0, use_pallas=use_pallas)
    jsel = jperiod.select_periods(jnp.asarray(x), 3, L, 2)
    tree = perturb(jblock.init(jax.random.PRNGKey(6), jnp.asarray(x), jsel)["params"], seed=7)
    want = np.asarray(jax.jit(jblock.apply)({"params": tree}, jnp.asarray(x), jsel))

    port = load_tree(timesblock.TimesBlock(**kw), tree)
    sel = period.select_periods(torch.from_numpy(x), 3, L, 2)
    np.testing.assert_array_equal(sel.periods.numpy(), np.asarray(jsel.periods))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), sel).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - x).max() > 1e-2  # the block did change its input


def test_timesblock_without_valid_periods_is_the_identity():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 12, 6)).astype(np.float32))
    block = timesblock.TimesBlock(d_model=6, d_ff=8, kernel_set=((3, 3),), p_cap=11).eval()
    sel = period.PeriodSelection(
        periods=torch.tensor([5, 7], dtype=torch.int32),
        amplitudes=torch.ones((2, 2)),
        valid=torch.zeros(2, dtype=torch.bool),
        freq_indices=torch.ones(2, dtype=torch.int32),
    )
    with torch.inference_mode():
        assert torch.equal(block(x, sel), x)
