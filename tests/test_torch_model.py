"""The port's TimesNet against the JAX package's.

A flagship-shaped small config (d_model 16, d_ff 64, two layers, kernels
3/5/7 with bottleneck 4, static features, series ids, a rank-4 temporal
context and 8 time features) is initialised by the JAX package and
perturbed with seeded numpy noise, so that no head is zero; the JAX model
takes the tree as it is and the port through ``params_from_jax``. Both
run the same numpy inputs. float32 agrees within 1e-4, the tolerance the
JAX package holds its own reference parity to, with the JAX model on its
Pallas kernel (in interpret mode on the CPU) and on its XLA tap conv.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import B, H, MODEL_KW, flat_params, model_inputs, perturb, unflat_params  # noqa: E402

from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu_torch import convert  # noqa: E402
from flow_timesnet_tpu_torch.models import timesnet  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
ARGS = ("x", "x_mark", "static", "ids", "floor")
_inputs = model_inputs


def _jax_model(use_pallas=False, dtype="float32"):
    return jtn.TimesNet(jtn.TimesNetConfig(**MODEL_KW, compute_dtype=dtype, use_pallas=use_pallas))


def _jax_forward(model, params, inp):
    fwd = jax.jit(
        lambda p, x, m, s, i, f: model.apply({"params": p}, x, m, s, i, dispersion_floor=f)
    )
    rate, disp = fwd(params, *(jnp.asarray(inp[k]) for k in ARGS))
    return np.asarray(rate, np.float32), np.asarray(disp, np.float32)


def _port_forward(tree, inp, dtype="float32"):
    cfg = timesnet.TimesNetConfig(**MODEL_KW, compute_dtype=dtype)
    model = timesnet.TimesNet(cfg)
    model.load_state_dict(convert.params_from_jax(tree, cfg))
    with torch.inference_mode():
        rate, disp = model.eval()(*(torch.from_numpy(inp[k]) for k in ARGS))
    return rate.float().numpy(), disp.float().numpy()


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's own initialisation of the model, flattened."""

    inp = _inputs(0)
    init = jax.jit(lambda key, x, m, s, i, f: _jax_model().init(
        {"params": key}, x, m, s, i, dispersion_floor=f))
    return flat_params(init(jax.random.PRNGKey(11), *(jnp.asarray(inp[k]) for k in ARGS))
                       ["params"])


@pytest.fixture(scope="module")
def params(jax_init):
    """The JAX init plus seeded noise: no head is zero."""

    return perturb(unflat_params(jax_init), seed=1)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
def test_timesnet_matches_jax_fp32(params, use_pallas):
    inp = _inputs(8)
    want_rate, want_disp = _jax_forward(_jax_model(use_pallas), params, inp)
    rate, disp = _port_forward(params, inp)
    assert rate.shape == disp.shape == (B, H, 1)
    np.testing.assert_allclose(rate, want_rate, **FP32_TOL)
    np.testing.assert_allclose(disp, want_disp, **FP32_TOL)


def test_timesnet_matches_jax_bf16(params):
    """bf16 conv islands round at the same points on both sides, but a
    float32 sum taken in another order can land on the other side of a bf16
    rounding step (one bf16 ulp is 2**-8 relative), and such flips carry
    through the layers: bf16 agrees within 1e-2 instead of 1e-4 (the
    largest difference seen here is about 3e-3)."""

    inp = _inputs(9)
    want_rate, want_disp = _jax_forward(_jax_model(dtype="bfloat16"), params, inp)
    rate, disp = _port_forward(params, inp, dtype="bfloat16")
    np.testing.assert_allclose(rate, want_rate, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(disp, want_disp, rtol=1e-2, atol=1e-2)


def test_init_params_follows_the_jax_init(jax_init):
    jtree = jax_init
    got = convert.init_params(timesnet.TimesNetConfig(**MODEL_KW),
                              torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(jtree)
    for name, want in jtree.items():
        value = got[name].numpy()
        assert value.shape == want.shape, name
        if np.unique(want).size <= 2:  # zeros, ones, gates, copy-last: deterministic
            np.testing.assert_array_equal(value, want, err_msg=name)
        elif name != "series_embedding.embedding":  # U(+-1/sqrt(fan_in)) on both sides
            kernel = jtree[name[: -len("bias")] + "kernel"] if name.endswith("bias") else want
            bound = 1.0 / np.sqrt(np.prod(kernel.shape[:-1]))
            assert np.abs(value).max() <= bound * (1 + 1e-6), name
            assert np.abs(want).max() <= bound * (1 + 1e-6), name
    # with zero heads the forecast is softplus(copy-last history): the same on both sides
    tree, inp = unflat_params(jtree), _inputs(0)
    want_rate, _ = _jax_forward(_jax_model(), tree, inp)
    rate, _ = _port_forward(tree, inp)
    np.testing.assert_allclose(rate, want_rate, **FP32_TOL)


def test_params_from_jax_rejects_a_mismatched_tree(params):
    cfg = timesnet.TimesNetConfig(**MODEL_KW)
    tree = unflat_params(flat_params(params))
    del tree["mu_head"]
    with pytest.raises(KeyError, match="mu_head"):
        convert.params_from_jax(tree, cfg)
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(params, dataclasses.replace(cfg, d_model=32))


def test_not_yet_ported_paths_raise():
    with pytest.raises(NotImplementedError, match="frozen"):
        timesnet.TimesNetConfig(**MODEL_KW, frozen_periods=(((7, 4, True),),) * 2)
    with pytest.raises(NotImplementedError, match="period_buckets"):
        timesnet.TimesNetConfig(**MODEL_KW, period_buckets="auto")
