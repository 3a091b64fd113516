"""``model.period_buckets`` in the port against the JAX package.

The JAX package compiles one fold program per cap of the ladder and
branches on the largest valid period; the port accepts the ladder and runs
the full-cap fold, whose result is the bucketed one. Tolerances: the
JAX package's own bucket test (``tests/test_timesblock.py``: forward 1e-6,
gradients rtol 1e-5 / atol 1e-6) for the block, the ground rules' 1e-4 for
a model's forward and 1e-5 for its NB-NLL; the port's bucketed block equals
its unbucketed one exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import MODEL_KW, flat_params, model_inputs, perturb, unflat_params  # noqa: E402

from flow_timesnet_tpu import losses as jlosses  # noqa: E402
from flow_timesnet_tpu.models import period as jperiod  # noqa: E402
from flow_timesnet_tpu.models import timesblock as jtb  # noqa: E402
from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu_torch import convert, losses  # noqa: E402
from flow_timesnet_tpu_torch.models import period, timesblock, timesnet  # noqa: E402

LADDERS = [
    (None, 28, 27), (False, 28, 27), ("", 28, 27), ("off", 28, 27), ("none", 28, 27),
    ("false", 28, 27), ("0", 28, 27), ("OFF", 28, 27), ("auto", 28, 27), (" Auto ", 28, 27),
    ("auto", 512, 511), ("auto", 16, 15), ("auto", 5, 4), ("auto", 3, 2), ("auto", 2, 1),
    ([8, 4, 99], 28, 27), ((4, 4, 8), 28, 27), ({12, 6}, 28, 27), ([27, 30], 28, 27),
    ([0, -3, 5], 28, 27), (9, 28, 27), (40, 28, 27), ("4 8", 28, 27), ("4,8", 28, 27),
    ("8, 4, 4", 28, 27), ("12 x", 28, 27), ("1.5", 28, 27), ("100 200", 512, 511),
]


@pytest.mark.parametrize("raw,L,p_cap", LADDERS, ids=lambda v: repr(v))
def test_resolve_period_buckets_matches_jax(raw, L, p_cap):
    assert timesblock.resolve_period_buckets(raw, L, p_cap) == \
        jtb.resolve_period_buckets(raw, L, p_cap)


@pytest.mark.parametrize("raw,error", [(object(), TypeError), ({"a": 1}, ValueError),
                                       ([7, "x"], ValueError)], ids=["object", "dict", "list"])
def test_a_ladder_that_does_not_resolve_fails_in_the_config(raw, error):
    with pytest.raises(error):
        jtb.resolve_period_buckets(raw, 28, 27)  # where the JAX package's model fails
    with pytest.raises(error):
        timesnet.TimesNetConfig(**MODEL_KW, period_buckets=raw)


# JAX's five selection cases (tests/test_timesblock.py::test_period_buckets_match_unbucketed)
CASES = [([4, 2, 3], None), ([4, 7, 2], None), ([4, 15, 2], None),
         ([4, 15, 2], [True, False, True]), ([5, 5, 5], None)]
BLOCK_KW = dict(d_model=6, d_ff=8, kernel_set=((3, 3),), activation="gelu", bottleneck_ratio=1.0,
                min_period=1, max_period=64, p_cap=15)


def _selections(i, amps):
    periods, valid = CASES[i]
    valid = [True] * 3 if valid is None else valid
    jsel = jperiod.PeriodSelection(
        periods=jnp.asarray(periods, jnp.int32), amplitudes=jnp.asarray(amps),
        valid=jnp.asarray(valid), freq_indices=jnp.ones(3, jnp.int32))
    psel = period.PeriodSelection(
        periods=torch.tensor(periods, dtype=torch.int32), amplitudes=torch.from_numpy(amps),
        valid=torch.tensor(valid), freq_indices=torch.ones(3, dtype=torch.int32))
    return jsel, psel


@pytest.fixture(scope="module")
def block_case():
    """The inputs, JAX's bucketed block and its own initial parameters, and
    one compiled forward and one compiled gradient that take every case (a
    selection is data to them)."""

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 6)).astype(np.float32)
    amps = rng.standard_normal((2, 3)).astype(np.float32)
    jblock = jtb.TimesBlock(**BLOCK_KW, dropout=0.0, period_buckets="auto")
    init = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), _selections(0, amps)[0])
    fwd = jax.jit(lambda v, sel: jblock.apply({"params": v}, jnp.asarray(x), sel))
    grad = jax.jit(jax.grad(lambda v, sel: jnp.sum(jnp.tanh(
        jblock.apply({"params": v}, jnp.asarray(x), sel)))))
    return x, amps, (fwd, grad), unflat_params(flat_params(init["params"]))


def _port_block(tree, buckets):
    from port_helpers import load_tree

    return load_tree(timesblock.TimesBlock(**BLOCK_KW, period_buckets=buckets), tree)


def _port_grads(block, x, sel):
    block.zero_grad()
    out = block(torch.from_numpy(x), sel)
    torch.tanh(out).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in block.named_parameters()}


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["small", "mid", "full cap", "invalid", "duplicates"])
def test_bucketed_block_matches_jax_and_the_unbucketed_block(block_case, case):
    x, amps, (fwd, grad), tree = block_case
    jsel, psel = _selections(case, amps)
    want = np.asarray(fwd(tree, jsel))
    bucketed, plain = _port_block(tree, "auto"), _port_block(tree, None)
    assert timesblock.resolve_period_buckets(bucketed.period_buckets, 16, 15) == (4, 8, 15)
    out, grads = _port_grads(bucketed, x, psel)
    out_plain, grads_plain = _port_grads(plain, x, psel)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    # the full-cap fold is the bucketed one: the same bits as without a ladder
    assert torch.equal(out, out_plain)
    assert all(torch.equal(grads[k], grads_plain[k]) for k in grads)
    if case in (0, 2, 3):  # JAX's gradient cases: small cap, full cap, invalid
        gj = flat_params(grad(tree, jsel))
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), gj[name], rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("buckets", ["auto", [7, 14], "10", (14,)])
def test_the_config_takes_a_ladder_and_every_block_gets_it(buckets):
    cfg = timesnet.TimesNetConfig(**MODEL_KW, period_buckets=buckets)
    hash(cfg)  # a frozen config stays hashable: a list becomes a tuple
    want = tuple(buckets) if isinstance(buckets, list) else buckets
    assert cfg.period_buckets == want
    model = timesnet.TimesNet(cfg)
    assert [getattr(model, f"blocks_{i}").period_buckets for i in range(cfg.n_layers)] == \
        [want] * cfg.n_layers


# the flagship-shaped small model with one kernel size, to keep JAX's compile short
SMALL_KW = {**MODEL_KW, "kernel_set": ((3, 3),)}


@pytest.fixture(scope="module")
def model_tree():
    """The port's initial parameters as a flax tree, perturbed with seeded
    noise so that no head is zero."""

    cfg = timesnet.TimesNetConfig(**SMALL_KW)
    params = convert.init_params(cfg, torch.Generator().manual_seed(11))
    return perturb(convert.params_to_jax(params, cfg), seed=1)


def test_a_bucketed_timesnet_matches_jax(model_tree):
    """The flagship-shaped small model with ``period_buckets: auto`` (ladder
    7, 14, 27 at L=28): forward within 1e-4 of JAX's bucketed model and its
    NB-NLL within 1e-5; bit for bit the port's unbucketed model; and in a
    layer the batch's largest valid period lands in a bucket below the full
    cap, so JAX ran a smaller fold than the port's."""

    args = ("x", "x_mark", "static", "ids", "floor")
    inp = model_inputs(3)
    rng = np.random.default_rng(4)
    y = rng.poisson(2.0, (inp["x"].shape[0], SMALL_KW["pred_len"], 1)).astype(np.float32)
    jmodel = jtn.TimesNet(jtn.TimesNetConfig(**SMALL_KW, period_buckets="auto"))
    jrate, jdisp = jax.jit(lambda p, x, m, s, i, f: jmodel.apply(
        {"params": p}, x, m, s, i, dispersion_floor=f))(
            model_tree, *(jnp.asarray(inp[k]) for k in args))
    jm = jlosses.negative_binomial_mask(jnp.asarray(y), jrate, jdisp, jnp.ones(y.shape, bool))
    jloss = float(jlosses.negative_binomial_nll(jnp.asarray(y), jrate, jdisp, jm))

    outs, blocks = {}, {}
    for buckets in ("auto", None):
        cfg = timesnet.TimesNetConfig(**SMALL_KW, period_buckets=buckets)
        model = timesnet.TimesNet(cfg)
        model.load_state_dict(convert.params_from_jax(model_tree, cfg))
        blocks[buckets] = [getattr(model, f"blocks_{i}") for i in range(cfg.n_layers)]
        for block in blocks[buckets]:
            block.telemetry = {}
        with torch.inference_mode():
            rate, disp = model.eval()(*(torch.from_numpy(inp[k]) for k in args))
        yt = torch.from_numpy(y)
        m = losses.negative_binomial_mask(yt, rate, disp, torch.ones(y.shape, dtype=torch.bool))
        outs[buckets] = (rate, disp, losses.negative_binomial_nll(yt, rate, disp, m))
    rate, disp, loss = outs["auto"]
    np.testing.assert_allclose(rate.numpy(), np.asarray(jrate), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=1e-4, atol=1e-4)
    assert abs(float(loss) - jloss) <= 1e-5 * max(1.0, abs(jloss))
    assert all(torch.equal(a, b) for a, b in zip(outs["auto"], outs[None]))
    # the cap JAX's ladder takes in each layer: the smallest that holds the
    # largest valid period
    caps = timesblock.resolve_period_buckets("auto", 28, 27)
    pmax = [int(torch.where(b.telemetry["period_valid"], b.telemetry["selected_periods"], 1).max())
            for b in blocks["auto"]]
    chosen = [min(c for c in caps if c >= p) for p in pmax]
    assert caps == (7, 14, 27) and min(chosen) < 27, (pmax, chosen)
