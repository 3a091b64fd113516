"""The port's frozen-period path against the JAX package's.

A small model (d_model 16, d_ff 32, two layers, kernels 3x3/5x5 with
bottleneck 4, L = 28, static features, ids, a temporal context and 8 time
features) is initialised by the JAX package, perturbed with seeded noise and
carried across with ``convert``; dropout is off. The frozen spec is the JAX
package's own telemetry of the dynamic model on the same batch. In float32
the frozen forward and its whole-model gradients agree within 1e-4 (of the
largest gradient), the tolerance the JAX package holds its model parity to,
and the frozen train step's loss within 1e-5 relative. In bf16 both sides
round at the same points but sum in other orders, so a value near a bf16
rounding step (2**-8 relative) can land on its other side and carry the
flip on: 1e-2 on the loss and outputs, 2e-2 of the largest gradient.
Within the port, the frozen forward equals the dynamic one when the spec
is the live selection: rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol
1e-5, as ``tests/test_freeze_periods.py`` holds the JAX package.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import (  # noqa: E402
    MODEL_KW, assert_grads_close, flat_params, init_tree, jax_batch, jax_engine, loss_grads,
    model_inputs, port_engine, torch_batch, window_batch,
)

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu.models import period as jperiod  # noqa: E402
from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu_torch import engine  # noqa: E402
from flow_timesnet_tpu_torch.models import period, timesblock, timesnet  # noqa: E402
from flow_timesnet_tpu_torch.ops import cuda_fold  # noqa: E402

SMALL = dict(d_ff=32, kernel_set=((3, 3), (5, 5)))
ARGS = ("x", "x_mark", "static", "ids", "floor")
LR = 1e-3


@pytest.fixture(scope="module")
def tree():
    return init_tree(**SMALL)


@pytest.fixture(scope="module")
def jax_telemetry(tree):
    inp = model_inputs(0)
    return jax_engine(model_kw=SMALL).collect_period_telemetry(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(inp[k]) for k in ARGS})


@pytest.fixture(scope="module")
def spec(jax_telemetry):
    spec = jengine.Engine.frozen_spec_from_telemetry(jax_telemetry, MODEL_KW["n_layers"])
    assert any(v for layer in spec for _, _, v in layer)
    return spec


def test_amplitudes_at_bins_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 28, 6)).astype(np.float32)
    bins = (1, 4, 7, 14)
    want = np.asarray(jperiod.amplitudes_at_bins(jnp.asarray(x), bins))
    got = period.amplitudes_at_bins(torch.from_numpy(x), bins)
    assert got.shape == (5, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the same quantity as the selector's |rfft| at those bins
    amp = torch.fft.rfft(torch.from_numpy(x), dim=1).abs()[:, list(bins)]
    np.testing.assert_allclose(got.numpy(), torch.median(amp, dim=2).values.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_telemetry_and_spec_match_jax(tree, jax_telemetry, spec):
    eng = port_engine(tree, model_kw=SMALL)
    inp = model_inputs(0)
    got = eng.collect_period_telemetry(None, {k: torch.from_numpy(inp[k]) for k in ARGS})
    assert sorted(got) == sorted(jax_telemetry) == ["blocks_0", "blocks_1"]
    for name, want in jax_telemetry.items():
        assert got[name]["group_count"] == want["group_count"]
        for key in ("periods", "valid", "freq_indices"):
            np.testing.assert_array_equal(got[name][key], np.asarray(want[key]), err_msg=key)
    assert engine.Engine.frozen_spec_from_telemetry(got, 2) == spec
    assert engine.Engine.frozen_spec_from_telemetry({"blocks_0": got["blocks_0"]}, 2) is None
    # nothing is left recording: the normal forward stays free of host reads
    assert all(getattr(eng.model, f"blocks_{i}").telemetry is None for i in range(2))
    # a frozen engine records its constants, as JAX's sows them
    frozen = port_engine(tree, model_kw={**SMALL, "frozen_periods": spec})
    again = frozen.collect_period_telemetry(None, {k: torch.from_numpy(inp[k]) for k in ARGS})
    assert engine.Engine.frozen_spec_from_telemetry(again, 2) == spec
    jfrozen = jax_engine(model_kw={**SMALL, "frozen_periods": spec}).collect_period_telemetry(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(inp[k]) for k in ARGS})
    for name, want in jfrozen.items():
        assert again[name]["group_count"] == want["group_count"]
        for key in ("periods", "valid", "freq_indices"):
            np.testing.assert_array_equal(again[name][key], np.asarray(want[key]), err_msg=key)


def _forward_both(tree, model_kw, dtype):
    inp = model_inputs(0)
    jmodel = jtn.TimesNet(jtn.TimesNetConfig(**{**MODEL_KW, **model_kw}, compute_dtype=dtype))
    want = jax.jit(lambda p, x, m, s, i, f: jmodel.apply({"params": p}, x, m, s, i,
                                                         dispersion_floor=f))(
        tree, *(jnp.asarray(inp[k]) for k in ARGS))
    eng = port_engine(tree, dtype, model_kw)
    got = eng.forward(*(torch.from_numpy(inp[k]) for k in ARGS))
    return ([g.float().numpy() for g in got], [np.asarray(w, np.float32) for w in want])


@pytest.mark.parametrize("case", ["live", "no_valid_slot"])
def test_frozen_forward_and_gradients_match_jax_fp32(tree, spec, case):
    if case == "no_valid_slot":
        spec = tuple(tuple((p, f, False) for p, f, _ in layer) for layer in spec)
    model_kw = {**SMALL, "frozen_periods": spec}
    got, want = _forward_both(tree, model_kw, "float32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    (loss, stats, grads), (want_loss, want_stats, want_grads) = loss_grads(
        tree, window_batch(0), "float32", model_kw)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert stats == want_stats
    assert_grads_close(grads, want_grads, rtol=1e-4)
    conv = [k for k in grads if k.endswith("conv_kernel")]
    moved = max(float(np.abs(grads[k]).max()) for k in conv)
    assert (moved > 0) == (case == "live")  # no valid slot: the blocks are skipped


def test_frozen_forward_and_gradients_match_jax_bf16(tree, spec):
    model_kw = {**SMALL, "frozen_periods": spec}
    got, want = _forward_both(tree, model_kw, "bfloat16")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)
    (loss, _, grads), (want_loss, _, want_grads) = loss_grads(
        tree, window_batch(0), "bfloat16", model_kw)
    assert abs(loss - want_loss) <= 1e-2 * abs(want_loss)
    assert_grads_close(grads, want_grads, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_forward_equals_dynamic_on_the_live_spec(tree, dtype):
    """The port alone: the spec from its own telemetry of the batch."""

    inp = {k: torch.from_numpy(v) for k, v in model_inputs(0).items()}
    dyn = port_engine(tree, dtype, SMALL)
    spec = engine.Engine.frozen_spec_from_telemetry(
        dyn.collect_period_telemetry(None, inp), 2)
    frozen = port_engine(tree, dtype, {**SMALL, "frozen_periods": spec})

    def outputs(eng):
        model = eng.model.eval()
        rate, disp = model(*(inp[k] for k in ARGS))
        loss = (rate.float() ** 2).mean() + (disp.float() ** 2).mean()
        loss.backward()
        return [rate.detach(), disp.detach()], {k: p.grad for k, p in model.named_parameters()}

    (rate_d, disp_d), g_d = outputs(dyn)
    (rate_f, disp_f), g_f = outputs(frozen)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(rate_f, rate_d, **tol)
    torch.testing.assert_close(disp_f, disp_d, **tol)
    if dtype == "float32":
        for k in g_d:
            torch.testing.assert_close(g_f[k], g_d[k], rtol=1e-4, atol=1e-5, msg=k)


def test_a_served_frozen_request_then_a_training_step_share_the_cached_constants(tree, spec):
    """The DFT basis and the dense geometries are cached per spec; a request
    (inference mode) that builds them first must leave them usable by a
    training step's backward."""

    frozen_kw = {**SMALL, "frozen_periods": tuple(  # periods and bins no other test caches
        tuple((p + 1, f + 1, v) for p, f, v in layer) for layer in spec)}
    eng = port_engine(tree, model_kw=frozen_kw)
    inp = model_inputs(0)
    eng.forward(*(torch.from_numpy(inp[k]) for k in ARGS))
    _, loss, _ = eng.train_step(eng.init_state(), LR, None, torch_batch(window_batch(0)))
    assert np.isfinite(float(loss))


def test_a_block_with_no_valid_slot_is_the_identity():
    block = timesblock.TimesBlock(d_model=8, d_ff=16, kernel_set=((3, 3),),
                                  frozen=((7, 4, False), (14, 2, False)))
    x = torch.randn(3, 28, 8)
    assert block(x, None) is x
    block.telemetry = {}
    block(x, None)
    assert int(block.telemetry["group_count"]) == 0
    assert block.telemetry["period_valid"].tolist() == [False, False]


def test_frozen_model_takes_the_dynamic_parameters(tree, spec):
    dyn = timesnet.TimesNet(timesnet.TimesNetConfig(**MODEL_KW))
    cfg = timesnet.TimesNetConfig(**MODEL_KW, frozen_periods=spec)
    frozen = timesnet.TimesNet(cfg)
    assert {k: v.shape for k, v in dyn.state_dict().items()} == \
        {k: v.shape for k, v in frozen.state_dict().items()}
    with pytest.raises(ValueError, match="one slot tuple per layer"):
        timesnet.TimesNet(dataclasses.replace(cfg, frozen_periods=spec[:1]))


RAW_SPECS = [
    None, [], [[[7, 4, True], [27, 1, False]], [[14, 2, 1], [7, 4, 0]]],
    (((7, 4, True),), ((7, 4, True),)), [[[7, 4, True]]], [[[7, "x", True]], [[7, 4, True]]],
    [[7, 4, True], [7, 4, True]], [[[7, 4]], [[7, 4]]],
]


@pytest.mark.parametrize("raw", RAW_SPECS, ids=range(len(RAW_SPECS)))
def test_frozen_spec_from_config_matches_jax(raw):
    def outcome(fn):
        try:
            return fn(raw, 2)
        except ValueError as err:
            return ("ValueError", str(err).split(":")[0])

    want = outcome(jengine.Engine.frozen_spec_from_config)
    got = outcome(engine.Engine.frozen_spec_from_config)
    assert got == want
    if isinstance(got, tuple) and got and got[0] != "ValueError":  # it round-trips
        assert engine.Engine.frozen_spec_from_config([list(map(list, layer)) for layer in got],
                                                     2) == got


@pytest.mark.parametrize("raw", [True, False, "on", "OFF", " auto ", "yes", "no", "1", "0",
                                 "", "true", 1, 0, "bogus"])
def test_parse_freeze_mode_matches_jax(raw):
    def outcome(fn):
        try:
            return fn(raw)
        except ValueError as err:
            return ("ValueError", str(err))

    assert outcome(engine.Engine.parse_freeze_mode) == \
        outcome(jengine.Engine.parse_freeze_mode)


def test_frozen_train_steps_match_jax(tree, spec):
    """A dynamic step, then two frozen steps on the same state (the JAX
    trainer's engine swap), on both sides: losses within 1e-5 relative and
    the parameters as ``test_torch_train_step.py`` holds a trajectory."""

    batches = [window_batch(40 + i, pad_row=i == 1) for i in range(3)]
    frozen_kw = {**SMALL, "frozen_periods": spec}

    jdyn, jfro = jax_engine(model_kw=SMALL, donate=False), \
        jax_engine(model_kw=frozen_kw, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jengine.TrainState(params=params, opt_state=jdyn.tx.init(params), grad_accum=None,
                               ema=jax.tree_util.tree_map(lambda p: p.copy(), params))
    want = []
    for i, (eng, b) in enumerate(zip((jdyn, jfro, jfro), batches)):
        state, loss, _ = eng.train_step(state, LR, jax.random.PRNGKey(i), jax_batch(b))
        want.append(float(loss))
    want_p, want_ema = flat_params(state.params), flat_params(state.ema)

    dyn = port_engine(tree, model_kw=SMALL)
    fro = port_engine(tree, model_kw=frozen_kw)
    pstate = dyn.init_state()
    got = []
    for eng, b in zip((dyn, fro, fro), batches):
        for counter in (cuda_fold.launches, cuda_fold.launches_dh, cuda_fold.launches_dw):
            counter.clear()
        pstate, loss, _ = eng.train_step(pstate, LR, None, torch_batch(b))
        got.append(float(loss))
    assert dict(fro.model.named_parameters())["mu_head.kernel"] is pstate.params["mu_head.kernel"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w in ((pstate.params, want_p), (pstate.ema, want_ema)):
        diff = np.concatenate([np.abs(g[k].detach().numpy() - w[k]).ravel() for k in w])
        size = np.concatenate([np.abs(w[k]).ravel() for k in w])
        assert diff.max() <= 2 * 3 * LR
        assert np.mean(diff > 1e-3 * LR + 1e-6 * size) <= 0.01
    # the frozen engine's evaluate reads the same state
    res = fro.evaluate(pstate.ema, [torch_batch(batches[0])])
    assert np.isfinite(res["nll"]) and np.isfinite(res["smape"])
