"""The port's optimizer steps, bf16 gradients and evaluation against the JAX
package's, on trimmed models.

The JAX side compiles one program per engine step (and the accumulating
step twice, with and without the update), so these cases trim the
flagship-shaped model of ``port_helpers`` to one layer, and the optimizer
steps to one 3x3 kernel; the port runs the same code at any depth, and
``test_torch_train.py`` holds the gradients of the whole model.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import (  # noqa: E402
    assert_grads_close, flat_params, init_tree, jax_batch, jax_engine, loss_grads, port_engine,
    torch_batch, window_batch,
)

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu_torch import convert, engine  # noqa: E402

ONE_LAYER = dict(n_layers=1, kernel_set=((3, 3), (5, 5)))
TINY = dict(n_layers=1, kernel_set=((3, 3),))
LR = 1e-3


def _jax_train(tree, batches, model_kw, accum):
    eng = jax_engine(model_kw=model_kw, accumulation_steps=accum, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jengine.TrainState(
        params=params, opt_state=eng.tx.init(params),
        grad_accum=jax.tree_util.tree_map(jnp.zeros_like, params) if accum > 1 else None,
        ema=jax.tree_util.tree_map(lambda p: p.copy(), params),
    )
    losses = []
    for i, b in enumerate(batches):
        state, loss, _ = eng.train_step(state, LR, jax.random.PRNGKey(i), jax_batch(b),
                                        do_update=(i + 1) % accum == 0)
        losses.append(float(loss))
    return losses, flat_params(state.params), flat_params(state.ema)


def _port_train(tree, batches, model_kw, accum):
    eng = port_engine(tree, model_kw=model_kw, accumulation_steps=accum)
    state = eng.init_state()
    losses = []
    for i, b in enumerate(batches):
        state, loss, _ = eng.train_step(state, LR, None, torch_batch(b),
                                        do_update=(i + 1) % accum == 0)
        losses.append(float(loss))
    return (losses, {k: p.detach().numpy() for k, p in state.params.items()},
            {k: e.numpy() for k, e in state.ema.items()})


@pytest.mark.parametrize("accum,steps", [(1, 3), (2, 4)], ids=["3_steps", "accum_2"])
def test_train_trajectory_matches_jax(accum, steps):
    """Losses within 1e-5 relative. Parameters and EMA: Adam's first update
    is lr * g / (|g| + eps), about lr * sign(g), so an element whose
    gradient is within rounding of 0 can move the other way, by up to 2 * lr
    per update: every element is held to that bound, and all but 1 % of
    them (those whose gradients are clear of 0) to 1e-3 * lr plus float32
    rounding of the parameter."""

    tree = init_tree(**TINY)
    batches = [window_batch(10 + i, pad_row=i % 2 == 0) for i in range(steps)]
    want_losses, want_p, want_ema = _jax_train(tree, batches, TINY, accum)
    losses, got_p, got_ema = _port_train(tree, batches, TINY, accum)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    start = flat_params(tree)
    for got, want in ((got_p, want_p), (got_ema, want_ema)):
        diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        size = np.concatenate([np.abs(want[k]).ravel() for k in want])
        assert diff.max() <= 2 * (steps // accum) * LR
        assert np.mean(diff > 1e-3 * LR + 1e-6 * size) <= 0.01
    moved = max(float(np.abs(want_p[k] - start[k]).max()) for k in start)
    assert moved > 0.5 * LR  # the steps did move the parameters


def test_loss_gradients_match_jax_bf16():
    """bf16 conv islands: both sides round at the same points (the fold
    conv's cotangent before dh and dW; the 1x1 convs' input gradients after
    a float32 product, as JAX's transpose of a bf16 einsum with float32
    accumulation does), but a float32 sum taken in another order can land on
    the other side of a bf16 rounding step (2**-8 relative), and the flip is
    carried through the backward: 2e-2 of the largest gradient instead of
    1e-4."""

    tree = init_tree(**ONE_LAYER)
    (loss, _, grads), (want_loss, _, want_grads) = loss_grads(
        tree, window_batch(1), "bfloat16", ONE_LAYER)
    assert abs(loss - want_loss) <= 1e-2 * abs(want_loss)
    assert_grads_close(grads, want_grads, rtol=2e-2)


def test_evaluate_matches_jax():
    tree = init_tree(**ONE_LAYER)
    batches = [window_batch(20, pad_row=False), window_batch(21)]
    want = jax_engine(model_kw=ONE_LAYER).evaluate(
        jax.tree_util.tree_map(jnp.asarray, tree), [jax_batch(b) for b in batches])
    eng = port_engine(tree, model_kw=ONE_LAYER)
    params = convert.params_from_jax(tree, eng.cfg)
    got = eng.evaluate(params, [torch_batch(b) for b in batches])
    for key in ("nll", "smape"):
        assert np.isfinite(got[key])
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    for key in ("series_sums", "series_cnts"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)
    assert engine._safe_ratio(1.0, 0.0) == float("inf")
    assert eng.evaluate(params, [])["nll"] == float("inf")
