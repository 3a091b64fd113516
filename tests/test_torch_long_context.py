"""The long-context recipe (``configs/long_context.yaml``) against the JAX package.

The recipe's ``model:`` block at narrow widths (d_model 16, d_ff 32; the
recipe's are 128 and 256) and full length: L=512 hours, pred_len 24, two
layers, K=4 periods, kernels 3x3 and 5x5 with bottleneck 4, the series-id
embedding and the rank-8 temporal context, ``period_binning 2.0``, the
``"0:4,default:2"`` schedule of unique periods, hourly cyclical
``[day_of_week, hour]`` marks and ``use_checkpoint``. The dynamic fold is
``Lp = 1023`` (``p_cap = 511``); the frozen path runs the daily and weekly
periods {25, 171} at their exact extents (Lp 525 and 513). Both sides take
the same numpy values; JAX runs its XLA reference (``use_pallas`` off), as
its own CPU tests run it:

- the forward within 1e-4 in float32 and 1e-2 in bf16 (rtol and atol);
- one training step (remat, dropout 0, loss masking, EMA, clip): the loss
  within 1e-5 relative and the parameters within the bound of
  ``tests/test_torch_train_step.py``; gradients within 1e-4 of the largest.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import assert_grads_close, flat_params, perturb  # noqa: E402

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu_torch import convert, engine  # noqa: E402
from flow_timesnet_tpu_torch.data.time_features import build_time_features  # noqa: E402
from flow_timesnet_tpu_torch.models import timesnet  # noqa: E402

L, H, B = 512, 24, 4
LONG = dict(
    input_len=L, pred_len=H, d_model=16, d_ff=32, n_layers=2, k_periods=4,
    kernel_set=((3, 3), (5, 5)), dropout=0.0, activation="gelu", mode="direct",
    bottleneck_ratio=4.0, min_period_threshold=4, id_embed_dim=4, static_proj_dim=32,
    use_zero_mean_context=True, context_rank=8, context_scale=0.05, period_binning=2.0,
    period_max_unique="0:4,default:2", time_features=4, id_vocab=B, c_in=1,
    use_checkpoint=True,
)
# the daily and weekly periods the recipe's selection settles on, in both layers:
# (period, rFFT bin, valid) slots, two of them unused
DAILY_WEEKLY = ((25, 21, True), (171, 3, True), (128, 4, False), (64, 8, False))
SPEC = (DAILY_WEEKLY, DAILY_WEEKLY)
ENGINE_KW = dict(use_loss_masking=True, grad_clip_norm=1.0, weight_decay=1e-6, num_series=B,
                 ema_decay=0.99)
ARGS = ("x", "x_mark", "ids")
LR = 1e-3


def _batch(seed):
    """B hourly windows of 512 + 24 hours: daily and weekly cycles at random
    phases, a slow drift and noise (no two rFFT bins tie), the recipe's
    cyclical [day_of_week, hour] marks, series ids, Poisson targets with a
    missing-value mask."""

    rng = np.random.default_rng(seed)
    t = np.arange(L)[None, :]
    x = (3.0 + np.sin(2 * np.pi * t / 24 + rng.uniform(0, 2 * np.pi, (B, 1)))
         * rng.uniform(0.6, 1.4, (B, 1))
         + 0.5 * np.cos(2 * np.pi * t / 168 + rng.uniform(0, 2 * np.pi, (B, 1)))
         + 1e-3 * t + 0.3 * rng.standard_normal((B, L)))
    stamps = np.datetime64("2024-01-01T00", "h") + np.arange(L)
    marks = build_time_features(stamps, {"enabled": True, "features": ["day_of_week", "hour"],
                                         "encoding": "cyclical", "normalize": True})
    assert marks.shape == (L, 4)
    y = rng.poisson(3.0, (B, H, 1)).astype(np.float32)
    return {
        "x": x[:, :, None].astype(np.float32),
        "x_mark": np.broadcast_to(marks, (B, L, 4)).astype(np.float32),
        "ids": np.arange(B, dtype=np.int32)[:, None],
        "y": y, "mask": (rng.random((B, H, 1)) < 0.9).astype(np.float32),
        "row_valid": np.ones(B, np.float32),
    }


def _jax_cfg(dtype="float32", frozen=False):
    return jtn.TimesNetConfig(**LONG, compute_dtype=dtype, use_pallas=False,
                              frozen_periods=SPEC if frozen else None)


def _port_cfg(dtype="float32", frozen=False):
    return timesnet.TimesNetConfig(**LONG, compute_dtype=dtype,
                                   frozen_periods=SPEC if frozen else None)


@pytest.fixture(scope="module")
def tree():
    """The JAX package's own initialisation, plus seeded noise on every leaf."""

    inp = _batch(0)
    model = jtn.TimesNet(_jax_cfg())
    params = jax.jit(lambda key: model.init(
        {"params": key}, jnp.asarray(inp["x"]), jnp.asarray(inp["x_mark"]), None,
        jnp.asarray(inp["ids"])))(jax.random.PRNGKey(5))["params"]
    return perturb(params, seed=2)


def test_the_narrow_model_keeps_the_recipe_shape(tree):
    """The dynamic fold at L=512 is Lp = 1023 (p_cap 511), the frozen extents
    525 and 513, and the parameter tree is the recipe's at these widths."""

    cfg = _port_cfg()
    model = timesnet.TimesNet(cfg)
    model.load_state_dict(convert.params_from_jax(tree, cfg))
    assert min(cfg.pmax, max(1, L - 1)) == 511
    assert {p: L + (-L) % p for p in (25, 171)} == {25: 525, 171: 513}
    assert math.ceil(L / 21) == 25 and math.ceil(L / 3) == 171  # the spec's bins
    assert sorted(flat_params(tree)) == sorted(model.state_dict())


@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)],
                         ids=["fp32", "bf16"])
def test_long_context_forward_matches_jax(tree, frozen, dtype, tol):
    inp = _batch(1)
    model = jtn.TimesNet(_jax_cfg(dtype, frozen))
    fwd = jax.jit(lambda p, x, m, i: model.apply({"params": p}, x, m, None, i))
    want = [np.asarray(a, np.float32) for a in
            fwd(jax.tree_util.tree_map(jnp.asarray, tree), *(jnp.asarray(inp[k]) for k in ARGS))]
    cfg = _port_cfg(dtype, frozen)
    port = timesnet.TimesNet(cfg)
    port.load_state_dict(convert.params_from_jax(tree, cfg))
    with torch.inference_mode():
        x, m, i = (torch.from_numpy(inp[k]) for k in ARGS)
        got = [a.float().numpy() for a in port.eval()(x, m, None, i)]
    for name, g, w in zip(("rate", "dispersion"), got, want):
        assert g.shape == (B, H, 1) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
def test_long_context_train_step_matches_jax(tree, frozen):
    """One remat step on each side from the same tree and batch: the loss,
    its gradients and the parameters after the update."""

    batch = _batch(2)
    jeng = jengine.Engine(_jax_cfg(frozen=frozen), donate=False, **ENGINE_KW)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb.update(static=None, floor=None, x_mark=jnp.asarray(batch["x_mark"]))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (_, _), jgrads = jax.jit(jax.value_and_grad(jeng._loss, has_aux=True))(
        params, jb, jax.random.PRNGKey(0))
    state = jengine.TrainState(params=params, opt_state=jeng.tx.init(params), grad_accum=None,
                               ema=jax.tree_util.tree_map(lambda p: p.copy(), params))
    state, want_loss, _ = jeng.train_step(state, LR, jax.random.PRNGKey(0), jb)
    want = flat_params(state.params)

    cfg = _port_cfg(frozen=frozen)
    eng = engine.Engine(cfg, convert.params_from_jax(tree, cfg), device="cpu", **ENGINE_KW)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    eng.model.train()
    loss, _ = eng._loss(tb, None)
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for k, p in eng.model.named_parameters()}
    assert_grads_close(grads, flat_params(jgrads), rtol=1e-4)
    st, got_loss, _ = eng.train_step(eng.init_state(), LR, None, tb)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got = {k: p.detach().numpy() for k, p in st.params.items()}
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    size = np.concatenate([np.abs(want[k]).ravel() for k in want])
    assert diff.max() <= 2 * LR
    assert np.mean(diff > 1e-3 * LR + 1e-6 * size) <= 0.01
