"""The port's training forward and backward against the JAX package's.

The flagship-shaped small model of ``port_helpers`` is initialised by the
JAX package, perturbed with seeded noise and carried across with
``convert``. Whole-model gradients of ``Engine._loss`` agree with
``jax.grad`` of the JAX ``Engine._loss`` within 1e-4 in float32 (dropout 0,
loss masking on), the tolerance the JAX package holds its model parity to,
on a window batch with a padded row (``row_valid`` 0), an all-masked row and
a NaN target in a masked position. ``test_torch_train_step.py`` holds the
optimizer steps and evaluation.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import (  # noqa: E402
    B, ENGINE_KW, H, MODEL_KW, assert_grads_close, flat_params, init_tree, loss_grads, perturb,
    port_engine, torch_batch, window_batch,
)

from flow_timesnet_tpu.models import period as jperiod  # noqa: E402
from flow_timesnet_tpu.models import timesblock as jtb  # noqa: E402
from flow_timesnet_tpu_torch import convert, engine  # noqa: E402
from flow_timesnet_tpu_torch.models import embedding, period, timesblock, timesnet  # noqa: E402


@pytest.fixture(scope="module")
def tree():
    return init_tree()


def test_loss_gradients_match_jax_fp32(tree):
    (loss, stats, grads), (want_loss, want_stats, want_grads) = loss_grads(tree, window_batch(0))
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert stats == want_stats
    assert stats["mask_total"] == (B - 1) * H  # the padded row is not covered
    assert_grads_close(grads, want_grads, rtol=1e-4)
    assert max(float(np.abs(g).max()) for g in grads.values()) > 1e-3


def test_params_to_jax_inverts_params_from_jax(tree):
    cfg = port_engine(tree).cfg
    state_dict = convert.params_from_jax(tree, cfg)
    back = flat_params(convert.params_to_jax(state_dict, cfg))
    want = flat_params(tree)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    del state_dict["mu_head.kernel"]
    with pytest.raises(KeyError, match="mu_head"):
        convert.params_to_jax(state_dict, cfg)


def test_lower_median_backward_matches_jax_on_ties():
    x = np.array([[3.0, 1.0, 3.0, 2.0, 3.0], [5.0, 5.0, 5.0, 5.0, 0.0],
                  [1.0, 2.0, 2.0, 1.0, 2.0], [0.0, 4.0, 1.0, 1.0, 1.0]], np.float32)
    ct = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jperiod._lower_median(v, 1) * ct))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (period._lower_median(xt, 1) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert (np.count_nonzero(want, axis=1) == 1).all()  # one element per row, the first tie


def test_timesblock_gradients_with_an_invalid_slot_match_jax():
    """A selection whose second slot is invalid: its softmax weight is 0
    through masked -inf logits, and no NaN reaches the gradients."""

    rng = np.random.default_rng(4)
    Lb, d_model = 20, 8
    x = rng.standard_normal((3, Lb, d_model)).astype(np.float32)
    kw = dict(d_model=d_model, d_ff=16, kernel_set=((3, 3),), bottleneck_ratio=4.0,
              min_period=2, max_period=Lb, p_cap=Lb - 1)
    sel = dict(periods=np.array([5, 7, 4], np.int32), valid=np.array([True, False, True]),
               amplitudes=rng.gamma(2.0, 1.0, (3, 3)).astype(np.float32),
               freq_indices=np.array([4, 3, 5], np.int32))
    jblock = jtb.TimesBlock(**kw, dropout=0.0)
    jsel = jperiod.PeriodSelection(**{k: jnp.asarray(v) for k, v in sel.items()})
    jtree = perturb(jblock.init(jax.random.PRNGKey(6), jnp.asarray(x), jsel)["params"], seed=7)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx, amps):
        return jnp.sum(jblock.apply({"params": p}, xx, jsel._replace(amplitudes=amps)) * ct)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jtree, jnp.asarray(x),
                                                        jnp.asarray(sel["amplitudes"]))
    block = timesblock.TimesBlock(**kw)
    block.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in flat_params(jtree).items()})
    xt = torch.from_numpy(x).requires_grad_()
    amps = torch.from_numpy(sel["amplitudes"]).requires_grad_()
    tsel = period.PeriodSelection(
        periods=torch.from_numpy(sel["periods"]), amplitudes=amps,
        valid=torch.from_numpy(sel["valid"]), freq_indices=torch.from_numpy(sel["freq_indices"]))
    (block(xt, tsel) * torch.from_numpy(ct)).sum().backward()
    assert_grads_close({k: p.grad.numpy() for k, p in block.named_parameters()},
                       flat_params(want[0]), rtol=1e-4)
    for g, w in ((xt.grad, want[1]), (amps.grad, want[2])):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    assert not amps.grad[:, 1].any()  # the invalid slot's amplitude gets no gradient


def test_dropout_draws_from_the_step_generator():
    cfg = timesnet.TimesNetConfig(**{**MODEL_KW, "n_layers": 1, "kernel_set": ((3, 3),),
                                     "dropout": 0.25})
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    batch = torch_batch(window_batch(30))
    runs = []
    for seed in (1, 1, 2):
        eng = engine.Engine(cfg, params, device="cpu", **ENGINE_KW)
        state = eng.init_state()
        gen = torch.Generator().manual_seed(seed)
        for _ in range(2):
            state, loss, _ = eng.train_step(state, 1e-3, gen, batch)
        runs.append((float(loss), {k: p.detach().clone() for k, p in state.params.items()}))
    (l1, p1), (l1b, p1b), (l2, _) = runs
    assert l1 == l1b and all(torch.equal(p1[k], p1b[k]) for k in p1)
    assert l2 != l1
    # the kept fraction of one draw is within 3 sigma of 1 - rate
    x = torch.ones(200_000)
    kept = float((embedding.dropout(x, 0.25, torch.Generator().manual_seed(3)) != 0).float().mean())
    assert abs(kept - 0.75) <= 3 * np.sqrt(0.25 * 0.75 / x.numel())
    assert torch.equal(embedding.dropout(x, 0.25, None), x)  # a deterministic pass
    eng = engine.Engine(cfg, params, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="Generator"):
        eng.train_step(eng.init_state(), 1e-3, None, batch)


def test_not_yet_ported_training_paths_raise(tree):
    """Named for when these paths raised: use_checkpoint and period_buckets
    are ported (tests/test_torch_checkpoint.py,
    tests/test_torch_period_buckets.py): an
    engine takes each on the same parameter keys, which ``convert`` carries
    from the JAX tree unchanged, and hands the ladder to every block."""

    cfg = port_engine(tree).cfg
    remat = engine.Engine(dataclasses.replace(cfg, use_checkpoint=True),
                          convert.params_from_jax(tree, cfg), device="cpu", **ENGINE_KW)
    assert remat.cfg.use_checkpoint
    assert remat.model.state_dict().keys() == port_engine(tree).model.state_dict().keys()
    bucketed = engine.Engine(dataclasses.replace(cfg, period_buckets="auto"),
                             convert.params_from_jax(tree, cfg), device="cpu", **ENGINE_KW)
    assert bucketed.model.state_dict().keys() == port_engine(tree).model.state_dict().keys()
    assert all(getattr(bucketed.model, f"blocks_{i}").period_buckets == "auto"
               for i in range(cfg.n_layers))
    assert timesnet.TimesNetConfig(input_len=8, pred_len=2).use_checkpoint is False
