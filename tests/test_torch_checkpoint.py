"""``use_checkpoint``, the remat of the TimesBlocks, against the JAX package's.

The JAX model wraps each layer's selector and block in ``nn.remat``
(``flow_timesnet_tpu/models/timesnet.py:307-326``), which recomputes them in
the backward with the same dropout key; its telemetry runs a twin without
remat. The port runs the same region under ``torch.utils.checkpoint`` with
a :class:`~flow_timesnet_tpu_torch.models.embedding.DropoutTape`: the
recompute multiplies by the masks the forward drew. These tests hold, on the
flagship-shaped small model of ``port_helpers``:

- the port's remat model against JAX's (dropout 0, float32): the loss within
  1e-5 relative, gradients within 1e-4 of the largest, a step's parameters
  within the bound of ``tests/test_torch_train_step.py``, the parameter
  trees identical through ``convert``;
- with dropout on, remat against no remat on the same generator seed: the
  same loss, gradients and generator position, bit for bit on the CPU (a
  recompute that drew again would give other gradients, which the last test
  shows);
- telemetry recorded once and equal with and without remat, and every engine
  path (steps with accumulation, the frozen engine's swap, the resident
  epoch) equal with and without it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import (  # noqa: E402
    ENGINE_KW, MODEL_KW, assert_grads_close, flat_params, init_tree, jax_batch, jax_engine,
    loss_grads, model_inputs, port_engine, torch_batch, window_batch,
)

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu_torch import convert, engine  # noqa: E402
from flow_timesnet_tpu_torch.data import device_windows as dw  # noqa: E402
from flow_timesnet_tpu_torch.models import embedding, timesnet  # noqa: E402

REMAT = dict(use_checkpoint=True)
ONE_LAYER = dict(n_layers=1, kernel_set=((3, 3),), **REMAT)
LR = 1e-3
ARGS = ("x", "x_mark", "static", "ids", "floor")


@pytest.fixture(scope="module")
def tree():
    return init_tree()


def _spec(tree):
    """A frozen spec from the port's telemetry of the model on ``tree``."""

    eng = port_engine(tree)
    tel = eng.collect_period_telemetry(None, torch_batch(model_inputs(0)))
    return engine.Engine.frozen_spec_from_telemetry(tel, MODEL_KW["n_layers"])


def test_remat_loss_and_gradients_match_jax_remat(tree):
    """Both sides with ``use_checkpoint``: the port's gradients come from a
    recompute, JAX's from its remat, on a batch with a padded row, an
    all-masked row and a NaN target."""

    (loss, stats, grads), (want_loss, want_stats, want_grads) = loss_grads(
        tree, window_batch(0), model_kw=REMAT)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert stats == want_stats
    assert_grads_close(grads, want_grads, rtol=1e-4)


def test_remat_step_matches_jax_remat():
    """One optimizer step (EMA, clip, weight decay) on both remat models: the
    loss within 1e-5 relative; every parameter within 2 lr of JAX's and all
    but 1 % within 1e-3 lr plus float32 rounding (Adam's first update is
    about lr * sign(g), so a gradient within rounding of 0 may move either
    way: ``test_train_trajectory_matches_jax``'s bound)."""

    tree = init_tree(**ONE_LAYER)
    batch = window_batch(10)
    jeng = jax_engine(model_kw=ONE_LAYER, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jengine.TrainState(params=params, opt_state=jeng.tx.init(params), grad_accum=None,
                                ema=jax.tree_util.tree_map(lambda p: p.copy(), params))
    jstate, want_loss, _ = jeng.train_step(jstate, LR, jax.random.PRNGKey(0), jax_batch(batch))
    want = flat_params(jstate.params)
    eng = port_engine(tree, model_kw=ONE_LAYER)
    state, loss, _ = eng.train_step(eng.init_state(), LR, None, torch_batch(batch))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got = {k: p.detach().numpy() for k, p in state.params.items()}
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    size = np.concatenate([np.abs(want[k]).ravel() for k in want])
    assert diff.max() <= 2 * LR
    assert np.mean(diff > 1e-3 * LR + 1e-6 * size) <= 0.01


def test_remat_keeps_the_parameter_tree(tree):
    """JAX's remat model initialises the tree its plain model does, and the
    port's remat model loads it through ``convert`` unchanged, both ways."""

    inp = {k: jnp.asarray(v) for k, v in model_inputs(0).items()}
    trees = []
    for remat in (False, True):
        model = jtn.TimesNet(jtn.TimesNetConfig(**MODEL_KW, use_checkpoint=remat))
        trees.append(flat_params(jax.jit(lambda key: model.init(
            {"params": key}, inp["x"], inp["x_mark"], inp["static"], inp["ids"],
            dispersion_floor=inp["floor"]))(jax.random.PRNGKey(3))["params"]))
    assert trees[0].keys() == trees[1].keys()
    for k in trees[0]:
        np.testing.assert_array_equal(trees[0][k], trees[1][k])
    cfg = timesnet.TimesNetConfig(**MODEL_KW, **REMAT)
    plain = convert.params_from_jax(tree, dataclasses.replace(cfg, use_checkpoint=False))
    state_dict = convert.params_from_jax(tree, cfg)
    assert state_dict.keys() == plain.keys()
    assert all(torch.equal(state_dict[k], plain[k]) for k in plain)
    model = timesnet.TimesNet(cfg)
    model.load_state_dict(state_dict)  # strict: the remat model's own keys
    back = flat_params(convert.params_to_jax(state_dict, cfg))
    want = flat_params(tree)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def _loss_and_grads(tree, model_kw, seed=5, batch=None):
    """The port's training loss and gradients at ``model_kw`` with dropout
    drawn from a CPU generator seeded ``seed``, and the generator's state
    after the backward."""

    eng = port_engine(tree, model_kw=model_kw)
    eng.model.train()
    gen = torch.Generator().manual_seed(seed)
    loss, _ = eng._loss(torch_batch(batch or window_batch(3)), gen)
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in eng.model.named_parameters()}
    return loss.detach(), grads, gen.get_state()


@pytest.mark.parametrize("path", ["dynamic", "frozen"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_with_dropout_equals_no_remat_bitwise(tree, path, dtype):
    """At dropout 0.1 on one generator seed, remat and no remat give the same
    loss and gradients bit for bit, and leave the generator at the same
    place: the recompute multiplies by the forward's masks and draws none."""

    kw = dict(dropout=0.1, **({"frozen_periods": _spec(tree)} if path == "frozen" else {}))
    cfg = timesnet.TimesNetConfig(**{**MODEL_KW, **kw, **REMAT}, compute_dtype=dtype)
    out = []
    for c in (dataclasses.replace(cfg, use_checkpoint=False), cfg):
        eng = engine.Engine(c, convert.params_from_jax(tree, c), device="cpu", **ENGINE_KW)
        eng.model.train()
        gen = torch.Generator().manual_seed(5)
        start = gen.get_state()
        loss, _ = eng._loss(torch_batch(window_batch(3)), gen)
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in eng.model.named_parameters()},
                    gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert not torch.equal(s0, start)  # dropout drew
    assert g0.keys() == g1.keys()
    for k in g0:
        assert (g0[k] is None) == (g1[k] is None), k
        assert g0[k] is None or torch.equal(g0[k], g1[k]), k


def test_telemetry_is_recorded_once_and_equal_with_remat(tree):
    """A training forward with remat records each block's selection once, as
    without remat (the recompute in the backward records nothing), and
    ``collect_period_telemetry`` gives the same with and without remat, as
    JAX's non-remat twin does."""

    class Counted(dict):
        def __init__(self):
            super().__init__()
            self.updates = 0

        def update(self, *a, **k):
            self.updates += 1
            super().update(*a, **k)

    batch = torch_batch(window_batch(4))
    records = []
    for remat in (False, True):
        eng = port_engine(tree, model_kw={"use_checkpoint": remat, "dropout": 0.1})
        blocks = [getattr(eng.model, f"blocks_{i}") for i in range(MODEL_KW["n_layers"])]
        for block in blocks:
            block.telemetry = Counted()
        eng.model.train()
        loss, _ = eng._loss(batch, torch.Generator().manual_seed(1))
        loss.backward()
        assert [b.telemetry.updates for b in blocks] == [1] * len(blocks)
        records.append([{k: v.clone() for k, v in b.telemetry.items()} for b in blocks])
        for block in blocks:
            block.telemetry = None
        records.append(eng.collect_period_telemetry(None, batch))
    train_plain, tel_plain, train_remat, tel_remat = records
    for a, b in zip(train_plain, train_remat):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert tel_plain.keys() == tel_remat.keys() and len(tel_plain) == MODEL_KW["n_layers"]
    for name in tel_plain:
        for k, v in tel_plain[name].items():
            np.testing.assert_array_equal(tel_remat[name][k], v)


def _staged(seed=0, T=60):
    rng = np.random.default_rng(seed)
    N = MODEL_KW["id_vocab"]
    t = np.arange(T)[:, None]
    x = 4.0 + 2.0 * np.sin(2 * np.pi * t / 7 + rng.uniform(0, 6, (1, N))) \
        + 0.3 * rng.standard_normal((T, N))
    arrays = [np.clip(x, 0.0, None).astype(np.float32)]
    masks = [(rng.random((T, N)) < 0.9).astype(np.float32)]
    kw = dict(marks=[rng.uniform(-1, 1, (T, MODEL_KW["time_features"])).astype(np.float32)],
              static=rng.standard_normal((N, MODEL_KW["static_dim"])).astype(np.float32),
              sigma_vector=rng.uniform(0.01, 0.1, N).astype(np.float32))
    return dw.stage_windows(arrays, masks, MODEL_KW["input_len"], MODEL_KW["pred_len"], 1,
                            "direct", device="cpu", **kw)


def test_every_engine_path_takes_remat(tree):
    """At dropout 0.1, with and without remat, bit for bit on the CPU: two
    accumulated micro-steps and an update, the frozen engine continuing the
    state through ``_bind``, a resident epoch of 3 steps and the staged
    telemetry probe."""

    staged = _staged()
    idx, rv = dw.epoch_index_plan(staged.total, 4, shuffle=True, drop_last=True,
                                  rng=np.random.default_rng(0))
    spec = _spec(tree)
    runs = []
    for remat in (False, True):
        kw = {"use_checkpoint": remat, "dropout": 0.1}
        eng = port_engine(tree, model_kw=kw, accumulation_steps=2)
        state, gen = eng.init_state(), torch.Generator().manual_seed(9)
        losses = []
        for i in range(3):
            state, loss, _ = eng.train_step(state, LR, gen, torch_batch(window_batch(20 + i)),
                                            do_update=i % 2 == 1)
            losses.append(loss)
        frozen = port_engine(tree, model_kw={**kw, "frozen_periods": spec})  # continues `state`
        state, loss, _ = frozen.train_step(state, LR, gen, torch_batch(window_batch(30)))
        losses.append(loss)
        state, res_losses, _ = frozen.train_epoch_resident(state, LR, gen, staged, idx[:3], rv[:3])
        probe = eng.collect_period_telemetry_staged(None, staged, idx[0], rv[0])
        runs.append((torch.stack(losses), res_losses,
                     {k: p.detach().clone() for k, p in state.params.items()}, probe))
    (l0, r0, p0, t0), (l1, r1, p1, t1) = runs
    assert torch.equal(l0, l1) and torch.equal(r0, r1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    for name in t0:
        for k, v in t0[name].items():
            np.testing.assert_array_equal(t1[name][k], v)


def test_a_recompute_that_drew_its_masks_again_would_differ(tree, monkeypatch):
    """The bitwise test above would catch a recompute that draws from the
    generator: with the tape's replay disabled, the recompute draws the next
    masks and the gradients change while the loss does not."""

    kw = dict(dropout=0.1, **REMAT)
    loss, grads, _ = _loss_and_grads(tree, kw)
    monkeypatch.setattr(embedding.DropoutTape, "replay", lambda self: None)
    bad_loss, bad_grads, _ = _loss_and_grads(tree, kw)
    assert torch.equal(loss, bad_loss)
    assert any(not torch.equal(grads[k], bad_grads[k]) for k in grads)
