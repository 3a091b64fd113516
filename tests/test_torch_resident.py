"""The port's device-resident epoch, evaluation and telemetry probe against
the JAX package's, on the dynamic and the frozen-period engine.

A trimmed flagship-shaped model (one layer, d_model 16, d_ff 32, kernels
3x3 and 5x5, static features, ids, a temporal context and 8 calendar
features) is initialised by the JAX package and carried across with
``convert``; dropout is off wherever the packages are compared. Both sides
stage the same folds (``data/device_windows.py``) and run the same [S, B]
plan, driven as ``train.py`` drives the resident path: the staged probe on
the dynamic engine, a frozen spec from it, the epoch, then evaluation.

- ``train_epoch_resident`` over S=4 steps: losses within 1e-5 relative,
  ``mask_true`` exact, parameters and EMA afterwards within 1e-4 (the
  port's training-parity tolerance; they differ by a few float32 ulps).
- Within the port (dropout on, one generator): the resident epoch equals S
  calls of ``train_step`` on the gathered batches, and chunked calls equal
  one call, exactly (the same ops in the same order on the CPU).
- ``evaluate_resident`` within 1e-5 of JAX's, and equal to the port's host
  ``evaluate`` over the same batches, chunked or not.
- ``collect_period_telemetry_staged`` equal to JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import (  # noqa: E402
    MODEL_KW, STATIC, TF, flat_params, init_tree, jax_engine, port_engine,
)

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu.data import device_windows as jdw  # noqa: E402
from flow_timesnet_tpu_torch.data import device_windows as dw  # noqa: E402

SMALL = dict(n_layers=1, d_ff=32, kernel_set=((3, 3), (5, 5)))
N, BATCH, S, LR = MODEL_KW["id_vocab"], 8, 4, 1e-3


def _folds(seed, lengths):
    """Two folds of unequal length of N series: weekly and
    9.3-day cycles at random phases (no two rFFT bins tie, so both packages
    select the same periods), noise, a missing-value mask, calendar marks,
    static features and per-series floors."""

    rng = np.random.default_rng(seed)
    arrays, masks, marks = [], [], []
    for T in lengths:
        t = np.arange(T)[:, None]
        phase = rng.uniform(0, 2 * np.pi, (1, N))
        x = (4.0 + 2.0 * np.sin(2 * np.pi * t / 7 + phase) * rng.uniform(0.5, 1.5, (1, N))
             + 0.8 * np.cos(2 * np.pi * t / 9.3 + 2 * phase) + 0.3 * rng.standard_normal((T, N)))
        arrays.append(np.clip(x, 0.0, None).astype(np.float32))
        masks.append((rng.random((T, N)) < 0.9).astype(np.float32))
        marks.append(rng.uniform(-1, 1, (T, TF)).astype(np.float32))
    static = rng.standard_normal((N, STATIC)).astype(np.float32)
    sigma = rng.uniform(0.01, 0.1, N).astype(np.float32)
    return arrays, masks, dict(marks=marks, static=static, sigma_vector=sigma)


def _staged(seed, lengths):
    arrays, masks, kw = _folds(seed, lengths)
    L, H = MODEL_KW["input_len"], MODEL_KW["pred_len"]
    return (dw.stage_windows(arrays, masks, L, H, 1, "direct", device="cpu", **kw),
            jdw.stage_windows(arrays, masks, L, H, 1, "direct", **kw))


@pytest.fixture(scope="module")
def tree():
    return init_tree(**SMALL)


@pytest.fixture(scope="module")
def data():
    train, jtrain = _staged(0, (40, 44))  # 96 windows: 12 batches of 8
    val, jval = _staged(1, (38, 41))  # 66 windows: 9 batches, the last padded
    idx, rv = dw.epoch_index_plan(train.total, BATCH, shuffle=True, drop_last=True,
                                  rng=np.random.default_rng([0, 1]))
    probe = dw.epoch_index_plan(train.total, BATCH, shuffle=False, drop_last=True)
    val_plan = dw.epoch_index_plan(val.total, BATCH, shuffle=False, drop_last=False)
    assert val_plan[1][-1].min() == 0.0  # the last held-out batch is padded
    return dict(train=train, jtrain=jtrain, val=val, jval=jval, idx=idx[:S], rv=rv[:S],
                probe=(probe[0][0], probe[1][0]), val_plan=val_plan)


@pytest.fixture(scope="module")
def jax_probe(tree, data):
    """The JAX trainer's staged probe on the dynamic engine, and its spec."""

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tele = jax_engine(model_kw=SMALL).collect_period_telemetry_staged(
        params, data["jtrain"], *data["probe"])
    spec = jengine.Engine.frozen_spec_from_telemetry(tele, SMALL["n_layers"])
    assert any(v for layer in spec for _, _, v in layer)
    return tele, spec


def _model_kw(path, jax_probe, **extra):
    return {**SMALL, **extra, **({"frozen_periods": jax_probe[1]} if path == "frozen" else {})}


def test_staged_probe_matches_jax(tree, data, jax_probe):
    got = port_engine(tree, model_kw=SMALL).collect_period_telemetry_staged(
        None, data["train"], *data["probe"])
    want = jax_probe[0]
    assert sorted(got) == sorted(want)
    for block, rec in want.items():
        for key in ("periods", "valid", "freq_indices"):
            np.testing.assert_array_equal(got[block][key], np.asarray(rec[key]), err_msg=key)
        assert got[block]["group_count"] == int(rec["group_count"])


@pytest.mark.parametrize("path", ["dynamic", "frozen"])
def test_train_epoch_resident_matches_jax(tree, data, jax_probe, path):
    """A dynamic engine's state continued by the ``path`` engine's resident
    epoch (the trainer's swap after ``maybe_freeze``), on both sides."""

    kw = _model_kw(path, jax_probe)
    jeng = jax_engine(model_kw=kw, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jengine.TrainState(params=params, opt_state=jeng.tx.init(params), grad_accum=None,
                                ema=jax.tree_util.tree_map(lambda p: p.copy(), params))
    jstate, want_losses, want_mask = jeng.train_epoch_resident(
        jstate, LR, jax.random.PRNGKey(0), data["jtrain"], jnp.asarray(data["idx"]),
        jnp.asarray(data["rv"]))

    state = port_engine(tree, model_kw=SMALL).init_state()
    eng = port_engine(tree, model_kw=kw)
    state, losses, mask_true = eng.train_epoch_resident(state, LR, None, data["train"],
                                                        data["idx"], data["rv"])
    assert losses.shape == (S,) and mask_true.shape == (S,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-5)
    np.testing.assert_array_equal(mask_true.numpy(), np.asarray(want_mask))
    start = flat_params(tree)
    want_p, want_ema = flat_params(jstate.params), flat_params(jstate.ema)
    for got, want in ((state.params, want_p), (state.ema, want_ema)):
        diff = max(float(np.abs(got[k].detach().numpy() - want[k]).max()) for k in want)
        assert diff <= 1e-4
    assert max(float(np.abs(want_p[k] - start[k]).max()) for k in start) > 0.5 * LR


def _gathered(eng, staged, idx, rv):
    return [eng.gather_staged_batch(staged, i, r) for i, r in zip(idx, rv)]


def _same_state(a, b):
    for got, want in ((a.params, b.params), (a.ema, b.ema)):
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("path", ["dynamic", "frozen"])
def test_resident_epoch_equals_train_steps_with_dropout(tree, data, jax_probe, path):
    kw = _model_kw(path, jax_probe, dropout=0.1)
    res = port_engine(tree, model_kw=kw)
    res_state, losses, mask_true = res.train_epoch_resident(
        res.init_state(), LR, torch.Generator().manual_seed(5), data["train"], data["idx"],
        data["rv"])
    eager = port_engine(tree, model_kw=kw)
    state, gen = eager.init_state(), torch.Generator().manual_seed(5)
    want_losses, want_mask = [], []
    for batch in _gathered(eager, data["train"], data["idx"], data["rv"]):
        state, loss, stats = eager.train_step(state, LR, gen, batch)
        want_losses.append(loss)
        want_mask.append(stats["mask_true"])
    assert torch.equal(losses, torch.stack(want_losses))
    assert torch.equal(mask_true, torch.stack(want_mask))
    _same_state(res_state, state)


@pytest.mark.parametrize("path", ["dynamic", "frozen"])
def test_chunked_resident_epoch_equals_one_call(tree, data, jax_probe, path):
    kw = _model_kw(path, jax_probe, dropout=0.1)
    idx, rv = dw.epoch_index_plan(data["train"].total, BATCH, shuffle=True, drop_last=True,
                                  rng=np.random.default_rng([0, 2]))
    idx, rv = idx[:5], rv[:5]
    one = port_engine(tree, model_kw=kw)
    one_state, want, _ = one.train_epoch_resident(one.init_state(), LR,
                                                  torch.Generator().manual_seed(9),
                                                  data["train"], idx, rv)
    eng = port_engine(tree, model_kw=kw)
    state, gen, parts = eng.init_state(), torch.Generator().manual_seed(9), []
    for off, end in ((0, 2), (2, 4), (4, 5)):
        state, part, _ = eng.train_epoch_resident(state, LR, gen, data["train"], idx[off:end],
                                                  rv[off:end], step_offset=off)
        parts.append(part)
    assert torch.equal(torch.cat(parts), want)
    _same_state(state, one_state)


@pytest.mark.parametrize("path", ["dynamic", "frozen"])
def test_evaluate_resident_matches_jax_and_host_evaluate(tree, data, jax_probe, path):
    kw = _model_kw(path, jax_probe)
    idx, rv = data["val_plan"]
    want = jax_engine(model_kw=kw).evaluate_resident(
        jax.tree_util.tree_map(jnp.asarray, tree), data["jval"], jnp.asarray(idx),
        jnp.asarray(rv))
    eng = port_engine(tree, model_kw=kw)
    params = dict(eng.model.named_parameters())
    got = eng.evaluate_resident(params, data["val"], idx, rv)
    for key in ("nll", "smape"):
        assert np.isfinite(got[key])
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    for key in ("series_sums", "series_cnts"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)
    host = eng.evaluate(params, _gathered(eng, data["val"], idx, rv))
    chunked = eng.evaluate_resident(params, data["val"], idx, rv, max_dispatch_steps=2)
    for other in (host, chunked):
        assert other["nll"] == got["nll"] and other["smape"] == got["smape"]
        for key in ("series_sums", "series_cnts"):
            np.testing.assert_array_equal(other[key], got[key])


def test_resident_epoch_refuses_accumulation(tree, data):
    eng = port_engine(tree, model_kw=SMALL, accumulation_steps=2)
    with pytest.raises(ValueError, match="accumulation_steps == 1"):
        eng.train_epoch_resident(eng.init_state(), LR, None, data["train"], data["idx"],
                                 data["rv"])


def test_an_empty_resident_evaluation_is_not_a_perfect_score(tree, data):
    eng = port_engine(tree, model_kw=SMALL)
    empty = np.zeros((0, BATCH), np.int32)
    got = eng.evaluate_resident(None, data["val"], empty, empty.astype(np.float32))
    assert got["nll"] == float("inf") and got["smape"] == float("inf")


def test_a_cpu_engine_runs_eagerly_whatever_cuda_graphs_says(tree, data):
    eng = port_engine(tree, model_kw=SMALL)
    assert not eng.cuda_graphs  # graphs are the card's; a CPU engine never captures
    batch = eng.gather_staged_batch(data["train"], data["idx"][0], data["rv"][0])
    args = [batch.get(k) for k in ("x", "x_mark", "static", "ids", "floor")]
    got = eng.forward(*args)
    with torch.no_grad():
        want = eng.model(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    eng.train_step(eng.init_state(), LR, None, batch)
    assert not eng._graphs
