"""The port's data parallelism against the JAX package's mesh.

The port's ranks are gloo processes on the CPU (``parallel/mesh.launch``
running ``tests/torch_dp_worker.py``); the JAX package runs the same
numpy inputs on its virtual CPU mesh (the suite's conftest gives it eight
devices). Tolerances are the JAX package's own DP tolerances
(``tests/test_data_parallel.py``): losses rtol 1e-5 / atol 1e-6, parameters
after 3 steps rtol 1e-4 / atol 1e-5. Dropout is off: each rank draws its
own masks. Each launch runs several jobs on its ranks and is shared by the
tests that read it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import torch_dp_worker as worker  # noqa: E402
from port_helpers import flat_params, perturb  # noqa: E402

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu.data import device_windows as jdw  # noqa: E402
from flow_timesnet_tpu.models import period as jperiod  # noqa: E402
from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu.parallel.mesh import make_mesh, replicate, shard_batch  # noqa: E402
from flow_timesnet_tpu_torch.data.device_windows import epoch_index_plan  # noqa: E402
from flow_timesnet_tpu_torch.models import period as pperiod  # noqa: E402
from flow_timesnet_tpu_torch.parallel import mesh  # noqa: E402

B = 32
RESIDENT_KW = dict(id_vocab=4, static_dim=0, time_features=0, static_proj_dim=None)
RESIDENT_ENGINE = dict(num_series=4)
SPLIT_L = 48


def _tree(model_kw=None, seed=0):
    cfg = jtn.TimesNetConfig(**{**worker.TINY, **(model_kw or {})})
    b = worker.make_batch(4)
    x_mark = jnp.asarray(b["x_mark"]) if cfg.time_features else None
    static = jnp.asarray(b["static"]) if cfg.static_dim else None
    params = jtn.TimesNet(cfg).init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(b["x"]),
                                    x_mark, static, jnp.asarray(b["ids"] % cfg.id_vocab))["params"]
    return flat_params(perturb(params, seed=1))


def _jax_engine(model_kw=None, engine_kw=None):
    cfg = jtn.TimesNetConfig(**{**worker.TINY, **(model_kw or {})})
    return jengine.Engine(cfg, donate=False, **{**worker.ENGINE_KW, **(engine_kw or {})})


def _jax_state(eng, flat):
    from port_helpers import unflat_params

    params = jax.tree_util.tree_map(jnp.asarray, unflat_params(flat))
    return jengine.TrainState(params=params, opt_state=eng.tx.init(params), grad_accum=None)


def _jax_batch(batch):
    return {**{k: jnp.asarray(v) for k, v in batch.items()}, "y_mark": None}


def _jax_steps(flat, batch, n_devices=None, dcn=1, n=3):
    eng = _jax_engine()
    state, jb = _jax_state(eng, flat), _jax_batch(batch)
    if n_devices is not None:
        m = make_mesh(n_devices=n_devices, dcn_slices=dcn)
        state, jb = replicate(m, state), shard_batch(m, jb)
    losses = []
    for i in range(n):
        state, loss, _ = eng.train_step(state, worker.LR, jax.random.PRNGKey(i), jb, True)
        losses.append(float(loss))
    return losses, flat_params(jax.device_get(state.params))


def _split_period_batch():
    """Two halves with different dominant periods: 12 steps (rFFT bin 4)
    in the first, 7 (bin 7, stronger) in the second. Each half alone
    selects its own period; the whole batch selects 7."""

    rng = np.random.default_rng(3)
    t = np.arange(SPLIT_L)
    a = np.sin(2 * np.pi * t / 12)[None] + 0.05 * rng.standard_normal((8, SPLIT_L))
    b = 1.6 * np.sin(2 * np.pi * 7 * t / SPLIT_L)[None] + 0.05 * rng.standard_normal((8, SPLIT_L))
    return np.concatenate([a, b])[:, :, None].astype(np.float32)


def _resident_plans():
    arrays, masks = worker.make_staged_arrays()
    staged = jdw.stage_windows(arrays, masks, 16, 4, 1, "direct")
    # B=6 over 4 ranks: padded to 8, the last rank holds only padding
    idx, rv = epoch_index_plan(staged.total, 6, None, shuffle=False, drop_last=True)
    pidx, prv = epoch_index_plan(staged.total, 6, mesh.dp_batch_rows(6, 4), shuffle=False,
                                 drop_last=True)
    return arrays, masks, staged, (idx, rv), (pidx, prv)


@pytest.fixture(scope="module")
def flat():
    return _tree()


@pytest.fixture(scope="module")
def two_ranks(flat):
    batch = worker.make_batch(B)
    x = _split_period_batch()
    rw = np.ones(16, np.float32)
    rw[[3, 12]] = 0.0  # a padded row in each half
    jobs = [
        ("steps", "steps", dict(params=flat, batch=batch)),
        ("sharded", "steps", dict(params=flat, batch=batch, shard=True)),
        ("eval", "evaluate", dict(params=flat, batches=[batch, worker.make_batch(B, 7)])),
        ("split", "selection", dict(x=x, k_periods=1)),
        ("split_k2", "selection", dict(x=x, k_periods=2)),
        ("split_rw", "selection", dict(x=x, k_periods=1, row_weight=rw)),
    ]
    return mesh.launch(worker.run_jobs, 2, jobs, threads=2)


@pytest.fixture(scope="module")
def four_ranks(flat):
    arrays, masks, _, _, (pidx, prv) = _resident_plans()
    batch = worker.make_batch(B)
    small = {k: v[:30] for k, v in batch.items()}
    padded = {k: np.concatenate([v, np.zeros((2,) + v.shape[1:], v.dtype)])
              for k, v in small.items()}
    jobs = [
        ("steps", "steps", dict(params=flat, batch=batch)),
        ("padded", "steps", dict(params=flat, batch=padded)),
        ("resident", "resident", dict(params=_tree(RESIDENT_KW), arrays=arrays, masks=masks,
                                      idx=pidx, rv=prv, model_kw=RESIDENT_KW,
                                      engine_kw=RESIDENT_ENGINE)),
    ]
    # dcn_slices=2 validates the world as a 2 x 2 (dcn, data) mesh; the math
    # is the 1-D mesh's, so this launch stands for both
    return mesh.launch(worker.run_jobs, 4, jobs, dcn_slices=2, threads=1)


def _assert_params(got, want, rtol=1e-4, atol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_steps_match_jax_mesh(n, flat, two_ranks, four_ranks):
    runs = two_ranks if n == 2 else four_ranks
    want_losses, want_params = _jax_steps(flat, worker.make_batch(B), n_devices=n)
    for r, out in enumerate(runs):
        np.testing.assert_allclose(out["steps"]["losses"], want_losses, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {r}")
        _assert_params(out["steps"]["params"], want_params)
        assert out["steps"]["mask_true"] == float(B * 4)  # the global batch's count
    # every rank holds the same replica
    for out in runs[1:]:
        _assert_params(out["steps"]["params"], runs[0]["steps"]["params"], rtol=0, atol=0)


def test_eval_sums_match_jax_mesh(flat, two_ranks):
    eng = _jax_engine()
    m = make_mesh(n_devices=2)
    params = replicate(m, jax.tree_util.tree_map(
        jnp.asarray, _jax_state(eng, flat).params))
    want = eng.evaluate(params, [shard_batch(m, _jax_batch(b))
                                 for b in (worker.make_batch(B), worker.make_batch(B, 7))])
    for out in two_ranks:
        got = out["eval"]
        assert got["nll"] == pytest.approx(want["nll"], rel=1e-5)
        assert got["smape"] == pytest.approx(want["smape"], rel=1e-5)
        np.testing.assert_allclose(got["series_sums"], want["series_sums"], rtol=1e-5)
        np.testing.assert_allclose(got["series_cnts"], want["series_cnts"], rtol=0)


def test_padded_indivisible_batch_matches_single(flat, four_ranks):
    """B=30 does not divide 4 ranks: padded to 32 with row_valid=0 rows, the
    ranks reproduce the unpadded batch's trajectory on one JAX device."""

    small = {k: v[:30] for k, v in worker.make_batch(B).items()}
    want_losses, want_params = _jax_steps(flat, small)
    for out in four_ranks:
        np.testing.assert_allclose(out["padded"]["losses"], want_losses, rtol=1e-5, atol=1e-6)
        _assert_params(out["padded"]["params"], want_params)
        assert out["padded"]["mask_true"] == 30 * 4 and out["padded"]["mask_total"] == 30 * 4


def test_sharded_table_equals_replicated(two_ranks):
    for r, out in enumerate(two_ranks):
        rep, shard = out["steps"], out["sharded"]
        assert shard["sharded"] == [mesh.TABLE_NAME] and rep["sharded"] == []
        assert shard["table_rows"] == worker.TINY["id_vocab"] // 2 and rep["table_rows"] == 8
        np.testing.assert_allclose(shard["losses"], rep["losses"], rtol=1e-6, atol=0)
        _assert_params(shard["params"], rep["params"], rtol=1e-5, atol=1e-6)
    # the assembled table is the same on both ranks
    np.testing.assert_array_equal(two_ranks[0]["sharded"]["params"][mesh.TABLE_NAME],
                                  two_ranks[1]["sharded"]["params"][mesh.TABLE_NAME])


def test_dcn_2x2_matches_jax(flat, four_ranks):
    """``dcn_slices=2`` over 4 ranks: the JAX package's 2-D (dcn, data) mesh
    of 2 x 2 devices, the same trajectory."""

    want_losses, want_params = _jax_steps(flat, worker.make_batch(B), n_devices=4, dcn=2)
    for out in four_ranks:
        assert out["axes"] == {"dcn": 2, "data": 2}
        np.testing.assert_allclose(out["steps"]["losses"], want_losses, rtol=1e-5, atol=1e-6)
        _assert_params(out["steps"]["params"], want_params)


def test_resident_epoch_over_a_padded_plan(four_ranks):
    """A resident epoch of B=6 over 4 ranks (the plan padded to 8 columns,
    the last rank's all padding) against JAX's unpadded epoch on one
    device, and ``evaluate_resident`` after it."""

    tree = _tree(RESIDENT_KW)
    _, _, staged, (idx, rv), _ = _resident_plans()
    eng = _jax_engine(RESIDENT_KW, RESIDENT_ENGINE)
    state = _jax_state(eng, tree)
    state, losses, _ = eng.train_epoch_resident(state, worker.LR, jax.random.PRNGKey(9), staged,
                                                jnp.asarray(idx), jnp.asarray(rv))
    metrics = eng.evaluate_resident(state.params, staged, jnp.asarray(idx), jnp.asarray(rv))
    want_params = flat_params(jax.device_get(state.params))
    for out in four_ranks:
        got = out["resident"]
        np.testing.assert_allclose(got["losses"], np.asarray(losses), rtol=1e-5, atol=1e-6)
        assert got["nll"] == pytest.approx(float(metrics["nll"]), rel=1e-5)
        _assert_params(got["params"], want_params)
        assert float(got["mask_true"].sum()) == float(rv.sum()) * 4


@pytest.mark.parametrize("case,k", [("split", 1), ("split_k2", 2), ("split_rw", 1)])
def test_split_period_batch_selects_the_global_periods(case, k, two_ranks):
    """Each half of the batch alone selects its own dominant period; two
    ranks, each holding one half, must select the whole batch's, as JAX's
    selector does on the whole batch (with padded rows masked out)."""

    x = _split_period_batch()
    rw = None
    if case == "split_rw":
        rw = np.ones(16, np.float32)
        rw[[3, 12]] = 0.0
    want = jperiod.select_periods(jnp.asarray(x), k, SPLIT_L, 2,
                                  None if rw is None else jnp.asarray(rw))
    want_periods = np.asarray(want.periods)
    assert want_periods[0] == 7
    for out in two_ranks:
        np.testing.assert_array_equal(out[case]["periods"], want_periods)
        np.testing.assert_array_equal(out[case]["bins"], np.asarray(want.freq_indices))
    # each half alone (the port, no group) selects its own period: a
    # selection from a rank's rows would differ from the whole batch's
    for half, own in ((slice(0, 8), 12), (slice(8, 16), 7)):
        alone = pperiod.select_periods(torch.from_numpy(x[half].copy()), k, SPLIT_L, 2,
                                       None if rw is None else torch.from_numpy(rw[half].copy()))
        assert int(alone.periods[0]) == own
