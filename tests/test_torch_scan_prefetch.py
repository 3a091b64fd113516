"""The host pipeline's prefetch thread and ``train.scan_steps``, against
the JAX package and against the unprefetched pipeline.

``data/windows.py::Prefetcher`` is the JAX package's: the batcher's batches
in order, a producer's error raised at the consumer, the producer released
on ``close()``. ``train.scan_steps`` is accepted and ignored by the port,
which takes one ``train_step`` a batch: the JAX package's scanned chunk
equals those steps within the tolerances of
``tests/test_torch_train_step.py`` (dropout off), and ``train_once`` on the
host pipeline with ``scan_steps`` and ``prefetch_factor`` trains what it
trains without them, bit for bit.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import (  # noqa: E402
    flat_params, init_tree, jax_batch, jax_engine, port_engine, torch_batch, window_batch,
)

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu.data import windows as jwindows  # noqa: E402
from flow_timesnet_tpu_torch import train as ptrain  # noqa: E402
from flow_timesnet_tpu_torch.data import windows  # noqa: E402
from flow_timesnet_tpu_torch.engine import Engine  # noqa: E402

TINY = dict(n_layers=1, kernel_set=((3, 3),))
LR = 1e-3


def test_a_jax_scanned_chunk_matches_the_ports_single_steps():
    tree = init_tree(**TINY)
    batches = [window_batch(40 + i, pad_row=i % 2 == 0) for i in range(3)]
    eng = jax_engine(model_kw=TINY, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jengine.TrainState(params=params, opt_state=eng.tx.init(params), grad_accum=None,
                               ema=jax.tree_util.tree_map(lambda p: p.copy(), params))
    stacked = {k: jnp.stack([jax_batch(b)[k] for b in batches]) for k in batches[0]}
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(3)])
    state, want_losses, want_mask = eng.train_steps_scanned(state, LR, rngs, stacked)
    port = port_engine(tree, model_kw=TINY)
    pstate, losses, masks = port.init_state(), [], []
    for b in batches:
        pstate, loss, stats = port.train_step(pstate, LR, None, torch_batch(b))
        losses.append(float(loss))
        masks.append(float(stats["mask_true"]))
    np.testing.assert_allclose(losses, np.asarray(want_losses), rtol=1e-5)
    np.testing.assert_array_equal(masks, np.asarray(want_mask))
    # Adam's first updates are about lr * sign(g): the bound of test_torch_train_step.py
    want = flat_params(state.params)
    diff = np.concatenate([np.abs(pstate.params[k].detach().numpy() - want[k]).ravel()
                           for k in want])
    assert diff.max() <= 2 * 3 * LR and np.mean(diff > 1e-3 * LR + 1e-6) <= 0.01


def _batcher(shuffle=True, seed=3):
    rng = np.random.default_rng(seed)
    values = rng.poisson(4.0, (90, 5)).astype(np.float32)
    kw = dict(input_len=14, pred_len=7, stride=1, mode="direct", batch_size=8, shuffle=shuffle,
              drop_last=False, seed=seed, pad_final=True)
    return (windows.build_batcher([values], [np.ones_like(values)], **kw),
            jwindows.build_batcher([values], [np.ones_like(values)], **kw))


def _same_batch(a, b):
    for name in ("x", "y", "mask", "x_mark", "y_mark", "static", "series_ids", "row_valid"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_the_prefetcher_yields_the_batchers_batches_in_order(depth):
    port, jax_batcher = _batcher()
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax_batcher.set_epoch(epoch)
        want = list(jwindows.Prefetcher(iter(jax_batcher), depth))
        got = list(windows.Prefetcher(port, depth))
        assert len(got) == len(want) == len(port) > 1
        for a, b in zip(got, want):
            _same_batch(a, b)


def test_a_producer_error_is_raised_at_the_consumer():
    def batches():
        yield 1
        yield 2
        raise RuntimeError("the batcher failed")

    pre = windows.Prefetcher(batches(), 2)
    assert [next(pre), next(pre)] == [1, 2]
    with pytest.raises(RuntimeError, match="the batcher failed"):
        next(pre)


def test_close_releases_the_producer():
    made = []

    def endless():
        while True:
            made.append(len(made))
            yield made[-1]

    pre = windows.Prefetcher(endless(), 2)
    assert next(pre) == 0
    time.sleep(0.05)  # the producer fills the queue and blocks on it
    pre.close()
    assert not pre._thread.is_alive()
    assert not any(t.name == "flow-timesnet-prefetch" and t is pre._thread
                   for t in threading.enumerate())
    n = len(made)
    with pytest.raises(StopIteration):
        next(pre)  # a late next stops, it does not block
    assert len(made) == n and n <= 5  # the producer made at most depth + a few, then stopped


def test_train_once_prefetches_what_unprefetched_steps_train(tmp_path, monkeypatch):
    """The host pipeline (``train.input_pipeline: host``) with
    ``scan_steps: 4`` and ``prefetch_factor: 2`` against ``scan_steps: 0``
    and ``prefetch_factor: 0``: the same losses and the same checkpoint
    bytes over an epoch, one ``train_step`` a batch in both, a prefetch
    thread in the first only."""

    from test_torch_train_once_control import control_config, write_csv

    csv = write_csv(tmp_path)
    calls = {"steps": 0, "prefetchers": 0}
    single, prefetcher = Engine.train_step, windows.Prefetcher.__init__

    def count_single(self, *args, **kwargs):
        calls["steps"] += 1
        return single(self, *args, **kwargs)

    def count_prefetchers(self, *args, **kwargs):
        calls["prefetchers"] += 1
        prefetcher(self, *args, **kwargs)

    monkeypatch.setattr(Engine, "train_step", count_single)
    monkeypatch.setattr(windows.Prefetcher, "__init__", count_prefetchers)
    out, counted = {}, {}
    for name, scan, depth in (("prefetched", 4, 2), ("plain", 0, 0)):
        art = tmp_path / name
        cfg = control_config(csv, art, 1, input_pipeline="host", scan_steps=scan,
                             prefetch_factor=depth, freeze_periods=False)
        cfg["model"]["dropout"] = 0.1
        best, _ = ptrain.train_once(cfg)
        out[name] = (best, (art / "timesnet.msgpack").read_bytes())
        counted[name] = dict(calls)
        calls.update(steps=0, prefetchers=0)
    assert counted["prefetched"]["prefetchers"] == 1  # one an epoch
    assert counted["plain"]["prefetchers"] == 0
    assert counted["prefetched"]["steps"] == counted["plain"]["steps"] > 4
    assert out["prefetched"][0] == out["plain"][0]
    assert out["prefetched"][1] == out["plain"][1]
