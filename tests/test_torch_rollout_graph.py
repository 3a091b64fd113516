"""The port's recursive decode (``Engine.rollout``) against the JAX package's.

On the card the port captures the whole decode as one CUDA graph, the
counterpart of the JAX package's ``lax.scan`` decode (its replay is held to
the eager decode bit for bit by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``'s ``[rollout]``). On the CPU the same body runs eagerly:
here it is held to JAX's ``Engine.rollout`` within 1e-4 on the same numpy
inputs and carried parameters, with and without calendar marks and under a
period-bucket ladder, and to a decode written out step by step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from port_helpers import MODEL_KW, perturb, unflat_params  # noqa: E402

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu_torch import convert, engine  # noqa: E402
from flow_timesnet_tpu_torch.models import timesnet  # noqa: E402

# the flagship-shaped small model in recursive mode (one step a forward),
# two kernel sizes to keep JAX's compile short
KW = {**MODEL_KW, "mode": "recursive", "kernel_set": ((3, 3), (5, 5)), "n_layers": 1}
HORIZON = 7


def _inputs(seed, batch=4, marks=True):
    rng = np.random.default_rng(seed)
    t = np.arange(KW["input_len"])
    x = (2.0 + np.sin(2 * np.pi * t / 7 + rng.uniform(0, 6, (batch, 1)))
         + 0.2 * rng.standard_normal((batch, KW["input_len"])))[:, :, None]
    tf = KW["time_features"]
    return dict(
        x=x.astype(np.float32),
        x_mark=rng.uniform(-1, 1, (batch, KW["input_len"], tf)).astype(np.float32)
        if marks else None,
        y_mark=rng.uniform(-1, 1, (batch, HORIZON, tf)).astype(np.float32) if marks else None,
        static=rng.standard_normal((batch, 1, KW["static_dim"])).astype(np.float32),
        ids=(np.arange(batch) % KW["id_vocab"]).reshape(batch, 1).astype(np.int32),
        floor=rng.uniform(0.01, 0.1, (batch, 1, 1)).astype(np.float32),
    )


def _tree(kw):
    cfg = timesnet.TimesNetConfig(**kw)
    init = convert.init_params(cfg, torch.Generator().manual_seed(3))
    return perturb(unflat_params({k: v.numpy() for k, v in init.items()}), seed=4)


def _port(kw, tree):
    cfg = timesnet.TimesNetConfig(**kw)
    return engine.Engine(cfg, convert.params_from_jax(tree, cfg), device="cpu")


ORDER = ("x", "horizon", "x_mark", "y_mark", "static", "ids", "floor")


def _call(fn, inp, horizon, to):
    return fn(*(horizon if k == "horizon" else (None if inp[k] is None else to(inp[k]))
                for k in ORDER))


@pytest.mark.parametrize("marks,buckets", [(True, None), (False, None), (True, "auto")],
                         ids=["marks", "no-marks", "buckets"])
def test_recursive_decode_matches_jax(marks, buckets):
    kw = dict(KW, period_buckets=buckets)
    if not marks:
        kw["time_features"] = 0
    tree = _tree(kw)
    inp = _inputs(5, marks=marks)
    jeng = jengine.Engine(jtn.TimesNetConfig(**kw), donate=False)
    want_rate, want_disp = _call(lambda x, h, *a: jeng.rollout(tree, x, h, *a), inp, HORIZON,
                                 jnp.asarray)
    port = _port(kw, tree)
    rate, disp = _call(port.rollout, inp, HORIZON, torch.from_numpy)
    assert tuple(rate.shape) == tuple(disp.shape) == (4, HORIZON, 1)
    np.testing.assert_allclose(rate.numpy(), np.asarray(want_rate), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(disp.numpy(), np.asarray(want_disp), rtol=1e-4, atol=1e-4)


def test_the_decode_is_the_forward_fed_its_own_last_rate():
    """Step by step: each forward's last rate goes on the end of the window
    and the next future mark on the end of the marks; the decode of a
    shorter horizon is the start of a longer one's."""

    tree = _tree(KW)
    port = _port(KW, tree)
    inp = {k: (None if v is None else torch.from_numpy(v)) for k, v in _inputs(6).items()}
    rate, disp = port.rollout(inp["x"], HORIZON, inp["x_mark"], inp["y_mark"], inp["static"],
                              inp["ids"], inp["floor"])
    window, marks, steps = inp["x"], inp["x_mark"], []
    with torch.inference_mode():
        for s in range(HORIZON):
            r, d = port.model(window, marks, inp["static"], inp["ids"], inp["floor"])
            steps.append((r[:, -1], d[:, -1]))
            window = torch.cat([window[:, 1:], r[:, -1:]], dim=1)
            marks = torch.cat([marks[:, 1:], inp["y_mark"][:, s:s + 1]], dim=1)
    assert torch.equal(rate, torch.stack([r for r, _ in steps], dim=1))
    assert torch.equal(disp, torch.stack([d for _, d in steps], dim=1))
    short, _ = port.rollout(inp["x"], 3, inp["x_mark"], inp["y_mark"], inp["static"],
                            inp["ids"], inp["floor"])
    assert torch.equal(short, rate[:, :3])
    with pytest.raises(ValueError, match="future marks"):
        port.rollout(inp["x"], 2, inp["x_mark"], None)
