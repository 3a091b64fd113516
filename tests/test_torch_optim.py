"""The port's optimizer and learning-rate schedules against the JAX package's.

Five steps of ``build_optimizer`` on a random parameter tree with random
gradients against the optax chain of ``flow_timesnet_tpu.optim``, with the
global-norm clip active and inactive and with and without weight decay;
accumulation runs through ``Engine.train_step`` in ``test_torch_train_step.py``.
The schedules are pure Python on both sides and must agree exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flow_timesnet_tpu import optim as joptim  # noqa: E402
from flow_timesnet_tpu_torch import optim  # noqa: E402

SHAPES = {"a": (4, 3), "b": (7,), "c": (2, 5, 3)}


def _run_both(clip, wd, steps=5, lr=1e-2, grad_scale=1.0):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]

    tx = joptim.build_optimizer(clip, wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u * lr, jp, updates)

    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = optim.build_optimizer(tp.values(), clip, wd)
    for g in grads:
        opt.step([torch.from_numpy(g[k].copy()) for k in tp], lr)
    return {k: np.asarray(v) for k, v in jp.items()}, {k: v.numpy() for k, v in tp.items()}


@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["no_wd", "wd"])
@pytest.mark.parametrize("clip,grad_scale", [(0.0, 1.0), (1.0, 1.0), (100.0, 1.0), (1.0, 1e-3)],
                         ids=["no_clip", "clip_active", "clip_above_norm", "clip_small_grads"])
def test_optimizer_matches_optax(clip, grad_scale, wd):
    want, got = _run_both(clip, wd, grad_scale=grad_scale)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_clip_follows_optax_not_clip_grad_norm():
    """Below the limit the gradients are untouched; above it each becomes
    g / norm * max_norm, with no epsilon added to the norm."""

    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = optim.clip_by_global_norm_(g, 5.0)  # norm == limit: clipped to itself
    assert float(norm) == 5.0 and torch.equal(g[0], torch.tensor([3.0, 4.0]) / 5.0 * 5.0)
    g = [torch.tensor([3.0, 4.0])]
    optim.clip_by_global_norm_(g, 6.0)
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]))
    g = [torch.tensor([30.0, 40.0])]
    optim.clip_by_global_norm_(g, 1.0)
    assert torch.equal(g[0], torch.tensor([0.6, 0.8]))


@pytest.mark.parametrize(
    "sched,warmup,epochs,per_epoch",
    [
        ({"type": "cosine", "eta_min": 1e-5}, (400, None), 30, 248),
        ({"type": "cosine", "T_max": 10}, (None, 3), 12, 5),
        ({"type": "StepLR", "step_size": 3, "gamma": 0.5}, (None, None), 10, 7),
        ({"type": "StepLR", "step_size": 2}, (10, None), 8, 4),
        ({"type": "warmup_only"}, (None, 4), 8, 3),
        ({"type": "ReduceLROnPlateau", "patience": 1, "factor": 0.5}, (5, None), 8, 3),
    ],
)
def test_lr_controller_matches_jax(sched, warmup, epochs, per_epoch):
    spec_j = joptim.resolve_warmup(*warmup, per_epoch)
    spec = optim.resolve_warmup(*warmup, per_epoch)
    assert (spec.epochs, spec.steps, spec.start_factor) == \
        (spec_j.epochs, spec_j.steps, spec_j.start_factor)
    want = joptim.LRController(9.878e-4, epochs, sched, spec_j)
    got = optim.LRController(9.878e-4, epochs, sched, spec)
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7]
    for ep in range(1, epochs + 1):
        assert got.lr_for_epoch(ep) == want.lr_for_epoch(ep), ep
        got.observe(metrics[ep % len(metrics)])
        want.observe(metrics[ep % len(metrics)])
    assert got.state_dict() == want.state_dict()
    assert got.effective_summary() == want.effective_summary()
    with pytest.raises(ValueError):
        optim.resolve_warmup(10, 2, per_epoch)
