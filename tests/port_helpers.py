"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: both sides take the same numpy values."""

import jax
import numpy as np
import torch

# A flagship-shaped small model: d_model 16, d_ff 64, two layers, kernels
# 3/5/7 with bottleneck 4, static features, series ids, a rank-4 temporal
# context and 8 time features.
B, L, H, TF, STATIC = 6, 28, 7, 8, 5
MODEL_KW = dict(
    input_len=L, pred_len=H, d_model=16, d_ff=64, n_layers=2, k_periods=2,
    kernel_set=((3, 3), (5, 5), (7, 7)), bottleneck_ratio=4.0, min_period_threshold=7,
    id_embed_dim=4, static_dim=STATIC, static_proj_dim=4, use_zero_mean_context=True,
    context_rank=4, context_scale=0.05, time_features=TF, id_vocab=B, dropout=0.0,
)


def model_inputs(seed, batch=B):
    """Seeded model inputs: tie-free weekly and 9.3-step cycles at random
    phases and amplitudes (no two rFFT bins tie, so both sides select the
    same periods), calendar marks, static features, ids and floors."""

    rng = np.random.default_rng(seed)
    t = np.arange(L)
    phase = rng.uniform(0, 2 * np.pi, size=(batch, 1))
    x = (np.sin(2 * np.pi * t / 7 + phase) * rng.uniform(0.5, 2.0, (batch, 1))
         + 0.6 * np.cos(2 * np.pi * t / 9.3 + 2 * phase)
         + 0.3 * rng.standard_normal((batch, L)))
    return dict(
        x=x[:, :, None].astype(np.float32),
        x_mark=rng.uniform(-1, 1, (batch, L, TF)).astype(np.float32),
        static=rng.standard_normal((batch, 1, STATIC)).astype(np.float32),
        ids=(rng.permutation(batch) % B).reshape(batch, 1).astype(np.int32),
        floor=rng.uniform(0.01, 0.1, (batch, 1, 1)).astype(np.float32),
    )


def flat_params(tree, prefix=""):
    """Nested dicts of arrays -> {"a.b.c": float32 array}, the port's names."""

    out = {}
    for key, value in dict(tree).items():
        if hasattr(value, "items"):
            out.update(flat_params(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value, np.float32)
    return out


def unflat_params(flat):
    """The inverse of :func:`flat_params`: a flax-style nested dict."""

    tree = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value, np.float32)
    return tree


def perturb(tree, seed, scale=0.05):
    """``tree`` plus seeded numpy noise on every leaf, so that no head is zero."""

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        unflat_params(flat_params(tree)),
    )


def load_tree(module, tree):
    """Load a flax-style tree into a port module (strict) and set eval mode."""

    module.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in flat_params(tree).items()})
    return module.eval()


def window_batch(seed, pad_row=True, nan_target=True, batch=B):
    """Model inputs plus targets as a window batch: the last row padding
    (``row_valid`` 0, zero-filled as ``pad_batch_rows`` does), row 1 all
    masked and a NaN target at a masked position of row 2."""

    rng = np.random.default_rng(100 + seed)
    out = model_inputs(seed, batch)
    out["y"] = rng.poisson(2.0, (batch, H, 1)).astype(np.float32)
    out["mask"] = (rng.random((batch, H, 1)) < 0.85).astype(np.float32)
    out["row_valid"] = np.ones(batch, np.float32)
    out["mask"][1] = 0.0
    if pad_row:
        for k in ("x", "y", "mask", "x_mark", "static", "floor"):
            out[k][-1] = 0.0
        out["ids"][-1] = 0
        out["row_valid"][-1] = 0.0
    if nan_target:
        out["y"][2, 3, 0] = np.nan
        out["mask"][2, 3, 0] = 0.0
    return out


def init_tree(**model_kw):
    """The JAX package's init of ``MODEL_KW`` updated by ``model_kw``, plus
    seeded noise: no head is zero."""

    from flow_timesnet_tpu.models import timesnet as jtn

    inp = {k: jax.numpy.asarray(v) for k, v in model_inputs(0).items()}
    model = jtn.TimesNet(jtn.TimesNetConfig(**{**MODEL_KW, **model_kw}))
    params = jax.jit(lambda key: model.init(
        {"params": key}, inp["x"], inp["x_mark"], inp["static"], inp["ids"],
        dispersion_floor=inp["floor"]))(jax.random.PRNGKey(11))["params"]
    return perturb(params, seed=1)


# the flagship's training settings, at the small model's vocab
ENGINE_KW = dict(use_loss_masking=True, grad_clip_norm=1.0, weight_decay=1e-6,
                 num_series=B, ema_decay=0.99)


def jax_batch(batch):
    """``batch`` for the JAX engine. Its gradient through a masked NaN target
    is NaN (0 times the NaN derivative of the unselected branch); the masked
    value does not enter the loss, so JAX gets a 0 there and the port keeps
    the NaN."""

    return {k: jax.numpy.asarray(np.nan_to_num(v) if k == "y" else v) for k, v in batch.items()}


def torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in batch.items()}


def port_engine(tree, dtype="float32", model_kw=None, **engine_kw):
    """A port Engine on the CPU holding ``tree``."""

    from flow_timesnet_tpu_torch import convert, engine
    from flow_timesnet_tpu_torch.models import timesnet

    cfg = timesnet.TimesNetConfig(**{**MODEL_KW, **(model_kw or {})}, compute_dtype=dtype)
    return engine.Engine(cfg, convert.params_from_jax(tree, cfg), device="cpu",
                         **{**ENGINE_KW, **engine_kw})


def jax_engine(dtype="float32", model_kw=None, **engine_kw):
    from flow_timesnet_tpu import engine as jengine
    from flow_timesnet_tpu.models import timesnet as jtn

    cfg = jtn.TimesNetConfig(**{**MODEL_KW, **(model_kw or {})}, compute_dtype=dtype)
    return jengine.Engine(cfg, **{**ENGINE_KW, **engine_kw})


def loss_grads(tree, batch, dtype="float32", model_kw=None):
    """``(loss, stats, grads)`` of ``Engine._loss`` on both sides: port, JAX."""

    eng = port_engine(tree, dtype, model_kw)
    eng.model.train()
    loss, stats = eng._loss(torch_batch(batch), None)
    loss.backward()
    # a parameter that does not enter the loss (a skipped block) has no grad: 0, as in JAX
    port = (float(loss.detach()), {k: float(v) for k, v in stats.items()},
            {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for k, p in eng.model.named_parameters()})
    jeng = jax_engine(dtype, model_kw)
    fn = jax.jit(jax.value_and_grad(jeng._loss, has_aux=True))
    (jloss, jstats), grads = fn(tree, jax_batch(batch), jax.random.PRNGKey(0))
    return port, (float(jloss), {k: float(v) for k, v in jstats.items()}, flat_params(grads))


def assert_grads_close(got, want, rtol):
    """Every gradient finite and within ``rtol`` of the largest one."""

    assert sorted(got) == sorted(want)
    scale = max(1.0, max(float(np.abs(g).max()) for g in want.values()))
    for name, g in got.items():
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, want[name], rtol=rtol, atol=rtol * scale, err_msg=name)


# --- the tensor cores' fragment layouts, for the numpy models of the kernels --
# mma.sync m16n8k16 with bf16 operands (PTX ISA): lane l has g = l // 4 and
# q = l % 4; each register holds a pair of consecutive bf16 values.

def ldmatrix(smem, addresses, trans=False, n=4):
    """ldmatrix.sync.aligned.m8n8.x{n}[.trans].b16 on a 2-D array: lane l names
    row l % 8 of matrix l // 8 (8 consecutive elements from ``addresses[l]``,
    a (row, column) pair; lanes past 8 n are not read). In register j lane l
    gets matrix j's elements (l // 4, 2 (l % 4) + half), or with ``trans``
    (2 (l % 4) + half, l // 4). Returns [32, n, 2]."""

    out = np.empty((32, n, 2), smem.dtype)
    for j in range(n):
        mat = np.stack([smem[r, c:c + 8] for r, c in addresses[8 * j:8 * j + 8]])
        for lane in range(32):
            for half in range(2):
                a, b = lane // 4, 2 * (lane % 4) + half
                out[lane, j, half] = mat[b, a] if trans else mat[a, b]
    return out


def a_matrix(frag):
    """The 16 x 16 A (m, k) that an m16n8k16 A fragment [32, 4, 2] holds:
    registers (row g, k 2q), (row g + 8, k 2q), (row g, k 8 + 2q), (row g + 8, k 8 + 2q)."""

    a = np.full((16, 16), np.nan, frag.dtype)
    for lane in range(32):
        g, k = lane // 4, 2 * (lane % 4)
        for reg, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            a[g + dm, k + dk:k + dk + 2] = frag[lane, reg]
    return a


def b_matrix(frag):
    """The 16 x 8 B (k, n) that an m16n8k16 B fragment [32, 2, 2] holds:
    registers (k 2q, n g) and (k 8 + 2q, n g)."""

    b = np.full((16, 8), np.nan, frag.dtype)
    for lane in range(32):
        for reg in range(2):
            k = 2 * (lane % 4) + 8 * reg
            b[k:k + 2, lane // 4] = frag[lane, reg]
    return b


def a_fragment_rows(lane):
    """The rows of an m-tile that lane's A registers 0-3 hold: g, g + 8, g, g + 8."""

    g = lane // 4
    return (g, g + 8, g, g + 8)


def float4_wavefronts(addresses):
    """Shared-memory wavefronts of one 16-byte load of a warp, its lanes' float4
    ``addresses`` (in float4s): the distinct ones, each 128-byte wavefront
    serving at most one per bank group (address mod 8)."""

    distinct = set(addresses)
    return int(np.bincount([a % 8 for a in distinct], minlength=8).max())
