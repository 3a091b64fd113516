"""The port's counterpart of the repository's ``__graft_entry__.py``.

``entry()`` returns the flagship forward (``configs/demand_benchmark.yaml``'s
model, 192 series' vocabulary, seeded random weights) and its example
arguments, on the card unless ``device="cpu"``. ``dryrun_multichip(n)``
runs what the JAX package's does on ``n`` gloo ranks on the CPU: one
data-parallel training step with the series table row-sharded, a two-step
resident epoch over a plan sharded by columns, and a frozen resident epoch
on the spec that ``sync_frozen_spec`` gave every rank; it prints the same
line. It touches no card.
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import torch

from .models.timesnet import TimesNetConfig

_RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                       "demand_benchmark.yaml")


def flagship_config(input_len: int = 28, pred_len: int = 7, **overrides) -> TimesNetConfig:
    """The flagship model from the shipped recipe, at the bundled dataset's
    data dimensions (192 series, 5 static features, the recipe's calendar
    features); ``overrides`` replace any field."""

    from .build import merged_config_from_yaml, time_feature_dim_of, timesnet_config_from_dict

    cfg = merged_config_from_yaml(_RECIPE)
    tn = timesnet_config_from_dict(cfg, static_dim=5, time_feature_dim=time_feature_dim_of(cfg),
                                   id_vocab=192,
                                   min_sigma=float(cfg.get("train", {}).get("min_sigma", 1e-3)))
    return replace(tn, input_len=input_len, pred_len=pred_len, **overrides)


def example_batch(cfg: TimesNetConfig, batch_size: int, seed: int = 0):
    """``(x, marks, static, ids, y)`` as numpy, the JAX package's example batch."""

    rng = np.random.default_rng(seed)
    t = np.arange(cfg.input_len, dtype=np.float32)
    x = (2.0 + np.sin(2 * np.pi * t / 7.0)[None, :, None]
         + 0.3 * rng.standard_normal((batch_size, cfg.input_len, cfg.c_in))).astype(np.float32)
    marks = rng.standard_normal((batch_size, cfg.input_len, cfg.time_features)).astype(np.float32)
    static = rng.standard_normal((batch_size, cfg.c_in, cfg.static_dim)).astype(np.float32)
    ids = rng.integers(0, cfg.id_vocab, size=(batch_size, cfg.c_in)).astype(np.int32)
    y = np.maximum(rng.poisson(3.0, size=(batch_size, cfg.pred_len, cfg.c_in)), 0).astype(
        np.float32)
    return x, marks, static, ids, y


def entry(device: str = "cuda", **overrides):
    """``(forward_step, example_args)``: ``forward_step(params, x, marks,
    static, ids) -> (rate, dispersion)`` of the flagship model (fields
    replaced by ``overrides``) on ``device``, and its arguments (a batch of
    128)."""

    from torch.func import functional_call

    from . import convert
    from .device import resolve_device
    from .models.timesnet import TimesNet

    dev = resolve_device(device)
    cfg = flagship_config(**overrides)
    params = {k: v.to(dev) for k, v in
              convert.init_params(cfg, torch.Generator().manual_seed(0)).items()}
    model = TimesNet(cfg).to(dev).eval()

    @torch.inference_mode()
    def forward_step(params, x, marks, static, ids):
        return functional_call(model, params, (x, marks, static, ids))

    x, marks, static, ids, _ = example_batch(cfg, 128)
    return forward_step, (params, *(torch.from_numpy(a).to(dev) for a in (x, marks, static, ids)))


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel step, a resident epoch and a frozen resident epoch
    on ``n_devices`` gloo ranks on the CPU; prints rank 0's line."""

    from .parallel import mesh

    out = mesh.launch(_dryrun_rank, int(n_devices), int(n_devices), threads=1)
    losses = [o["loss"] for o in out]
    if len(set(losses)) != 1:
        raise RuntimeError(f"multichip dry-run: the ranks' losses differ: {losses}")
    print(out[0]["line"], flush=True)


def _dryrun_rank(n_devices: int) -> dict:
    from . import convert
    from .data.device_windows import epoch_index_plan, stage_windows
    from .engine import Engine
    from .parallel import mesh

    batch = 4 * n_devices
    cfg = flagship_config(input_len=16, pred_len=4, d_model=16, d_ff=32, n_layers=2,
                          kernel_set=((3, 3),), min_period_threshold=2, id_vocab=8 * n_devices,
                          id_embed_dim=8, static_dim=3, time_features=4, static_proj_dim=4,
                          context_rank=2, dropout=0.1)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    engine_kw = dict(use_loss_masking=True, grad_clip_norm=1.0, weight_decay=1e-6,
                     num_series=cfg.id_vocab, shard_table=True)
    engine = Engine(cfg, params, "cpu", **engine_kw)
    if engine.sharded != (mesh.TABLE_NAME,) and n_devices > 1:
        raise RuntimeError("multichip dry-run: the series table is not row-sharded")
    x, marks, static, ids, y = example_batch(cfg, batch)
    host = {"x": x, "y": y, "mask": np.ones_like(y), "x_mark": marks, "static": static,
            "ids": ids, "row_valid": np.ones(batch, np.float32)}
    local = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in mesh.shard_rows(host).items()}
    gen = torch.Generator().manual_seed(1 + mesh.rank())  # each rank's own dropout masks
    state = engine.init_state()
    state, loss, _ = engine.train_step(state, 1e-3, gen, local)
    loss_val = float(loss)
    if not np.isfinite(loss_val):
        raise RuntimeError(f"multichip dry-run produced non-finite loss: {loss_val}")

    # the resident pipeline: staged windows on every rank, a [S, B] plan each
    # rank takes its columns of
    rng = np.random.default_rng(0)
    T, N = 48, cfg.id_vocab
    t = np.arange(T, dtype=np.float32)
    X = (2.0 + np.sin(2 * np.pi * t / 7.0)[:, None]
         + 0.3 * rng.standard_normal((T, N))).astype(np.float32)
    staged = stage_windows(
        [X], [np.ones((T, N), np.float32)], cfg.input_len, cfg.pred_len, 1, "direct",
        marks=[rng.standard_normal((T, cfg.time_features)).astype(np.float32)],
        static=rng.standard_normal((N, cfg.static_dim)).astype(np.float32),
        sigma_vector=np.full(N, 0.1, np.float32), device="cpu")
    idx, rv = epoch_index_plan(staged.total, batch, None, shuffle=True, drop_last=True,
                               rng=np.random.default_rng(1))
    idx, rv = idx[:2], rv[:2]  # two steps suffice to validate
    state, ep_losses, _ = engine.train_epoch_resident(state, 1e-3, gen, staged, idx, rv)
    resident_losses = ep_losses.numpy()
    if not np.all(np.isfinite(resident_losses)):
        raise RuntimeError(f"resident-epoch dry-run produced non-finite losses: {resident_losses}")

    # the frozen path on the spec every rank holds after sync_frozen_spec
    telemetry = engine.collect_period_telemetry_staged(state.params, staged, idx[0], rv[0])
    spec = Engine.frozen_spec_from_telemetry(telemetry, cfg.n_layers)
    spec = mesh.sync_frozen_spec(spec, cfg.n_layers, cfg.k_periods)
    if spec is None:
        raise RuntimeError("multichip dry-run: telemetry yielded no frozen spec")
    frozen = Engine(replace(cfg, frozen_periods=spec), params, "cpu", **engine_kw)
    state, fr_losses, _ = frozen.train_epoch_resident(state, 1e-3, gen, staged, idx, rv)
    frozen_losses = fr_losses.numpy()
    if not np.all(np.isfinite(frozen_losses)):
        raise RuntimeError(
            f"frozen resident-epoch dry-run produced non-finite losses: {frozen_losses}")
    frozen_periods = sorted({p for layer in spec for p, _, v in layer if v})
    line = (f"dryrun_multichip({n_devices}): ok, loss={loss_val:.6f}, "
            f"resident_epoch_losses={[round(float(v), 4) for v in resident_losses]}, "
            f"frozen_epoch_losses={[round(float(v), 4) for v in frozen_losses]} "
            f"(frozen periods {frozen_periods})")
    return {"loss": loss_val, "resident": resident_losses, "frozen": frozen_losses,
            "spec": spec, "line": line}
