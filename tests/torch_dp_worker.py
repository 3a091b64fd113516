"""Rank bodies of the port's data-parallel tests.

``flow_timesnet_tpu_torch.parallel.mesh.launch`` runs :func:`run_jobs` in
gloo processes on the CPU, one per rank; the parent process holds the JAX
package's results. Nothing here imports JAX. Every input is numpy (made
from a seed in the parent) and every result comes back as numpy.
"""

import numpy as np
import torch

from flow_timesnet_tpu_torch import engine as engine_mod
from flow_timesnet_tpu_torch.data.device_windows import stage_windows
from flow_timesnet_tpu_torch.models import period
from flow_timesnet_tpu_torch.models.timesnet import TimesNetConfig
from flow_timesnet_tpu_torch.parallel import mesh

# a tiny model both packages build alike: the JAX package's own
# tests/test_data_parallel.py configuration
TINY = dict(input_len=16, pred_len=4, d_model=8, d_ff=16, n_layers=1, k_periods=2,
            kernel_set=((3, 3),), dropout=0.0, mode="direct", min_period_threshold=2, c_in=1,
            id_vocab=8, id_embed_dim=4, static_dim=3, static_proj_dim=4, time_features=2)
ENGINE_KW = dict(use_loss_masking=True, grad_clip_norm=1.0, num_series=8)
LR = 1e-3


def make_batch(B, seed=0):
    """The JAX package's DP test batch, as numpy: ``x``, ``y``, ``mask``,
    ``x_mark``, ``static``, ``ids``, ``row_valid``."""

    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((B, 16, 1)).astype(np.float32) + 3,
        "y": rng.poisson(3.0, (B, 4, 1)).astype(np.float32),
        "mask": np.ones((B, 4, 1), np.float32),
        "x_mark": rng.standard_normal((B, 16, 2)).astype(np.float32),
        "static": rng.standard_normal((B, 1, 3)).astype(np.float32),
        "ids": rng.integers(0, 8, (B, 1)).astype(np.int32),
        "row_valid": np.ones(B, np.float32),
    }


def make_staged_arrays(seed=5, T=60, N=4):
    rng = np.random.default_rng(seed)
    return ([rng.normal(4.0, 1.0, size=(T, N)).astype(np.float32)],
            [np.ones((T, N), np.float32)])


def _tensors(batch):
    return {k: (None if v is None else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in batch.items()}


def _engine(params, model_kw=None, shard=False, engine_kw=None):
    cfg = TimesNetConfig(**{**TINY, **(model_kw or {})})
    return engine_mod.Engine(cfg, {k: torch.from_numpy(v.copy()) for k, v in params.items()},
                             device="cpu", shard_table=shard,
                             **{**ENGINE_KW, **(engine_kw or {})})


def _whole(eng, named):
    return {k: v.numpy() for k, v in mesh.host_fetch(named, eng.sharded).items()}


def steps(params, batch, n=3, shard=False, model_kw=None, engine_kw=None):
    """``n`` steps on this rank's rows of the global ``batch``: the losses,
    the assembled parameters and what this rank holds of the table."""

    eng = _engine(params, model_kw, shard, engine_kw)
    state = eng.init_state()
    local = _tensors(mesh.shard_rows(batch))
    losses, stats = [], None
    for _ in range(n):
        state, loss, stats = eng.train_step(state, LR, None, local)
        losses.append(float(loss))
    return {"losses": losses, "params": _whole(eng, state.params),
            "mask_true": float(stats["mask_true"]), "mask_total": float(stats["mask_total"]),
            "table_rows": int(state.params[mesh.TABLE_NAME].shape[0]),
            "sharded": list(eng.sharded)}


def evaluate(params, batches):
    """``Engine.evaluate`` over this rank's rows of each global batch."""

    eng = _engine(params)
    out = eng.evaluate(None, [_tensors(mesh.shard_rows(b)) for b in batches])
    return {k: (np.asarray(v) if isinstance(v, np.ndarray) else float(v)) for k, v in out.items()}


def resident(params, arrays, masks, idx, rv, model_kw=None, engine_kw=None):
    """A resident epoch over the global plan ``idx``/``rv`` [S, B] (each
    rank takes its columns), then ``evaluate_resident`` over it."""

    cfg_kw = {**TINY, **(model_kw or {})}
    eng = _engine(params, model_kw, engine_kw=engine_kw)
    staged = stage_windows(arrays, masks, cfg_kw["input_len"], cfg_kw["pred_len"], 1, "direct",
                           device="cpu")
    state = eng.init_state()
    state, losses, mask_true = eng.train_epoch_resident(state, LR, None, staged, idx, rv)
    metrics = eng.evaluate_resident(state.params, staged, idx, rv)
    return {"losses": losses.numpy(), "mask_true": mask_true.numpy(),
            "nll": float(metrics["nll"]), "params": _whole(eng, state.params)}


def selection(x, k_periods, min_period_threshold=2, row_weight=None):
    """The shared selector's periods on this rank's rows of ``x`` [B, L, 1]
    (the whole batch's under the group)."""

    rows = mesh.rank_rows(x.shape[0])
    mine = torch.from_numpy(x[rows].copy())
    rw = None if row_weight is None else torch.from_numpy(row_weight[rows].copy())
    sel = period.select_periods(mine, k_periods, x.shape[1], min_period_threshold, rw)
    return {"periods": sel.periods.numpy(), "bins": sel.freq_indices.numpy()}


def telemetry(params, batch, model_kw=None):
    """``Engine.collect_period_telemetry`` on this rank's rows of ``batch``."""

    eng = _engine(params, model_kw)
    tel = eng.collect_period_telemetry(None, _tensors(mesh.shard_rows(batch)))
    return {k: {n: np.asarray(v) for n, v in info.items()} for k, info in tel.items()}


def run_jobs(jobs):
    """Run each ``(name, function name, kwargs)`` in turn on this rank;
    ``{name: result}``."""

    out = {name: globals()[fn](**kwargs) for name, fn, kwargs in jobs}
    out["axes"] = mesh.current().axes
    return out


def mesh_helpers(spec, bad_spec, table, ids, ct):
    """The group's helpers on this rank: ``sync_frozen_spec`` of a spec
    that rank 1 perturbs (and of one whose slot count is wrong on rank 0),
    ``agree``, ``gather_rows``, ``broadcast_object`` and the sharded
    table's lookup (forward and backward) against the whole table's."""

    r = mesh.rank()
    mine = spec
    if r == 1:
        (p0, f0, v0), *rest = spec[0]
        mine = (((p0 + 1, f0, v0), *rest),) + tuple(spec[1:])
    synced = mesh.sync_frozen_spec(mine, len(spec), len(spec[0]))
    none = mesh.sync_frozen_spec(bad_spec if r == 0 else spec, len(spec), len(spec[0]))
    whole = torch.from_numpy(table.copy()).requires_grad_(True)
    shard = torch.from_numpy(mesh.local_rows(table).copy()).requires_grad_(True)
    rows = mesh.rank_rows(ids.shape[0])
    my_ids = torch.from_numpy(ids[rows].copy())
    out = mesh.ShardedLookup.apply(shard, my_ids)
    ref = whole[my_ids.long()]
    my_ct = torch.from_numpy(ct[rows].copy())
    (out * my_ct).sum().backward()
    (ref * my_ct).sum().backward()
    ref_grad = mesh.all_sum_(whole.grad.clone())  # the replicated table's summed gradient
    return {"synced": synced, "none": none, "agree": mesh.agree([float(r) + 0.5, 2.0]),
            "gather": mesh.gather_rows(torch.full((2, 3), float(r))).numpy(),
            "object": mesh.broadcast_object({"rank": r}),
            "lookup": out.detach().numpy(), "lookup_ref": ref.detach().numpy(),
            "grad": shard.grad.numpy(), "grad_ref": mesh.local_rows(ref_grad).numpy()}


def fail_on_rank(r):
    """Raise on rank ``r``; the others return."""

    if mesh.rank() == r:
        raise RuntimeError(f"rank {r} fails")
    return mesh.rank()


def train_and_predict(runs, init_tree, predict_cfg):
    """On this rank: ``train_once`` of each config in ``runs`` (a name ->
    config mapping) from the JAX run's initial parameters ``init_tree``,
    recording every resident epoch (its frozen spec and losses) and every
    evaluation; then ``predict_once`` of ``predict_cfg``."""

    from flow_timesnet_tpu_torch import convert
    from flow_timesnet_tpu_torch.predict import predict_once
    from flow_timesnet_tpu_torch.train import train_once

    convert.init_params = lambda tn_cfg, generator: convert.params_from_jax(init_tree, tn_cfg)
    epoch, evaluate = engine_mod.Engine.train_epoch_resident, engine_mod.Engine.evaluate_resident
    out = {}
    for name, cfg in runs.items():
        log = out[name] = {"epochs": [], "metrics": []}

        def train_epoch_resident(self, *args, _log=log, **kwargs):
            res = epoch(self, *args, **kwargs)
            _log["epochs"].append((self.cfg.frozen_periods, res[1].numpy().astype(np.float64)))
            return res

        def evaluate_resident(self, *args, _log=log, **kwargs):
            res = evaluate(self, *args, **kwargs)
            _log["metrics"].append({k: res[k] for k in ("nll", "smape")})
            return res

        engine_mod.Engine.train_epoch_resident = train_epoch_resident
        engine_mod.Engine.evaluate_resident = evaluate_resident
        try:
            best, paths = train_once(cfg)
        finally:
            engine_mod.Engine.train_epoch_resident = epoch
            engine_mod.Engine.evaluate_resident = evaluate
        log["result"] = (best, {k: v for k, v in paths.items() if k != "metrics"},
                         {k: paths["metrics"][k] for k in ("smape", "best_epoch")})
    out["submission"] = predict_once(predict_cfg)
    return out


def train_state_round_trip(params, batch, path):
    """Two steps with the table row-sharded, the train state saved (rank 0
    writes the assembled tensors), then loaded into a fresh state: each
    rank's tensors back, bit for bit, and what the file holds."""

    from flow_timesnet_tpu_torch.utils import artifacts

    eng = _engine(params, shard=True, engine_kw={"ema_decay": 0.9})
    state = eng.init_state()
    local = _tensors(mesh.shard_rows(batch))
    for _ in range(2):
        state, _, _ = eng.train_step(state, LR, None, local)
    artifacts.save_train_state(path, state, {"epoch": 2}, eng.sharded)
    mesh.barrier()
    fresh = _engine(params, shard=True, engine_kw={"ema_decay": 0.9}).init_state()
    fresh, extra = artifacts.load_train_state(path, fresh, eng.sharded)
    same = all(torch.equal(a, b) for a, b in zip(state.tensors(), fresh.tensors()))
    return {"same": same, "extra": extra,
            "stored": artifacts._read(path)["params"][mesh.TABLE_NAME].shape,
            "rows": int(fresh.params[mesh.TABLE_NAME].shape[0])}
