"""Offline evaluation: score stored artifacts on a holdout of a CSV
(counterpart of ``flow_timesnet_tpu/evaluate.py``).

``evaluate_once(cfg)`` loads the trained artifact set
(:meth:`Forecaster.from_artifacts`), windows the last
``train.val.holdout_days`` rows of the evaluation CSV (``data.eval_csv``,
else ``data.train_csv``) with the stored scaler, and streams the masked
NB-NLL, sMAPE and grouped wSMAPE on the device: staged and gathered there
(``Engine.evaluate_resident``, one CUDA-graph replay a batch on the card)
when the staged arrays fit ``train.device_stage_mb``, else batch by batch
from the host (``Engine.evaluate``). With ``evaluation.quantiles`` (or
``predict.quantiles``) it also reports each level's empirical coverage and
mean pinball loss, and ``evaluation.out_path`` saves the result as JSON.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from .config import PipelineConfig, load_yaml
from .data.device_windows import epoch_index_plan
from .data.pivot import read_long_pivot, transform_dataframe
from .data.windows import build_batcher
from .device import resolve_device
from .engine import batch_to_device
from .forecaster import Forecaster
from .train import _stage_from_batcher, _staged_nbytes
from .utils.metadata import save_json
from .utils.metrics import wsmape_from_series_sums
from .utils.quantiles import parse_quantile_config, predictive_quantiles


def _log(msg: str) -> None:
    print(msg, flush=True)


def evaluate_once(cfg: PipelineConfig | Dict[str, Any]) -> Dict[str, Any]:
    """Score the artifacts in ``artifacts.dir`` on the evaluation CSV's
    holdout: ``{"nll", "smape", "wsmape", "windows", "holdout_days"}`` and,
    with quantile levels configured, ``"quantiles"`` and
    ``"quantile_method"``."""

    if isinstance(cfg, dict):
        cfg = PipelineConfig.from_mapping(cfg)
    cfg_used = cfg.to_dict()
    train_cfg = cfg_used.get("train", {})
    device = resolve_device("cpu" if str(train_cfg.get("device", "")).lower() == "cpu" else "cuda")
    art_dir = cfg_used.get("artifacts", {}).get("dir", "outputs/artifacts")
    config_path = os.path.join(
        art_dir, cfg_used.get("artifacts", {}).get("config_file", "config_used.yaml"))
    fc = Forecaster.from_artifacts(art_dir, config_path=config_path, device=device)
    trained_cfg = PipelineConfig.from_mapping(load_yaml(config_path))

    data_cfg = cfg_used.get("data", {})
    eval_csv = data_cfg.get("eval_csv") or data_cfg.get("train_csv")
    if not eval_csv:
        raise ValueError("data.eval_csv (or data.train_csv) must point to the evaluation CSV")
    wide_raw = read_long_pivot(
        eval_csv,
        date_col=data_cfg.get("date_col", trained_cfg.data.date_col),
        id_col=data_cfg.get("id_col", trained_cfg.data.id_col),
        target_col=data_cfg.get("target_col", trained_cfg.data.target_col),
        fill_missing_dates=bool(data_cfg.get("fill_missing_dates", True)),
        fillna0=False,
        encoding=data_cfg.get("encoding", "utf-8"),
    )
    mask_wide = wide_raw.with_values((~wide_raw.isna()).astype(np.float32))
    wide = wide_raw.fillna(0.0)
    if cfg_used.get("preprocess", {}).get("clip_negative", False):
        wide = wide.clip_lower(0.0)
    # aligned to the trained series set (zeros for a series the CSV lacks)
    wide = wide.reindex_columns(fc.ids)
    mask_wide = mask_wide.reindex_columns(fc.ids)

    holdout = int(
        train_cfg.get("val", {}).get("holdout_days")
        or trained_cfg.train.val_holdout_days
        or (fc.input_len + fc.pred_len)
    )
    tail = wide.rows(-holdout, None)
    tail_mask = mask_wide.rows(-holdout, None)
    tail_norm = transform_dataframe(tail, fc.ids, fc.scaler, fc.method)

    engine = fc.engine
    engine.use_loss_masking = bool(train_cfg.get("use_loss_masking", True))
    mode = engine.cfg.mode
    batch_size = int(train_cfg.get("batch_size", 256))
    tf_cfg = dict(fc.time_feature_config or {})
    batcher = build_batcher(
        [tail_norm.to_numpy(np.float32)],
        [tail_mask.to_numpy(np.float32)],
        fc.input_len,
        fc.pred_len,
        int(cfg_used.get("window", {}).get("stride", 1)),
        mode,
        batch_size,
        shuffle=False,
        drop_last=False,
        recursive_pred_len=(fc.pred_len if mode == "recursive" else None),
        series_static=[fc.static_features],
        series_ids=[np.arange(len(fc.ids), dtype=np.int64)],
        time_indices=[tail_norm.index] if tf_cfg else None,
        time_feature_config=tf_cfg or None,
        pad_final=True,
        time_frequency=tail.freq,
    )
    if batcher.total == 0:
        raise ValueError("Evaluation holdout has no windows; increase train.val.holdout_days")

    def floor_for(batch):
        if fc.sigma_vector is None or batch.series_ids is None:
            return None
        return fc.sigma_vector[batch.series_ids.reshape(-1)].reshape(-1, 1, 1)

    def to_device(batch):
        return batch_to_device(batch, floor=floor_for(batch), device=device)

    # the resident pass, under train_once's staging knobs: train.input_pipeline
    # (host opts out) and the train.device_stage_mb budget
    pipeline_req = str(train_cfg.get("input_pipeline", "auto")).lower()
    stage_budget = float(train_cfg.get("device_stage_mb", 512) or 512) * 1e6
    staged = None
    if pipeline_req != "host" and (
        pipeline_req == "device" or _staged_nbytes(batcher) <= stage_budget
    ):
        staged = _stage_from_batcher(batcher, fc.sigma_vector, device)
    if staged is not None:
        idx, rv = epoch_index_plan(staged.total, batch_size, None, shuffle=False,
                                   drop_last=False)
        metrics = engine.evaluate_resident(None, staged, idx, rv)
    else:
        metrics = engine.evaluate(None, (to_device(b) for b in batcher))
    wsmape = wsmape_from_series_sums(metrics["series_sums"], metrics["series_cnts"], fc.ids)
    result: Dict[str, Any] = {
        "nll": float(metrics["nll"]),
        "smape": float(metrics["smape"]),
        "wsmape": float(wsmape),
        "windows": int(batcher.total),
        "holdout_days": holdout,
    }
    _log(f"Evaluation: nll={result['nll']:.6f} smape={result['smape']:.6f} "
         f"wsmape={result['wsmape']:.6f} ({result['windows']} windows over the last "
         f"{holdout} rows, {'device-resident' if staged is not None else 'host'} pipeline)")

    # Interval calibration: the empirical coverage P(y <= q-hat) and the mean
    # pinball loss of the NB2 head's quantiles over every masked holdout cell.
    # Coverage is invariant under the (monotone) scaler; pinball is in model
    # space.
    eval_cfg = cfg_used.get("evaluation") or {}
    q_cfg = eval_cfg if eval_cfg.get("quantiles") else (cfg_used.get("predict") or {})
    q_levels, q_method = parse_quantile_config(q_cfg, fc.method)
    if q_levels:
        cov_num = {q: 0.0 for q in q_levels}
        pin_num = {q: 0.0 for q in q_levels}
        weight_sum = 0.0
        for b in batcher:
            dev = to_device(b)
            args = (dev["x_mark"], dev["static"], dev["ids"], dev["floor"], dev["row_valid"])
            if mode == "direct":
                rate, disp = engine.forward(dev["x"], *args)
            else:
                # a recursive model emits one step a forward: roll out the
                # whole horizon so that the quantiles align with [B, H]
                x_mark, static, ids, floor, row_valid = args
                rate, disp = engine.rollout(dev["x"], int(b.y.shape[1]), x_mark=x_mark,
                                            y_mark=dev["y_mark"], static=static, ids=ids,
                                            floor=floor, row_valid=row_valid)
            mu = rate[..., 0].float().cpu().numpy()  # [B, H]
            alpha = disp[..., 0].float().cpu().numpy()
            y = b.y[..., 0]
            w = b.mask[..., 0] * b.row_valid[:, None]
            qs = predictive_quantiles(q_levels, mu, alpha, method=q_method)
            weight_sum += float(w.sum())
            for q, qv in qs.items():
                d = y - qv
                cov_num[q] += float((w * (y <= qv)).sum())
                pin_num[q] += float((w * np.maximum(q * d, (q - 1.0) * d)).sum())
        denom = max(weight_sum, 1.0)
        result["quantiles"] = {
            str(q): {
                "coverage": round(cov_num[q] / denom, 4),
                "pinball": round(pin_num[q] / denom, 6),
            }
            for q in q_levels
        }
        result["quantile_method"] = q_method
        _log(f"Interval calibration ({q_method}): " + " ".join(
            f"q{100 * q:g}: cov={result['quantiles'][str(q)]['coverage']:.3f} "
            f"pinball={result['quantiles'][str(q)]['pinball']:.4f}" for q in q_levels))
    out_path = eval_cfg.get("out_path")
    if out_path:
        save_json(result, out_path)
        _log(f"Saved: {out_path}")
    return result
