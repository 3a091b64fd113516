"""Forward, rollout, training and evaluation steps (counterpart of
``flow_timesnet_tpu/engine.py``).

``train_step`` takes one optimizer step (or one accumulation micro-step)
with gradients through the fold conv's hand kernels; ``evaluate`` streams
the masked NLL and sMAPE sums over a pass and reads them once at its end.
Neither reads a value back to the host inside a step: losses and stats come
back as device tensors. Telemetry, the resident ``lax.scan`` epoch and the
frozen-period helpers are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from .device import resolve_device
from .losses import negative_binomial_mask, negative_binomial_nll
from .models.timesnet import TimesNet, TimesNetConfig
from .optim import Optimizer, build_optimizer
from .utils.metrics import smape_batch_sums, wsmape_batch_sums

_ARGS = ("x", "x_mark", "static", "ids", "floor")


@dataclass
class TrainState:
    """What a training run carries from step to step.

    ``params`` are the engine model's own parameters, updated in place by
    the optimizer (which holds the Adam moments); ``grad_accum`` holds the
    running mean gradient when accumulating, else None; ``ema`` the
    Polyak-averaged parameters when ``ema_decay > 0``, else None.
    """

    params: Dict[str, torch.nn.Parameter]
    optimizer: Optimizer
    grad_accum: Optional[Dict[str, torch.Tensor]] = None
    ema: Optional[Dict[str, torch.Tensor]] = None


def _safe_ratio(num, den) -> float:
    """Metric sum / count, +inf on zero coverage or a non-finite sum: a
    diverged model masks every element out, and 0/0 must not read as a
    perfect score."""

    num, den = float(num), float(den)
    if den <= 0.0 or not np.isfinite(num) or not np.isfinite(den):
        return float("inf")
    return num / den


def _base_mask(y, mask, row_valid, use_loss_masking: bool) -> torch.Tensor:
    base = (mask > 0.0) if use_loss_masking else torch.ones_like(y, dtype=torch.bool)
    if row_valid is not None:
        base = base & (row_valid[:, None, None] > 0.0)
    return base


class Engine:
    """A TimesNet bound to one parameter set on one device, with its steps."""

    def __init__(
        self,
        cfg: TimesNetConfig,
        params: Mapping[str, torch.Tensor],
        device="cuda",
        *,
        use_loss_masking: bool = False,
        accumulation_steps: int = 1,
        grad_clip_norm: float = 0.0,
        weight_decay: float = 0.0,
        num_series: int = 1,
        ema_decay: float = 0.0,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = TimesNet(cfg)
        self.model.load_state_dict(dict(params))
        self.model.to(self.device).eval()
        self.use_loss_masking = bool(use_loss_masking)
        self.accum_steps = max(1, int(accumulation_steps))
        self.ema_decay = float(ema_decay)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError("ema_decay must be in [0, 1)")
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.weight_decay = float(weight_decay or 0.0)
        self.num_series = int(num_series)

    # -- forward / decode ------------------------------------------------------

    def _apply(self, params, *args, **kwargs):
        """The model on ``params`` (a name -> tensor mapping), or on its own
        parameters when ``params`` is None."""

        if params is None:
            return self.model(*args, **kwargs)
        return functional_call(self.model, dict(params), args, kwargs)

    @torch.inference_mode()
    def forward(self, x, x_mark=None, static=None, ids=None, floor=None, row_valid=None):
        """Direct forward: ``(rate, dispersion)`` each [B, out_steps, N]."""

        self.model.eval()
        return self.model(x, x_mark, static, ids, floor, row_valid)

    @torch.inference_mode()
    def rollout(self, x, horizon, x_mark=None, y_mark=None, static=None, ids=None, floor=None,
                row_valid=None):
        """Recursive ``horizon``-step decode: each step's last rate is
        appended to the window (and the next future mark to the marks)."""

        self.model.eval()
        return self._rollout(None, x, horizon, x_mark, y_mark, static, ids, floor, row_valid)

    def _rollout(self, params, x, horizon, x_mark, y_mark, static, ids, floor, row_valid):
        if x_mark is not None and y_mark is None:
            raise ValueError(
                "Temporal features provided for history but missing future marks "
                "during recursive forecast"
            )
        window, marks = x, x_mark
        rates, disps = [], []
        for step in range(int(horizon)):
            rate, disp = self._apply(params, window, marks, static, ids, floor, row_valid)
            rates.append(rate[:, -1, :])
            disps.append(disp[:, -1, :])
            window = torch.cat([window[:, 1:, :], rate[:, -1:, :]], dim=1)
            if marks is not None:
                marks = torch.cat([marks[:, 1:, :], y_mark[:, step : step + 1, :]], dim=1)
        return torch.stack(rates, dim=1), torch.stack(disps, dim=1)

    # -- training ---------------------------------------------------------------

    def init_state(self, params: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
        """Load ``params`` (if given) into the model and start a run on them:
        fresh Adam moments, a zero accumulator when accumulating and an EMA
        that starts at the parameters when ``ema_decay > 0``."""

        if params is not None:
            self.model.load_state_dict(dict(params))
        named = dict(self.model.named_parameters())
        accum = None
        if self.accum_steps > 1:
            accum = {k: torch.zeros_like(p) for k, p in named.items()}
        ema = None
        if self.ema_decay > 0.0:
            ema = {k: p.detach().clone() for k, p in named.items()}
        optimizer = build_optimizer(named.values(), self.grad_clip_norm, self.weight_decay)
        return TrainState(params=named, optimizer=optimizer, grad_accum=accum, ema=ema)

    def _loss(self, batch: Mapping[str, Any], generator: Optional[torch.Generator]):
        """Masked NB-NLL of the model on ``batch`` and the mask stats, as
        device tensors; dropout draws from ``generator`` in training mode."""

        rv = batch.get("row_valid")
        rate, dispersion = self.model(
            *(batch.get(k) for k in _ARGS), row_valid=rv, generator=generator
        )
        y = batch["y"]
        base = _base_mask(y, batch["mask"], rv, self.use_loss_masking)
        nbm = negative_binomial_mask(y, rate, dispersion, base)
        loss = negative_binomial_nll(y, rate, dispersion, nbm)
        if rv is not None:
            # coverage over real rows only (padding adds row_valid=0 rows)
            total = rv.float().sum() * float(y.shape[1] * y.shape[2])
        else:
            total = torch.full((), float(y.numel()), device=y.device)
        return loss, {"mask_true": nbm.sum().float(), "mask_total": total}

    def train_step(self, state: TrainState, lr: float, generator: Optional[torch.Generator],
                   batch: Mapping[str, Any], do_update: bool = True):
        """One gradient step on ``batch``: ``(state, loss, stats)``.

        With ``accumulation_steps > 1`` the gradient is added to the running
        mean and the update waits for ``do_update``. ``lr`` is this step's
        learning rate; ``generator`` (on the engine's device) drives dropout.
        The state is updated in place and returned.
        """

        self.model.train()
        params = list(state.params.values())
        for p in params:
            p.grad = None
        loss, stats = self._loss(batch, generator)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.accum_steps > 1:
            accum = list(state.grad_accum.values())
            torch._foreach_add_(accum, grads, alpha=1.0 / self.accum_steps)
            if not do_update:
                return state, loss.detach(), stats
            grads = [a.clone() for a in accum]
            torch._foreach_zero_(accum)
        with torch.no_grad():
            state.optimizer.step(grads, lr)
            if state.ema is not None:
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, self.ema_decay)
                torch._foreach_add_(ema, params, alpha=1.0 - self.ema_decay)
        return state, loss.detach(), stats

    # -- evaluation ---------------------------------------------------------------

    def eval_step(self, params, batch: Mapping[str, Any]):
        """Streaming sums of one batch: ``(nll * count, count, smape_sum,
        smape_count, series_sums[N], series_counts[N])`` as device tensors."""

        y = batch["y"]
        args = [batch.get(k) for k in _ARGS]
        rv = batch.get("row_valid")
        if self.cfg.mode == "direct":
            rate, dispersion = self._apply(params, *args, rv)
        else:
            x, x_mark, static, ids, floor = args
            rate, dispersion = self._rollout(params, x, int(y.shape[1]), x_mark,
                                             batch.get("y_mark"), static, ids, floor, rv)
        rate = rate[:, : y.shape[1], :]
        dispersion = dispersion[:, : y.shape[1], :]
        base = _base_mask(y, batch["mask"], rv, self.use_loss_masking)
        nbm = negative_binomial_mask(y, rate, dispersion, base)
        nb_loss = negative_binomial_nll(y, rate, dispersion, nbm)
        # an all-masked batch contributes (0, 0)
        denom = nbm.float().sum()
        maskf = nbm.to(y.dtype)
        y_eval, rate_eval = y * maskf, rate * maskf
        smape_s, smape_c = smape_batch_sums(y_eval, rate_eval)
        if batch.get("ids") is not None:
            sid = batch["ids"]
        else:
            sid = torch.arange(y.shape[2], device=y.device)[None].expand(y.shape[0], y.shape[2])
        ws_sums, ws_cnts = wsmape_batch_sums(y_eval, rate_eval, sid, self.num_series)
        return nb_loss * denom, denom, smape_s, smape_c, ws_sums, ws_cnts

    @torch.inference_mode()
    def evaluate(self, params, batches: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
        """Stream eval metrics of ``params`` (a name -> tensor mapping such as
        ``state.ema``, or None for the model's own) over device-ready
        batches: the sums stay on the device and are read once at the end."""

        self.model.eval()
        totals = None
        for batch in batches:
            out = self.eval_step(params, batch)
            totals = out if totals is None else tuple(a + b for a, b in zip(totals, out))
        if totals is None:
            # an empty eval stream must not masquerade as a perfect score
            return {
                "nll": float("inf"),
                "smape": float("inf"),
                "series_sums": np.zeros(self.num_series, np.float32),
                "series_cnts": np.zeros(self.num_series, np.float32),
            }
        # one copy to the host for the whole pass
        flat = torch.cat([t.reshape(-1).float() for t in totals]).cpu().numpy()
        nll_num, nll_den, s_sum, s_cnt = flat[:4]
        return {
            "nll": _safe_ratio(nll_num, nll_den),
            "smape": _safe_ratio(s_sum, s_cnt),
            "series_sums": flat[4 : 4 + self.num_series],
            "series_cnts": flat[4 + self.num_series :],
        }


def batch_to_device(batch, floor=None, device="cuda") -> Dict[str, Any]:
    """WindowBatch -> dict of tensors on ``device`` (None-preserving); float
    fields in float32, series ids in int32."""

    def put(a, dtype):
        return None if a is None else torch.from_numpy(np.asarray(a, dtype)).to(device)

    return {
        "x": put(batch.x, np.float32),
        "y": put(batch.y, np.float32),
        "mask": put(batch.mask, np.float32),
        "row_valid": put(batch.row_valid, np.float32),
        "x_mark": put(batch.x_mark, np.float32),
        "y_mark": put(batch.y_mark, np.float32),
        "static": put(batch.static, np.float32),
        "ids": put(batch.series_ids, np.int32),
        "floor": put(floor, np.float32),
    }
