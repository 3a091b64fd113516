"""Optimizer and epoch-level learning-rate control (counterpart of
``flow_timesnet_tpu/optim.py``).

The JAX package's optax chain is ``clip_by_global_norm -> scale_by_adam ->
add_decayed_weights -> scale(-1)``, times the learning rate at the call
site. ``torch.optim.AdamW`` computes the same update (decoupled weight decay
of ``lr * wd * p``, Adam's bias-corrected moments with eps outside the
square root); the clip runs on the gradients first, as optax's does. The
learning rate is set on the optimizer before each step, so it changes from
epoch to epoch without rebuilding anything. The warmup and schedule logic
is a copy of the JAX package's pure-Python ``WarmupSpec``,
``resolve_warmup`` and ``LRController``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional

import torch


@dataclass
class Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) behind an optional global-norm clip."""

    adamw: torch.optim.AdamW
    grad_clip_norm: float

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.adamw.param_groups for p in group["params"]]

    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        """One update from ``grads`` (one per parameter, in order) at ``lr``.

        The gradients are clipped in place; no value is read back to the host.
        """

        if self.grad_clip_norm > 0:
            clip_by_global_norm_(grads, self.grad_clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = float(lr)
        self.adamw.step()


def build_optimizer(
    params: Iterable[torch.Tensor], grad_clip_norm: float, weight_decay: float
) -> Optimizer:
    """The JAX package's ``build_optimizer`` over ``params``."""

    adamw = torch.optim.AdamW(
        list(params), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=float(weight_decay or 0.0),
    )
    return Optimizer(adamw, float(grad_clip_norm or 0.0))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: below ``max_norm`` the
    gradients stay as they are, otherwise each becomes ``g / norm * max_norm``
    (no epsilon is added to the norm, unlike ``clip_grad_norm_``). Returns
    the global norm as a device tensor."""

    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


@dataclass
class WarmupSpec:
    epochs: int
    steps: int
    start_factor: float


def resolve_warmup(
    warmup_steps_cfg: Optional[int],
    warmup_epochs_cfg: Optional[int],
    updates_per_epoch: int,
) -> WarmupSpec:
    if warmup_steps_cfg is not None and warmup_epochs_cfg is not None:
        raise ValueError("Specify only one of train.lr_warmup_steps or train.lr_warmup_epochs")
    warmup_steps = 0
    warmup_epochs = 0
    if warmup_steps_cfg is not None:
        warmup_steps = max(int(warmup_steps_cfg), 0)
        if warmup_steps > 0:
            warmup_epochs = (
                max(1, math.ceil(warmup_steps / updates_per_epoch))
                if updates_per_epoch > 0
                else warmup_steps
            )
    elif warmup_epochs_cfg is not None:
        warmup_epochs = max(int(warmup_epochs_cfg), 0)
        warmup_steps = warmup_epochs * updates_per_epoch
    length = warmup_steps if warmup_steps > 0 else warmup_epochs
    if length <= 0:
        start = 1.0
    elif length <= 1:
        start = 0.5
    else:
        start = max(1e-4, min(1.0, 1.0 / length))
    return WarmupSpec(epochs=warmup_epochs, steps=warmup_steps, start_factor=start)


class LRController:
    """Host-side per-epoch learning rate, including plateau feedback.

    ``lr_for_epoch(ep)`` returns the LR used *during* 1-indexed epoch ``ep``
    (the scheduler steps at the end of each epoch, so epoch 1 always trains
    at the initial LR).
    """

    def __init__(
        self,
        base_lr: float,
        epochs: int,
        sched_cfg: Mapping[str, Any] | None,
        warmup: WarmupSpec,
    ) -> None:
        cfg = dict(sched_cfg or {})
        self.base_lr = float(base_lr)
        self.epochs = int(epochs)
        self.warmup = warmup
        self.type = cfg.get("type") or "cosine"
        self.cfg = cfg
        self._plateau_lr = self.base_lr
        self._plateau_best: Optional[float] = None
        self._plateau_bad = 0

        if self.type == "ReduceLROnPlateau" and warmup.epochs > 0:
            # warmup is unsupported with plateau scheduling
            self.warmup = WarmupSpec(epochs=0, steps=0, start_factor=1.0)

        if self.type == "cosine":
            t_max_raw = cfg.get("T_max", epochs)
            try:
                t_max = int(t_max_raw)
            except (TypeError, ValueError):
                t_max = epochs
            self.cosine_t_max = (
                max(1, t_max - self.warmup.epochs) if self.warmup.epochs > 0 else t_max
            )
            self.eta_min = float(cfg.get("eta_min", 1e-5))

    def observe(self, metric: float) -> None:
        """Feed the per-epoch validation metric (used by ReduceLROnPlateau)."""

        if self.type != "ReduceLROnPlateau":
            return
        threshold = float(self.cfg.get("threshold", 1e-4))
        patience = int(self.cfg.get("patience", 10))
        factor = float(self.cfg.get("factor", 0.1))
        min_lr = float(self.cfg.get("min_lr", 0.0))
        if self._plateau_best is None or metric < self._plateau_best * (1.0 - threshold):
            self._plateau_best = metric
            self._plateau_bad = 0
        else:
            self._plateau_bad += 1
            if self._plateau_bad > patience:
                self._plateau_lr = max(self._plateau_lr * factor, min_lr)
                self._plateau_bad = 0

    def _warmup_factor(self, steps_taken: int) -> float:
        w = self.warmup
        if w.epochs <= 0:
            return 1.0
        s = min(steps_taken, w.epochs)
        return w.start_factor + (1.0 - w.start_factor) * s / w.epochs

    def lr_for_epoch(self, epoch: int) -> float:
        """LR used during 1-indexed ``epoch`` (scheduler stepped per epoch end)."""

        steps_taken = epoch - 1
        if self.type == "ReduceLROnPlateau":
            return self._plateau_lr
        w = self.warmup
        if w.epochs > 0 and steps_taken < w.epochs:
            return self.base_lr * self._warmup_factor(steps_taken)
        if self.type == "cosine":
            t = steps_taken - w.epochs if w.epochs > 0 else steps_taken
            T = max(1, self.cosine_t_max)
            return self.eta_min + (self.base_lr - self.eta_min) * (
                1.0 + math.cos(math.pi * t / T)
            ) / 2.0
        if self.type == "StepLR":
            step_size = int(self.cfg.get("step_size", 10))
            gamma = float(self.cfg.get("gamma", 0.1))
            return self.base_lr * (gamma ** (steps_taken // max(1, step_size)))
        if w.epochs > 0:
            # warmup-only scheduler: hold at base lr after warmup completes
            return self.base_lr * self._warmup_factor(steps_taken)
        return self.base_lr

    def state_dict(self) -> Dict[str, Any]:
        return {
            "plateau_lr": self._plateau_lr,
            "plateau_best": self._plateau_best,
            "plateau_bad": self._plateau_bad,
        }

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self._plateau_lr = float(state.get("plateau_lr", self._plateau_lr))
        best = state.get("plateau_best")
        self._plateau_best = None if best is None else float(best)
        self._plateau_bad = int(state.get("plateau_bad", 0))

    def effective_summary(self) -> Dict[str, Any]:
        return {
            "lr_warmup_steps_effective": self.warmup.steps,
            "lr_warmup_epochs_effective": self.warmup.epochs,
            "lr_warmup_start_factor_effective": self.warmup.start_factor,
        }
