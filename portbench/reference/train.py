"""The reference's training step: NB-NLL, backward, global-norm clip, AdamW and EMA.

Plain float32 PyTorch: gradients by autograd through
:func:`portbench.reference.timesnet.loss`, the clip as ``optax``'s
``clip_by_global_norm`` (no epsilon; unchanged below the limit), AdamW with
decoupled weight decay (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
bias-corrected moments) and a Polyak average of the parameters after each
update.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from . import timesnet

Params = Dict[str, torch.Tensor]


class Trainer:
    """The reference's run: parameters, moments, EMA and step count."""

    def __init__(self, params: Params, cfg: dict, train: dict, rounding: str) -> None:
        self.cfg = cfg
        self.lr = float(train["lr"])
        self.wd = float(train["weight_decay"])
        self.clip = float(train["grad_clip_norm"])
        self.ema_decay = float(train["ema_decay"])
        self.rnd = timesnet.Rounding(rounding)
        self.p = {k: v.detach().clone().float() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.ema = ({k: v.clone() for k, v in self.p.items()} if self.ema_decay > 0 else None)
        self.t = 0

    def gradients(self, batch: dict, generator: Optional[torch.Generator],
                  ties: Optional[timesnet.Ties] = None):
        """``(loss, gradients)`` of one batch; dropout draws from ``generator``,
        the selector's near-ties go as ``ties`` says."""

        leaves = {k: v.clone().requires_grad_(True) for k, v in self.p.items()}
        masks = (timesnet.Masks(generator, self.cfg["dropout"])
                 if generator is not None and float(self.cfg["dropout"]) > 0 else None)
        loss = timesnet.loss(leaves, self.cfg, batch, self.rnd, masks, ties)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        return loss.detach(), {k: (g if g is not None else torch.zeros_like(self.p[k]))
                               for k, g in zip(names, grads)}

    def step(self, batch: dict, generator: Optional[torch.Generator],
             ties: Optional[timesnet.Ties] = None):
        """One update; returns ``(loss, the clipped gradients the update used)``."""

        loss, grads = self.gradients(batch, generator, ties)
        if self.clip > 0:
            norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
            if norm >= self.clip:
                grads = {k: g / norm * self.clip for k, g in grads.items()}
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            for k, g in grads.items():
                p = self.p[k]
                p.mul_(1.0 - self.lr * self.wd)
                self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = self.v[k].sqrt() / math.sqrt(1.0 - b2 ** self.t) + eps
                p.addcdiv_(self.m[k], denom, value=-self.lr / (1.0 - b1 ** self.t))
            if self.ema is not None:
                for k, e in self.ema.items():
                    e.mul_(self.ema_decay).add_(self.p[k], alpha=1.0 - self.ema_decay)
        return loss, grads


def leaf_norms(tensors: Params) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], skip=()) -> Dict[str, float]:
    """Each leaf's ``|got - want|``, against the larger of the leaf's own
    ``want`` and the median leaf's."""

    names = [k for k in want if k not in skip]
    ordered = sorted(want[k] for k in names)
    median = ordered[(len(ordered) - 1) // 2] if ordered else 0.0
    out = {}
    for k in names:
        scale = max(want[k], median)
        out[k] = abs(got[k] - want[k]) / scale if scale > 0 else abs(got[k] - want[k])
    return out


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], skip=()) -> tuple:
    """The largest of :func:`leaf_gaps`; ``(gap, leaf)``."""

    gaps = leaf_gaps(got, want, skip)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float], skip=()) -> float:
    """The median of :func:`leaf_gaps` (the lower of the two middle ones)."""

    ordered = sorted(leaf_gaps(got, want, skip).values())
    return ordered[(len(ordered) - 1) // 2]


def quiet_leaves(grads: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient norm is under ``share`` of the median
    leaf's: they move under Adam by round-off alone."""

    ordered = sorted(grads.values())
    median = ordered[(len(ordered) - 1) // 2]
    return [k for k, g in grads.items() if g < share * median]
