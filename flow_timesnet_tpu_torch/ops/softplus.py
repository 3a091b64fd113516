"""Numerically-matched activations (counterpart of ``flow_timesnet_tpu/ops/softplus.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus20(x: torch.Tensor) -> torch.Tensor:
    """Softplus with a linear passthrough above 20, as ``torch.nn.Softplus``."""

    return F.softplus(x, beta=1.0, threshold=20.0)
