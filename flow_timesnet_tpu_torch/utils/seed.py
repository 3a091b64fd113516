"""Deterministic seeding (counterpart of ``flow_timesnet_tpu/utils/seed.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators and return the
    seed, which the port's own generators (dropout, shuffling) take in
    place of the JAX package's root key. (The JAX package's
    ``deterministic`` flag forces full-precision float32 matmuls; the
    port's are full precision already, ``device.resolve_device`` turns TF32
    off, so the port takes no such flag.)
    """

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return int(seed)
