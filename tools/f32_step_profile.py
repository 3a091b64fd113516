#!/usr/bin/env python3
"""Device time of the flagship's float32 training step on one NVIDIA GPU,
for one checkout of the PyTorch/CUDA port.

    python3 tools/f32_step_profile.py [ROOT]

ROOT (default: this checkout) is the checkout whose ``flow_timesnet_tpu_torch``
runs, and whose kernels it builds. The model, weights, batch and phase are
``chip_smoke.py``'s float32 steps (``compute_dtype="float32"``, the JAX
package's default): 5 warm-up and 20 timed steps on one batch of 256
windows, then 20 under torch.profiler, which print the step p50, device time
per step by kernel and the fold conv's. Run it for two checkouts in turns
(A, B, B, A) to compare them on one card.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path[:0] = [str(root), str(HERE)]  # the package under test, then chip_smoke.py

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this measurement needs an NVIDIA GPU")
    import flow_timesnet_tpu_torch as pkg
    from flow_timesnet_tpu_torch import convert, optim
    from flow_timesnet_tpu_torch import engine as engine_mod
    from flow_timesnet_tpu_torch.data import windows
    from flow_timesnet_tpu_torch.device import resolve_device
    from flow_timesnet_tpu_torch.models import timesnet

    cs.check(Path(pkg.__file__).resolve().is_relative_to(root), f"imported {pkg.__file__}")
    dev = resolve_device("cuda")
    print(f"[env] {cs.card_line()}; package {Path(pkg.__file__).parent}")
    cfg = cs.flagship_config(timesnet)
    params = cs.flagship_params(torch, convert, cfg)
    train, _, sigma = cs.train_data(np, windows, cfg.input_len, cfg.pred_len)
    batch = next(iter(train))
    floor = sigma[batch.series_ids.reshape(-1)].reshape(-1, 1, 1)
    warmup = optim.resolve_warmup(cs.TRAIN["warmup_steps"], None, len(train))
    lr = optim.LRController(cs.TRAIN["lr"], cs.TRAIN["epochs"],
                            {"type": "cosine", "eta_min": cs.TRAIN["eta_min"]},
                            warmup).lr_for_epoch(1)
    cs.float32_steps(torch, np, engine_mod, cfg, params,
                     engine_mod.batch_to_device(batch, floor=floor, device=dev), lr, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
