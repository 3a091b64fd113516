"""What the benchmark's CPU tests share: small configurations, runs on the
CPU with the chip's look skipped, and the port's modules."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import run as prun  # noqa: E402
from portbench.harness import manifest  # noqa: E402

# small widths over the configurations' own data; the second one reaches
# the grouper's log bins and its cap on unique periods
SMALL = {
    "demand_benchmark": {"d_model": 16, "d_ff": 32, "kernel_set": [[3, 3], [5, 5]],
                         "static_proj_dim": 8, "id_embed_dim": 8, "context_rank": 4},
    "long_context": {"input_len": 64, "pred_len": 8, "d_model": 16, "d_ff": 24,
                     "kernel_set": [[3, 3]], "k_periods": 4, "static_proj_dim": 8,
                     "id_embed_dim": 8, "context_rank": 4, "period_binning": 2.0,
                     "period_max_unique": "0:2,1:3"},
}


def found(workload: str, small: bool = False, batch: int = 8) -> dict:
    """The cell as a run finds it, for the CPU: batch ``batch``, two-step
    chunks, two checked requests, optionally at small widths."""

    out = copy.deepcopy(manifest.cell(manifest.load(), workload))
    if small:
        out["config"]["model"].update(SMALL[out["config_name"]])
        del out["config"]["parameters"]  # the count of the full widths
    out["config"]["train"]["batch_size"] = batch
    if out["traffic"]["kind"] == "train":
        out["traffic"].update(chunk_steps=2)
    else:
        out["traffic"].update(checked_requests=2, cuts=64)
    return out


def cpu_run(cell: dict, seed: int = 2147483659, seconds: float = 0.5) -> "prun.Run":
    """A run of ``cell`` on the CPU: set-up, window and check, no trace."""

    run = prun.Run(torch, cell, seed, seconds, False, device="cpu")
    prun.execute(run)
    return run
