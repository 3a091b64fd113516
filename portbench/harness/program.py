"""The one place the benchmark touches the program under test,
``flow_timesnet_tpu_torch``: its model configuration, its entry points,
its staging and its kernels' own run counts. Nothing here imports the JAX
package.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from flow_timesnet_tpu_torch import convert
from flow_timesnet_tpu_torch.build import timesnet_config_from_dict
from flow_timesnet_tpu_torch.data.device_windows import stage_windows
from flow_timesnet_tpu_torch.engine import Engine
from flow_timesnet_tpu_torch.forecaster import Forecaster
from portbench.harness import flops
from portbench.harness import weights as hweights

__all__ = ["Engine", "Forecaster"]


def model_config(config: dict, ds):
    """The program's ``TimesNetConfig`` of a configuration file and its data,
    checked against the parameter count the file states, where it states one."""

    tn = timesnet_config_from_dict(
        {"model": config["model"], "train": config["train"]},
        static_dim=ds.static.shape[1],
        time_feature_dim=2 * len(ds.features), id_vocab=len(ds.ids),
        min_sigma=float(config["train"]["min_sigma"]))
    count = sum(math.prod(s) for s in convert.expected_shapes(tn).values())
    if "parameters" in config and count != int(config["parameters"]):
        raise ValueError(f"the model has {count} parameters, the configuration states "
                         f"{config['parameters']}")
    return tn


def weights(tn, model: dict, seed: int, device) -> Dict[str, object]:
    """Seeded weights in the program's layout (see ``weights.py``)."""

    return hweights.make(convert.expected_shapes(tn), model, seed, device)


def stage(X, M, marks, ds, L: int, H: int, device):
    """The training fold staged on the device, as the program's resident
    trainer stages it."""

    return stage_windows([X], [M], L, H, 1, "direct", marks=[marks], static=ds.static,
                         sigma_vector=ds.floors, device=device)


def mid(tn) -> int:
    """The fold conv's channels: the inception branches' bottleneck width."""

    return max(1, math.ceil(min(tn.d_model, tn.hidden_ff) / tn.bottleneck_ratio))


def step_flops(config: dict, ds, batch: int) -> int:
    return flops.step_flops(config["model"], _dims(ds), batch)


def forward_flops(config: dict, ds, batch: int) -> int:
    return batch * flops.forward_flops(config["model"], _dims(ds))


def _dims(ds) -> dict:
    return {"static_dim": ds.static.shape[1],
            "time_features": 2 * len(ds.features)}


def clear_runs() -> None:
    from flow_timesnet_tpu_torch.ops import cuda_fold

    cuda_fold.clear_kernel_runs()


def runs_total() -> int:
    """Fold-conv kernel runs on the card since :func:`clear_runs`, as the
    kernels counted them."""

    from flow_timesnet_tpu_torch.ops import cuda_fold

    return int(sum(sum(v.values()) for v in cuda_fold.kernel_runs().values()))


def request_batch(fc, history: np.ndarray, dates) -> tuple:
    """The device inputs ``Forecaster.forecast`` hands ``Engine.forward``
    for one request: recorded from the call itself."""

    seen = []
    forward = fc.engine.forward

    def spy(*args):
        seen.append(args)
        return forward(*args)

    fc.engine.forward = spy
    try:
        fc.forecast(history, dates=dates)
    finally:
        fc.engine.forward = forward
    return seen[0]
