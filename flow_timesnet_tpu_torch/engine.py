"""Inference engine (counterpart of the forward and rollout of ``flow_timesnet_tpu/engine.py``).

Training, evaluation and telemetry are later slices of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from .device import resolve_device
from .models.timesnet import TimesNet, TimesNetConfig


class Engine:
    """A TimesNet bound to one parameter set on one device, in eval mode."""

    def __init__(
        self, cfg: TimesNetConfig, params: Mapping[str, torch.Tensor], device="cuda"
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = TimesNet(cfg)
        self.model.load_state_dict(dict(params))
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def forward(self, x, x_mark=None, static=None, ids=None, floor=None):
        """Direct forward: ``(rate, dispersion)`` each [B, out_steps, N]."""

        return self.model(x, x_mark, static, ids, floor)

    @torch.inference_mode()
    def rollout(
        self,
        x: torch.Tensor,
        horizon: int,
        x_mark: Optional[torch.Tensor] = None,
        y_mark: Optional[torch.Tensor] = None,
        static=None,
        ids=None,
        floor=None,
    ):
        """Recursive ``horizon``-step decode: each step's last rate is
        appended to the window (and the next future mark to the marks)."""

        if x_mark is not None and y_mark is None:
            raise ValueError(
                "Temporal features provided for history but missing future marks "
                "during recursive forecast"
            )
        window, marks = x, x_mark
        rates, disps = [], []
        for step in range(int(horizon)):
            rate, disp = self.model(window, marks, static, ids, floor)
            rates.append(rate[:, -1, :])
            disps.append(disp[:, -1, :])
            window = torch.cat([window[:, 1:, :], rate[:, -1:, :]], dim=1)
            if marks is not None:
                marks = torch.cat([marks[:, 1:, :], y_mark[:, step : step + 1, :]], dim=1)
        return torch.stack(rates, dim=1), torch.stack(disps, dim=1)
