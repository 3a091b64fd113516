"""Seeded weights in the program's ``state_dict`` layout, made on the device
in one draw.

One ``torch.rand`` call on a ``torch.Generator`` of the device gives every
leaf its values, uniform in [-1, 1), then each leaf is scaled: kernels and
biases by ``1 / sqrt(fan_in)`` (fan_in the kernel's leading dims), the
series table to unit variance, the heads that start at zero in training
(``mu_head``, ``sigma_head``, ``context_coeff``, ``late_bias_head``) to a
standard deviation of 0.05 so that every layer reaches the output, norm
scales at 1 +- 0.1 and their biases at 0 +- 0.1, the gates at 0.1 and 0.05
and the temporal context at the configuration's ``context_scale``, each
+- 10 %. float32, the type the program keeps its parameters in.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_HEADS = ("mu_head", "sigma_head", "context_coeff", "late_bias_head")


def make(shapes: Dict[str, tuple], model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (name, shape), u in zip(shapes.items(), torch.split(flat, sizes)):
        u = u.reshape(shape)
        module, _, leaf = name.rpartition(".")
        owner = module.rpartition(".")[2]
        if owner in _HEADS and leaf == "kernel":
            value = u * (0.05 * math.sqrt(3.0))
        elif name == "series_embedding.embedding":
            value = u * math.sqrt(3.0)
        elif owner.endswith("norm"):
            value = (1.0 if leaf == "scale" else 0.0) + 0.1 * u
        elif name == "embedding.gate":
            value = 0.1 * (1.0 + 0.1 * u)
        elif name == "late_bias_gate":
            value = 0.05 * (1.0 + 0.1 * u)
        elif name == "temporal_context.scale":
            value = float(model["context_scale"]) * (1.0 + 0.1 * u)
        elif leaf.endswith("kernel"):
            value = u / math.sqrt(max(1, math.prod(shape[:-1])))
        elif leaf.endswith("bias"):
            kernel = shapes.get(name[: -len("bias")] + "kernel", shape)
            value = u / math.sqrt(max(1, math.prod(kernel[:-1])))
        else:
            raise KeyError(f"no initialiser for {name}")
        out[name] = value.contiguous()
    return out
