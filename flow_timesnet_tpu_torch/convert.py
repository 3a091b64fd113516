"""Carry weights between the JAX package and the port.

The port's modules keep the flax names and layouts (Dense kernels
``[in, out]``, fold-conv kernels HWIO ``[kh, kw, Cin, Cout]``), so a flax
parameter tree becomes a ``state_dict`` by joining each leaf's path with
dots: ``{"blocks_0": {"inception_in": {"branch_2": {"conv_kernel": w}}}}``
is ``blocks_0.inception_in.branch_2.conv_kernel``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.embedding import torch_uniform
from .models.timesnet import TimesNet, TimesNetConfig

# Dense heads the JAX package initialises to zero (baseline-preserving).
_ZERO_DENSE = ("context_coeff", "context_proj", "mu_head", "sigma_head", "late_bias_head")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = np.asarray(value, dtype=np.float32)
    return flat


def expected_shapes(cfg: TimesNetConfig) -> Dict[str, tuple]:
    """Parameter names and shapes of the port's model for ``cfg``."""

    with torch.device("meta"):
        model = TimesNet(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def params_from_jax(tree: Mapping[str, Any], cfg: TimesNetConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's param tree (nested dicts of arrays) -> the port's state_dict.

    Raises ``KeyError`` on a missing or unexpected parameter and
    ``ValueError`` on a shape that differs from ``cfg``'s model.
    """

    flat = _flatten(tree)
    want = expected_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    unexpected = sorted(set(flat) - set(want))
    if missing or unexpected:
        raise KeyError(f"param tree does not match the config: missing {missing}, "
                       f"unexpected {unexpected}")
    out: Dict[str, torch.Tensor] = {}
    for name, shape in want.items():
        arr = flat[name]
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, the config needs {shape}")
        out[name] = torch.from_numpy(arr.copy())
    return out


def init_params(cfg: TimesNetConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The JAX package's initialisation, drawn from ``generator``.

    Kernels and biases are U(+-1/sqrt(fan_in)) with fan_in the product of
    the kernel's leading dims; the baseline heads are zero; the time
    projection copies the last input step; norms start at (1, 0); the series
    embedding is N(0, 1); the embedding gate is 0.1, the late-bias gate
    0.05 and the temporal-context scale ``cfg.context_scale``. The draws
    follow the distributions, not the JAX random stream.
    """

    shapes = expected_shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        module, _, leaf = name.rpartition(".")
        owner = module.rpartition(".")[2] if module else ""
        if owner in _ZERO_DENSE or name == "forecast_time_proj.bias":
            value = torch.zeros(shape)
        elif name == "forecast_time_proj.kernel":
            value = torch.zeros(shape)
            value[-1, :] = 1.0
        elif name == "series_embedding.embedding":
            value = torch.randn(shape, generator=generator)
        elif name == "embedding.gate":
            value = torch.full(shape, 0.1)
        elif name == "late_bias_gate":
            value = torch.full(shape, 0.05)
        elif name == "temporal_context.scale":
            value = torch.full(shape, float(cfg.context_scale))
        elif owner.endswith("norm"):
            value = torch.ones(shape) if leaf == "scale" else torch.zeros(shape)
        elif leaf.endswith("kernel"):
            value = torch_uniform(shape, int(np.prod(shape[:-1])), generator)
        elif leaf.endswith("bias"):
            kernel = shapes[name[: -len("bias")] + "kernel"]
            value = torch_uniform(shape, int(np.prod(kernel[:-1])), generator)
        else:
            raise KeyError(f"no initialiser for {name}")
        out[name] = value.float()
    return out
