"""Embedding-layer building blocks (counterpart of ``flow_timesnet_tpu/models/embedding.py``).

Parameters keep the flax names and layouts: a :class:`Dense` holds
``kernel`` [in, out] and ``bias``, a norm holds ``scale`` and ``bias``, so a
JAX parameter tree maps onto a ``state_dict`` by joining its path with dots
(see ``convert.py``, which also holds the JAX package's initialisers).
Normalisations compute in float32 and cast back.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn


def torch_uniform(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """U(+-1/sqrt(fan_in)): torch's default Linear/Conv init, which the JAX
    package reproduces for its kernels (fan_in = prod(shape[:-1])) and biases."""

    bound = 1.0 / math.sqrt(max(1, fan_in))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class DropoutTape:
    """The dropout masks of one rematerialised region, drawn once.

    In the region's forward each mask is drawn from ``generator``, the
    step's, and kept (one byte an element); after :meth:`replay` the
    recompute in the backward takes them back in the order they were drawn.
    So the recompute multiplies by the forward's masks, and the generator
    moves on as it does without remat, with no generator state to save and
    restore (which a CUDA graph capture would not allow on the host).
    """

    def __init__(self, generator: torch.Generator) -> None:
        self.generator = generator
        self.masks: list = []
        self.at: Optional[int] = None  # None while drawing; the next mask while replaying

    def replay(self) -> None:
        self.at = 0

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        """The next keep mask of ``shape``: drawn and kept, or taken back."""

        if self.at is None:
            mask = torch.rand(shape, generator=self.generator, device=device) >= rate
            self.masks.append(mask)
            return mask
        self.at += 1
        return self.masks[self.at - 1]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[Union[torch.Generator, DropoutTape]]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``, in ``x``'s type.

    ``generator`` is None in a deterministic pass (the identity); in a
    training pass it is the step's ``torch.Generator`` on ``x``'s device, or
    a rematerialised region's :class:`DropoutTape` over it.
    ``F.dropout`` would draw from the global generator instead.
    """

    if generator is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if isinstance(generator, DropoutTape):
        keep = generator.keep(x.shape, rate, x.device)
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with ``kernel`` [in, out]."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class LayerNorm32(nn.Module):
    """LayerNorm with float32 internal compute (eps 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
        normed = (x32 - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (normed * self.scale + self.bias).to(x.dtype)


class RMSNorm(nn.Module):
    """Root-mean-square norm with affine scale and bias (float32 compute)."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.dim:
            raise ValueError("RMSNorm dimension mismatch")
        x32 = x.float()
        variance = (x32**2).mean(dim=-1, keepdim=True)
        normed = x32 * torch.reciprocal(torch.sqrt(variance + self.eps))
        return (normed * self.scale + self.bias).to(x.dtype)


def positional_encoding(length: int, d_model: int, device=None) -> torch.Tensor:
    """Deterministic sinusoidal encoding [L, d_model] in float32."""

    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    n_cos = pe[:, 1::2].shape[1]
    pe[:, 1::2] = torch.cos(position * div_term[:n_cos])
    return pe


def lrtc_basis(length: int, rank: int, device=None) -> torch.Tensor:
    """DCT-II cosine basis [L, R], column zero-meaned and L2-normalised."""

    steps = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    freqs = torch.arange(1, rank + 1, dtype=torch.float32, device=device)[None, :]
    basis = torch.cos(math.pi / float(length) * (steps + 0.5) * freqs)
    basis = basis - basis.mean(dim=0, keepdim=True)
    norm = torch.linalg.norm(basis, dim=0, keepdim=True)
    return basis / torch.clamp(norm, min=torch.finfo(torch.float32).eps)


class LowRankTemporalContext(nn.Module):
    """Zero-mean rank-R temporal context with a learnable scalar scale."""

    def __init__(self, rank: int) -> None:
        super().__init__()
        self.rank = rank
        self.scale = nn.Parameter(torch.zeros(()))

    def forward(self, coeff: torch.Tensor, length: int) -> torch.Tensor:
        if coeff.dim() != 3 or coeff.shape[-1] != self.rank:
            raise ValueError("LowRankTemporalContext expects coeff shaped [B, N, R]")
        basis = lrtc_basis(length, self.rank, device=coeff.device).to(coeff.dtype)
        context = torch.einsum("lr,bnr->bln", basis, coeff)
        context = context - context.mean(dim=1, keepdim=True)
        return context * self.scale.to(coeff.dtype)


_VALID_NORM_MODES = ("none", "layer", "rms", "decoupled")


class DataEmbedding(nn.Module):
    """value Dense + sinusoidal positional (+ optional temporal Dense).

    ``embed_norm_mode``: ``decoupled`` gives ``value + gate *
    LayerNorm(pos + temporal)`` with a learnable gate; ``layer`` / ``rms``
    normalise the summed embedding; ``none`` is the plain sum. Dropout
    follows, drawn from ``generator`` (None: deterministic).
    """

    def __init__(
        self, c_in: int, d_model: int, time_features: int = 0,
        embed_norm_mode: str = "decoupled", dropout: float = 0.0,
    ) -> None:
        super().__init__()
        if embed_norm_mode not in _VALID_NORM_MODES:
            raise ValueError(
                f"embed_norm_mode must be one of {sorted(_VALID_NORM_MODES)}, "
                f"got {embed_norm_mode!r}"
            )
        self.d_model = d_model
        self.time_features = time_features
        self.mode = embed_norm_mode
        self.dropout = float(dropout)
        self.value_embedding = Dense(c_in, d_model)
        if time_features > 0:
            self.temporal_embedding = Dense(time_features, d_model)
        if embed_norm_mode == "decoupled":
            self.aux_norm = LayerNorm32(d_model)
            self.gate = nn.Parameter(torch.full((1, 1, d_model), 0.1))
        elif embed_norm_mode == "layer":
            self.norm = LayerNorm32(d_model)
        elif embed_norm_mode == "rms":
            self.norm = RMSNorm(d_model)

    def forward(
        self, x: torch.Tensor, x_mark: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError("DataEmbedding expects input shaped [B, L, C]")
        L = x.shape[1]
        value = self.value_embedding(x)
        pos = positional_encoding(L, self.d_model, device=x.device).to(value.dtype)[None]
        if self.time_features > 0 and x_mark is not None:
            aux = pos + self.temporal_embedding(x_mark.to(value.dtype))
        else:
            aux = pos.expand_as(value)
        if self.mode == "decoupled":
            out = value + self.gate.to(value.dtype) * self.aux_norm(aux)
        else:
            out = value + aux
            if self.mode in ("layer", "rms"):
                out = self.norm(out)
        return dropout(out, self.dropout, generator)


def resolve_embed_norm_mode(use_norm: bool, embed_norm_mode: Optional[str]) -> str:
    """Explicit mode wins; else decoupled iff use_norm."""

    if embed_norm_mode is None:
        return "decoupled" if use_norm else "none"
    mode = str(embed_norm_mode).lower()
    if mode not in _VALID_NORM_MODES:
        raise ValueError(
            f"embed_norm_mode must be one of {sorted(_VALID_NORM_MODES)}, got {embed_norm_mode!r}"
        )
    return mode
