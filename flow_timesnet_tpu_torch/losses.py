"""Probabilistic losses (counterpart of ``flow_timesnet_tpu/losses.py``).

Float32 throughout: the NB2 negative log-likelihood with a valid-element
mask and a denominator floor of 1, and the legacy Gaussian NLL.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

LOG_2PI = math.log(2.0 * math.pi)


def negative_binomial_mask(
    y: torch.Tensor,
    rate: torch.Tensor,
    dispersion: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Boolean mask of elements with finite (y, rate, dispersion).

    A user mask with fewer dims than the target broadcasts from the left
    (trailing singleton dims).
    """

    finite = torch.isfinite(y) & torch.isfinite(rate) & torch.isfinite(dispersion)
    if mask is not None:
        m = mask.bool()
        while m.dim() < finite.dim():
            m = m[..., None]
        finite = finite & m
    return finite


def negative_binomial_nll(
    y: torch.Tensor,
    rate: torch.Tensor,
    dispersion: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NB2 negative log-likelihood averaged over valid elements (float32).

    Mean ``mu = rate``, dispersion ``alpha``, ``Var = mu + alpha * mu^2``::

        lgamma(y + 1/a) - lgamma(1/a) - lgamma(y + 1)
        - (1/a) * log1p(a*mu) + y * (log a + log mu - log1p(a*mu))

    The loss equals the JAX package's. Invalid elements are replaced by safe
    values before the terms are formed, not only zeroed after: the gradient
    of an unselected ``where`` branch is 0 times that branch's derivative,
    which is NaN for a NaN target, so zeroing after (as the JAX package does)
    lets a NaN in a masked element reach every parameter's gradient.

    ``count``, where given, is the denominator's count of valid elements in
    place of this call's own: under data parallelism the global batch's
    (summed over the ranks), so that the ranks' losses and gradients sum to
    the global batch's.
    """

    y32 = torch.clamp(y.float(), min=0.0)
    alpha = torch.clamp(dispersion.float(), min=eps)
    mu = torch.clamp(rate.float(), min=eps)
    valid = negative_binomial_mask(y32, mu, alpha, mask)
    one = torch.ones((), dtype=torch.float32, device=y32.device)
    y32 = torch.where(valid, y32, torch.zeros_like(one))
    alpha = torch.where(valid, alpha, one)
    mu = torch.where(valid, mu, one)

    log1p_am = torch.log1p(alpha * mu)
    inv_alpha = 1.0 / alpha
    ll = (
        torch.lgamma(y32 + inv_alpha)
        - torch.lgamma(inv_alpha)
        - torch.lgamma(y32 + 1.0)
        - inv_alpha * log1p_am
        + y32 * (torch.log(alpha) + torch.log(mu) - log1p_am)
    )
    denom = torch.clamp(valid.float().sum() if count is None else count, min=1.0)
    masked_ll = torch.where(valid, ll, torch.zeros_like(ll))
    return -masked_ll.sum() / denom


def gaussian_nll_loss(
    mu: torch.Tensor,
    sigma: torch.Tensor,
    target: torch.Tensor,
    min_sigma: Union[float, torch.Tensor] = 0.0,
) -> torch.Tensor:
    """Element-wise Gaussian NLL in float32 with an optional sigma floor
    (a scalar or a broadcastable per-series tensor)."""

    mu32, sigma32, target32 = mu.float(), sigma.float(), target.float()
    if isinstance(min_sigma, (int, float)):
        if float(min_sigma) > 0.0:
            sigma32 = torch.clamp(sigma32, min=float(min_sigma))
    else:
        floor = torch.as_tensor(min_sigma, dtype=torch.float32, device=sigma32.device)
        if floor.numel() > 0:
            sigma32 = torch.maximum(sigma32, floor)
    z = (target32 - mu32) / sigma32
    return 0.5 * (z**2 + 2.0 * torch.log(sigma32) + LOG_2PI)
