"""Model FLOPs of a TimesNet configuration, from the configuration alone.

Two FLOPs per multiply-add of every matmul and convolution the model
defines, at the configuration's widths: the context (static projection,
low-rank coefficients and their temporal basis, the late bias), the
embedding (value and calendar), per layer and per candidate period over
the ``input_len`` positions the two inception blocks (each branch's 1x1
reduce, kh x kw conv and 1x1 expand, the projection over the concatenated
branches, the 1x1 residual where the widths differ), and the heads (the
Dense over time, the rate and dispersion heads). A layer counts
``k_periods`` candidates, or ``period_max_unique`` where that is fewer.
The FFT, norms, activations and the loss are not counted. A training step
counts three forwards; a rematerialised forward and the fold padding that
an implementation runs are not counted, so the count reads the same work
whatever implements it.
"""

from __future__ import annotations

import math

from portbench.reference.timesnet import per_depth


def candidates(model: dict, depth: int) -> int:
    """The candidate periods layer ``depth`` runs: ``k_periods`` (at most
    ``input_len // 2``), capped by ``period_max_unique``."""

    k = min(int(model["k_periods"]), int(model["input_len"]) // 2)
    cap = per_depth(model.get("period_max_unique"), depth)
    return min(k, int(float(cap))) if cap not in (None, "null") and int(float(cap)) > 0 else k


def inception_macs(c_in: int, c_out: int, kernels, bottleneck: float) -> int:
    """Multiply-adds of one inception block at one position."""

    mid = max(1, math.ceil(min(c_in, c_out) / bottleneck))
    macs = 0
    for kh, kw in kernels:
        if bottleneck == 1.0:
            macs += kh * kw * c_in * c_out
        else:
            macs += c_in * mid + kh * kw * mid * mid + mid * c_out
    macs += len(kernels) * c_out * c_out  # the projection over the concatenated branches
    if c_in != c_out:
        macs += c_in * c_out  # the 1x1 residual
    return macs


def forward_flops(model: dict, data: dict) -> int:
    """FLOPs of one window's forward (one series of the batch)."""

    L, H, D = int(model["input_len"]), int(model["pred_len"]), int(model["d_model"])
    d_ff = int(model.get("d_ff") or D)
    kernels = [tuple(k) for k in model["kernel_set"]]
    bottleneck = float(model.get("bottleneck_ratio", 1.0))
    static_dim, tf = int(data.get("static_dim", 0)), int(data["time_features"])
    static_out = int(model.get("static_proj_dim") or static_dim) if static_dim else 0
    ctx = static_out + int(model.get("id_embed_dim", 0))
    rank = int(model.get("context_rank", 0)) if model.get("use_zero_mean_context") else 0
    macs = static_dim * static_out + ctx * rank + L * rank  # context and its temporal signal
    macs += ctx * H  # the late bias head
    macs += L * (1 + tf) * D  # value and calendar embeddings
    block = inception_macs(D, d_ff, kernels, bottleneck) + inception_macs(d_ff, D, kernels,
                                                                           bottleneck)
    for depth in range(int(model["n_layers"])):
        macs += candidates(model, depth) * L * block
    macs += D * L * H + 2 * H * D  # the Dense over time, the rate and dispersion heads
    return 2 * macs


def step_flops(model: dict, data: dict, batch: int) -> int:
    """FLOPs of a training step of ``batch`` windows: three forwards."""

    return 3 * batch * forward_flops(model, data)
