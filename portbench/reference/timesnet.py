"""A plain float32 TimesNet with negative-binomial heads: the benchmark's reference.

It follows TimesNet (Wu et al., ICLR 2023, https://arxiv.org/abs/2210.02186)
as the configurations in ``portbench/configs/`` set it, and imports nothing
of the program under test. Each period candidate is folded the published way:
the sequence is zero-padded to a whole number of periods, reshaped to a
``[cycles, period]`` grid and run through 2D convolutions with zero padding
(``torch.nn.functional.conv2d``). Matmuls and convolutions run in float32
with TF32 off.

Departures from the published TimesNet, all of them the configurations':

- The period selector takes, per sample, the lower median over channels of
  the rFFT amplitudes (the paper averages), then the batch mean over the
  rows that ``row_valid`` keeps, sets the DC bin to -inf, subtracts
  ``1e-8 * log1p(bin)``, and keeps the top ``k_periods`` bins (ties to the
  lower bin). A period is ``ceil(L / bin)``, clamped to
  ``[min_period_threshold, L - 1]``; fewer than two cycles is invalid.
  Where the k-th and the (k+1)-th scores lie within the compute type's
  rounding of each other (:class:`Ties`), either bin is the stated
  selection, and the reference can be run with each.
- Candidates are grouped (equal periods, or equal ``floor(log_base p)``
  with ``period_binning``); the per-layer ``period_max_unique`` keeps the
  best-scored groups and moves the others to the nearest kept period. Every
  candidate keeps its own softmax weight over the per-sample amplitudes,
  and the block adds ``sum_k w_k (fold_k(x) - x)`` to its input.
- Inception branches are bottlenecked (1x1 reduce, kxk conv, 1x1 expand);
  the branches' outputs are concatenated and mixed by a 1x1 projection,
  then GELU, dropout and a 1x1 residual; two such blocks (d_model -> d_ff
  -> d_model) with a GELU between them make a layer.
- ``compute_dtype: bfloat16`` rounds the inception stacks' tensors to
  bfloat16 where the configuration computes in it (the inputs and weights of
  every 1x1 and kxk convolution, each block's output, its GELU, dropout and
  residual sum) while every product is summed in float32.
  :class:`Rounding` does that rounding in float32 arithmetic; the control
  runs the same places in float8 (e4m3, saturating at +-448) in the forward,
  passing gradients through unrounded.
- A context (a 1x1 projection of the static features with a LayerNorm, and
  a series-id embedding) feeds a zero-mean low-rank temporal signal (DCT-II
  basis) into the input and a gated late bias into the rate head. The
  embedding is ``value + gate * LayerNorm(position + calendar)``.
- The heads are a Dense over time (``input_len -> pred_len``) and per-step
  Dense heads for the rate (plus the last ``pred_len`` inputs) and the
  dispersion, each through softplus (linear above 20); the dispersion adds
  a per-series floor.

Dropout masks are drawn with ``torch.rand(shape, generator=g) >= rate`` in
the order the layers run: the embedding, then per layer the first and the
second inception block (one ``[K, B, L + L - 1, C]`` draw each, every
candidate's grid its first ``cycles * period`` rows) and the residual. The
same seed and order give the same masks on the same device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class Rounding:
    """Rounding of the inception stacks' tensors: ``float32`` (none),
    ``bfloat16`` (the configurations' compute type) or ``float8`` (e4m3,
    the control)."""

    def __init__(self, name: str) -> None:
        if name not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown rounding {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).float()
        if self.name == "float8":  # the values rounded, the gradient passed through
            return x + (x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float() - x).detach()
        return x


class Masks:
    """The dropout keep-masks of one training step, drawn in layer order."""

    def __init__(self, generator: torch.Generator, rate: float) -> None:
        self.generator = generator
        self.rate = float(rate)

    def keep(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=device) >= self.rate

    def drop(self, x: torch.Tensor, keep: torch.Tensor, rnd: Rounding) -> torch.Tensor:
        return torch.where(keep, rnd(x / (1.0 - self.rate)), torch.zeros((), device=x.device))


class Ties:
    """The top-k choices that a near-tie leaves to rounding.

    Where a selection's k-th and (k+1)-th batch scores differ by no more
    than ``tol`` of the k-th, an implementation that computes the scores in
    the configuration's type may keep either bin. The selections are
    numbered in the order they run (over every forward this object goes
    through); those in ``swap`` keep the (k+1)-th bin in place of the k-th,
    and ``tied`` lists every one that fell within ``tol``."""

    # a relative tolerance of each compute type: bfloat16's unit roundoff,
    # and for float32 what summation order moves a batch mean by
    TOL = {"bfloat16": 2.0 ** -8, "float32": 2.0 ** -16}

    def __init__(self, tol: float, swap=()) -> None:
        self.tol, self.swap = float(tol), frozenset(swap)
        self.count, self.tied = 0, []

    def choose(self, ranked: list, score: list, k: int) -> list:
        """The bins a selection keeps, from all bins ``ranked`` by score."""

        i = self.count
        self.count += 1
        if len(ranked) > k and abs(score[ranked[k - 1]] - score[ranked[k]]) <= \
                self.tol * abs(score[ranked[k - 1]]):
            self.tied.append(i)
            if i in self.swap:
                return ranked[:k - 1] + [ranked[k]]
        return ranked[:k]


def tie_branches(run, tol: float, most: int = 8) -> list:
    """``run(ties)`` once for each way of resolving the near-ties it meets
    (at most ``most`` ways, the fewest swaps first): every result."""

    out, todo = [], [frozenset()]
    while todo and len(out) < most:
        swap = todo.pop(0)
        ties = Ties(tol, swap)
        out.append(run(ties))
        last = max(swap, default=-1)
        todo += [swap | {i} for i in ties.tied if i > last]
    return out


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * scale + bias


def dense(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.kernel"] + p[f"{name}.bias"]


def positions(L: int, D: int, device) -> torch.Tensor:
    """Sinusoidal position encoding [L, D] (float32, as the paper's)."""

    pos = torch.arange(L, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, D, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / D))
    out = torch.zeros((L, D), device=device)
    out[:, 0::2] = torch.sin(pos * div)
    out[:, 1::2] = torch.cos(pos * div[: D // 2])
    return out


def dct_basis(L: int, R: int, device) -> torch.Tensor:
    """DCT-II basis [L, R] of frequencies 1..R, each column zero-mean and of unit norm."""

    t = torch.arange(L, dtype=torch.float32, device=device)[:, None]
    f = torch.arange(1, R + 1, dtype=torch.float32, device=device)[None, :]
    basis = torch.cos(math.pi / L * (t + 0.5) * f)
    basis = basis - basis.mean(dim=0, keepdim=True)
    return basis / basis.norm(dim=0, keepdim=True)


def per_depth(raw, depth: int):
    """A per-depth value: a number, or ``"0:4,default:2"`` (the highest key
    at or below ``depth``, else ``default``)."""

    if raw is None or isinstance(raw, (int, float)):
        return raw
    explicit, default = {}, None
    for token in str(raw).split(","):
        key, _, val = token.strip().partition(":")
        if not val:
            default = key
        elif key in ("default", "*"):
            default = val
        else:
            explicit[int(key)] = val
    below = [d for d in explicit if d <= depth]
    return explicit[max(below)] if below else default


def _median_lower(x: torch.Tensor) -> torch.Tensor:
    """Lower median over the last axis: order statistic ``(n - 1) // 2``."""

    return torch.sort(x, dim=-1).values[..., (x.shape[-1] - 1) // 2]


def _batch_mean(v: torch.Tensor, rv: Optional[torch.Tensor]) -> torch.Tensor:
    if rv is None:
        return v.mean(dim=0)
    w = rv.reshape((-1,) + (1,) * (v.dim() - 1))
    kept = torch.where(w > 0, v, torch.zeros((), device=v.device))
    return (kept * w).sum(dim=0) / torch.clamp(w.sum(), min=1.0)


def select_and_group(seq: torch.Tensor, cfg: dict, depth: int, rv, ties: Optional[Ties] = None):
    """The layer's candidates: ``[(period, ok)]`` per candidate and the
    softmax weights ``[B, K]``; decided on the host from the amplitudes
    (a near-tie of the top ``k`` as ``ties`` resolves it)."""

    B, L, C = seq.shape
    n_freq = L // 2 + 1
    k = min(int(cfg["k_periods"]), n_freq - 1)
    upper = min(int(cfg["input_len"]), L - 1)
    low = min(int(cfg["input_len"]), max(1, int(cfg.get("min_period_threshold", 1))))
    amp = torch.fft.rfft(seq, dim=1).abs()  # [B, F, C]
    amp_med = _median_lower(amp)  # [B, F]
    with torch.no_grad():  # float32, as the selector's arithmetic is stated
        score = _batch_mean(amp_med, rv).cpu()
        score[0] = -math.inf
        score = (score - 1e-8 * torch.log1p(torch.arange(n_freq, dtype=torch.float32))).tolist()
    ranked = sorted(range(n_freq), key=lambda i: (-score[i], i))
    order = ties.choose(ranked, score, k) if ties is not None else ranked[:k]
    bins = [max(1, i) for i in order]
    amps = amp_med[:, bins]  # [B, K]
    periods = [min(max(-(-L // b), low), upper) for b in bins]
    ok = [(-(-L // p)) >= 2 and low <= p <= int(cfg["input_len"]) for p in periods]
    if upper < low:
        ok = [False] * k

    base = per_depth(cfg.get("period_binning"), depth)
    base = float(base) if base not in (None, "null") else None
    keys = [int(math.floor(math.log(p) / math.log(base) + 1e-6)) if base else p for p in periods]
    with torch.no_grad():
        mean_amp = _batch_mean(amps, rv).double().cpu().tolist()
    canon = []
    for i in range(k):
        if not ok[i]:
            canon.append(i)
            continue
        members = [j for j in range(k) if ok[j] and keys[j] == keys[i]]
        canon.append(max(members, key=lambda j: (mean_amp[j], -j)))
    rep = [ok[i] and canon[i] == i for i in range(k)]
    cap = per_depth(cfg.get("period_max_unique"), depth)
    cap = int(float(cap)) if cap not in (None, "null") else None
    if cap is not None and 0 < cap < k:
        with torch.no_grad():
            logits = []
            for i in range(k):
                members = [j for j in range(k) if ok[j] and canon[j] == i]
                if rep[i]:
                    logits.append(float(_batch_mean(torch.logsumexp(amps[:, members], dim=1),
                                                    rv)))
                else:
                    logits.append(-math.inf)
        rank = [sum(1 for j in range(k) if rep[i] and rep[j] and (
            logits[j] > logits[i] or (logits[j] == logits[i] and keys[j] < keys[i])))
            for i in range(k)]
        kept = [rep[i] and rank[i] < cap for i in range(k)]

        def nearest(i):
            dist = [abs(periods[i] - periods[j]) + rank[j] / (2.0 * k) if kept[j] else math.inf
                    for j in range(k)]
            return min(range(k), key=lambda j: (dist[j], j))

        canon = [(canon[i] if kept[canon[i]] else nearest(canon[i])) if ok[i] else canon[i]
                 for i in range(k)]
    final = [periods[canon[i]] if ok[i] else periods[i] for i in range(k)]
    okt = torch.tensor(ok, device=seq.device)
    if any(ok):
        masked = torch.where(okt[None, :], amps, torch.full((), -math.inf, device=seq.device))
        weights = torch.softmax(masked, dim=1)
        weights = torch.where(okt[None, :], weights, torch.zeros((), device=seq.device))
    else:
        weights = torch.zeros_like(amps)
    return list(zip(final, ok)), weights


def _pointwise(x, p, name, rnd):
    return rnd(x) @ rnd(p[f"{name}_kernel"]) + p[f"{name}_bias"]


def inception(x, p: Params, prefix: str, cfg: dict, rnd: Rounding, keep, masks):
    """One inception block over a fold ``[B, cycles, period, Cin]`` (already
    rounded): branches, projection, GELU, dropout (``keep`` or None) and the
    residual (a 1x1 convolution where the widths differ)."""

    feats = []
    for i, (kh, kw) in enumerate(cfg["kernel_set"]):
        b = f"{prefix}.branch_{i}"
        h = rnd(_pointwise(x, p, f"{b}.reduce", rnd))
        w = rnd(p[f"{b}.conv_kernel"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
        h = F.conv2d(h.permute(0, 3, 1, 2), w, padding=(kh // 2, kw // 2)).permute(0, 2, 3, 1)
        h = rnd(h + p[f"{b}.conv_bias"])
        feats.append(rnd(_pointwise(h, p, f"{b}.expand", rnd)))
    z = rnd(_pointwise(torch.cat(feats, dim=-1), p, f"{prefix}.proj", rnd))
    z = rnd(F.gelu(z))
    if keep is not None:
        z = masks.drop(z, keep, rnd)
    res = _pointwise(x, p, f"{prefix}.res", rnd) if f"{prefix}.res_kernel" in p else x
    return rnd(z + rnd(res))


def times_block(seq, p: Params, depth: int, cfg: dict, rnd: Rounding, masks: Optional[Masks], rv,
                ties: Optional[Ties] = None):
    B, L, D = seq.shape
    cands, weights = select_and_group(seq, cfg, depth, rv, ties)
    K = len(cands)
    lp = L + min(int(cfg["input_len"]), L - 1)
    keep_in = keep_out = None
    if masks is not None:
        keep_in = masks.keep((K, B, lp, int(cfg["d_ff"])), seq.device)
        keep_out = masks.keep((K, B, lp, D), seq.device)
    out = seq
    prefix = f"blocks_{depth}"
    for k, (period, ok) in enumerate(cands):
        if not ok:
            continue
        cycles = -(-L // period)
        total = cycles * period
        fold = F.pad(seq, (0, 0, 0, total - L)).reshape(B, cycles, period, D)

        def grid(keep):
            return None if keep is None else keep[k, :, :total].reshape(B, cycles, period, -1)

        h = inception(rnd(fold), p, f"{prefix}.inception_in", cfg, rnd, grid(keep_in), masks)
        h = rnd(F.gelu(h))
        h = inception(h, p, f"{prefix}.inception_out", cfg, rnd, grid(keep_out), masks)
        delta = h.reshape(B, total, D)[:, :L] - seq
        out = out + weights[:, k, None, None] * delta
    return out


def forward(p: Params, cfg: dict, x, x_mark, static, ids, floor, row_valid=None,
            rnd: Optional[Rounding] = None, masks: Optional[Masks] = None,
            ties: Optional[Ties] = None):
    """``(rate, dispersion)`` ``[B, pred_len, 1]`` of ``x`` ``[B, L, 1]``.

    ``static`` [B, 1, Fs], ``ids`` [B, 1] int, ``floor`` [B, 1, 1];
    ``masks`` draws the dropout of a training step (None: deterministic);
    ``ties`` resolves the selector's near-ties (None: by score alone)."""

    rnd = rnd or Rounding(cfg.get("compute_dtype", "float32"))
    L, H = int(cfg["input_len"]), int(cfg["pred_len"])
    x = x[:, -L:, :].float()
    B = x.shape[0]
    float32 = Rounding("float32")

    def drop(t):  # in float32, outside the inception stacks
        return t if masks is None else masks.drop(t, masks.keep(t.shape, t.device), float32)

    ctx = layer_norm(dense(p, "static_proj", static.float()), p["static_norm.scale"],
                     p["static_norm.bias"]) if static is not None else None
    emb = p["series_embedding.embedding"][ids.long()]
    ctx = emb if ctx is None else torch.cat([ctx, emb], dim=-1)
    ctx = layer_norm(ctx, p["context_norm.scale"], p["context_norm.bias"])  # [B, 1, Dc]
    coeff = dense(p, "context_coeff", ctx)  # [B, 1, R]
    signal = torch.einsum("lr,bnr->bln", dct_basis(L, coeff.shape[-1], x.device), coeff)
    signal = (signal - signal.mean(dim=1, keepdim=True)) * p["temporal_context.scale"]
    feat = x + signal

    D = int(cfg["d_model"])
    aux = positions(L, D, x.device)[None] + dense(p, "embedding.temporal_embedding",
                                                  x_mark[:, -L:].float())
    seq = dense(p, "embedding.value_embedding", feat) + p["embedding.gate"] * layer_norm(
        aux, p["embedding.aux_norm.scale"], p["embedding.aux_norm.bias"])
    seq = drop(seq)
    for depth in range(int(cfg["n_layers"])):
        upd = times_block(seq, p, depth, cfg, rnd, masks, row_valid, ties)
        seq = layer_norm(seq + drop(upd - seq), p["layer_norm.scale"], p["layer_norm.bias"])

    hidden = dense(p, "forecast_time_proj", seq.transpose(1, 2)).transpose(1, 2)  # [B, H, D]
    late = dense(p, "late_bias_head", layer_norm(ctx, p["late_bias_norm.scale"],
                                                 p["late_bias_norm.bias"])).transpose(1, 2)
    pre = dense(p, "mu_head", hidden) + x[:, -H:, :] + p["late_bias_gate"] * late
    out_rate = F.softplus(pre, threshold=20.0) + 1e-6
    disp = F.softplus(dense(p, "sigma_head", hidden), threshold=20.0)
    return out_rate, disp + floor.reshape(B, 1, 1).expand_as(disp) + 1e-6


def nb_nll(y, rate, disp, valid) -> torch.Tensor:
    """Mean negative-binomial (NB2) negative log-likelihood over ``valid``:
    mean ``rate``, variance ``rate + disp * rate^2``; targets clipped at 0,
    ``rate`` and ``disp`` at 1e-8."""

    y = torch.clamp(y, min=0.0)
    a = torch.clamp(disp, min=1e-8)
    mu = torch.clamp(rate, min=1e-8)
    valid = valid & torch.isfinite(y) & torch.isfinite(mu) & torch.isfinite(a)
    one = torch.ones((), device=y.device)
    y = torch.where(valid, y, torch.zeros((), device=y.device))
    a = torch.where(valid, a, one)
    mu = torch.where(valid, mu, one)
    r = 1.0 / a
    ll = (torch.lgamma(y + r) - torch.lgamma(r) - torch.lgamma(y + 1.0)
          - r * torch.log1p(a * mu) + y * (torch.log(a) + torch.log(mu) - torch.log1p(a * mu)))
    ll = torch.where(valid, ll, torch.zeros((), device=y.device))
    return -ll.sum() / torch.clamp(valid.float().sum(), min=1.0)


def loss(p: Params, cfg: dict, batch: dict, rnd: Rounding, masks: Optional[Masks],
         ties: Optional[Ties] = None):
    rate, disp = forward(p, cfg, batch["x"], batch["x_mark"], batch["static"], batch["ids"],
                         batch["floor"], batch["row_valid"], rnd, masks, ties)
    valid = (batch["mask"] > 0) & (batch["row_valid"][:, None, None] > 0)
    return nb_nll(batch["y"], rate, disp, valid)

