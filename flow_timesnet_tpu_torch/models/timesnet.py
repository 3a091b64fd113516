"""TimesNet top-level model (counterpart of ``flow_timesnet_tpu/models/timesnet.py``).

``[B, T >= input_len, N] -> (rate, dispersion)``, both ``[B, out_steps, N]``
with ``out_steps = pred_len`` (direct) or 1 (recursive). The shared FFT
selector runs once per layer and feeds its TimesBlock; grouping is
static-shape masked math, so the forward has no data-dependent Python
control flow and no host synchronisation. With ``frozen_periods`` (one
tuple of ``(period, freq_bin, valid)`` slots per layer) the selector is
skipped and every block takes the frozen-period path, on the same
parameters. In training mode the forward
takes the step's ``torch.Generator`` for its dropout (embedding, inception
blocks, residual) and ``row_valid`` to keep padded batch rows out of the
period statistics; backward runs through the fold conv's autograd Function.
With ``use_checkpoint`` a training forward that records gradients runs each
layer's selector and block as one rematerialised region (the JAX package's
``nn.remat(run_block)``): its activations are recomputed in the backward,
with the forward's dropout masks (:class:`~.embedding.DropoutTape`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.softplus import softplus20
from ..parallel import mesh
from .embedding import (
    DataEmbedding,
    Dense,
    DropoutTape,
    LayerNorm32,
    LowRankTemporalContext,
    dropout,
    resolve_embed_norm_mode,
)
from .period import resolve_log_base, resolve_max_unique, select_periods
from .timesblock import TimesBlock, resolve_period_buckets


@dataclass(frozen=True)
class TimesNetConfig:
    """Static model hyper-parameters + data dimensions (the JAX package's fields,
    less ``use_pallas``, which only selects a JAX backend)."""

    input_len: int
    pred_len: int
    d_model: int = 128
    d_ff: Optional[int] = None
    n_layers: int = 2
    k_periods: int = 2
    kernel_set: Tuple[Tuple[int, int], ...] = ((3, 3), (5, 5), (7, 7))
    dropout: float = 0.1
    activation: str = "gelu"
    mode: str = "direct"
    bottleneck_ratio: float = 1.0
    min_period_threshold: int = 1
    use_checkpoint: bool = False
    use_embedding_norm: bool = True
    embed_norm_mode: Optional[str] = None
    min_sigma: float = 1e-3
    id_embed_dim: int = 32
    static_proj_dim: Optional[int] = None
    static_layernorm: bool = True
    use_zero_mean_context: bool = False
    context_rank: int = 0
    context_scale: float = 1e-2
    use_constant_context_bias: bool = False
    use_late_bias_head: bool = True
    c_in: int = 1
    static_dim: int = 0
    time_features: int = 0
    id_vocab: int = 1
    period_max_unique: object = None
    period_binning: object = None
    compute_dtype: str = "float32"
    period_cap: Optional[int] = None
    period_buckets: object = None
    frozen_periods: object = None

    def __post_init__(self) -> None:
        if self.mode not in ("direct", "recursive"):
            raise ValueError("mode must be 'direct' or 'recursive'")
        if self.d_ff is not None and self.d_ff <= 0:
            raise ValueError("d_ff must be a positive integer")
        if self.bottleneck_ratio <= 0:
            raise ValueError("bottleneck_ratio must be a positive value")
        if self.id_embed_dim < 0:
            raise ValueError("id_embed_dim must be non-negative")
        if self.context_rank < 0:
            raise ValueError("context_rank must be non-negative")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be 'float32' or 'bfloat16'")
        # a frozen dataclass hashes its fields: a list-like ladder becomes a tuple
        if isinstance(self.period_buckets, (list, set)):
            object.__setattr__(self, "period_buckets",
                               tuple(int(c) for c in self.period_buckets))
        # a ladder that does not resolve fails here (the fold runs the full cap)
        resolve_period_buckets(self.period_buckets, self.input_len, max(1, self.input_len - 1))

    @property
    def out_steps(self) -> int:
        return self.pred_len if self.mode == "direct" else 1

    @property
    def hidden_ff(self) -> int:
        return self.d_ff if self.d_ff is not None else self.d_model

    @property
    def static_out(self) -> int:
        if self.static_dim <= 0:
            return 0
        return self.static_proj_dim if self.static_proj_dim else self.static_dim

    @property
    def context_dim(self) -> int:
        return self.static_out + max(0, self.id_embed_dim)

    @property
    def pmax(self) -> int:
        pmax = self.input_len
        if self.period_cap is not None:
            pmax = min(pmax, max(1, int(self.period_cap)))
        return pmax


class Embed(nn.Module):
    """flax ``nn.Embed``: a table ``embedding`` [vocab, dim].

    :meth:`shard` keeps only this rank's rows of the table (data
    parallelism over more than one rank): the lookup then goes through
    :class:`~..parallel.mesh.ShardedLookup`, whose output equals the whole
    table's bit for bit."""

    def __init__(self, vocab: int, dim: int) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab, dim))
        self.sharded = False

    def shard(self) -> None:
        """Cut the table to this rank's rows (the world must divide them)."""

        self.embedding = nn.Parameter(mesh.local_rows(self.embedding.detach()).clone())
        self.sharded = True

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.sharded:
            return mesh.ShardedLookup.apply(self.embedding, ids)
        return self.embedding[ids.long()]


class TimesNet(nn.Module):
    """FFT-period TimesNet with NegBin (rate, dispersion) heads.

    Submodules and parameters carry the flax names of the JAX model, so
    ``state_dict`` keys read like ``blocks_0.inception_in.branch_2.conv_kernel``.
    The static projection and the series embedding exist when the config
    asks for them; the forward uses them when their inputs are given.
    """

    def __init__(self, cfg: TimesNetConfig) -> None:
        super().__init__()
        self.cfg = cfg
        ctx_dim = cfg.context_dim
        if cfg.static_dim > 0:
            self.static_proj = Dense(cfg.static_dim, cfg.static_out)
            if cfg.static_layernorm:
                self.static_norm = LayerNorm32(cfg.static_out)
        if cfg.id_embed_dim > 0:
            self.series_embedding = Embed(cfg.id_vocab, cfg.id_embed_dim)
        if ctx_dim > 0:
            self.context_norm = LayerNorm32(ctx_dim)
            if cfg.use_zero_mean_context and cfg.context_rank > 0:
                self.context_coeff = Dense(ctx_dim, cfg.context_rank)
                self.temporal_context = LowRankTemporalContext(cfg.context_rank)
            if cfg.use_constant_context_bias:
                self.context_proj = Dense(ctx_dim, 1)
        self.embedding = DataEmbedding(
            cfg.c_in, cfg.d_model, cfg.time_features,
            resolve_embed_norm_mode(cfg.use_embedding_norm, cfg.embed_norm_mode), cfg.dropout,
        )
        pmax = cfg.pmax
        self.min_thresh = min(pmax, max(1, cfg.min_period_threshold))
        p_cap = min(pmax, max(1, cfg.input_len - 1))
        frozen = [None] * cfg.n_layers
        if cfg.frozen_periods is not None:
            frozen = [tuple(tuple(slot) for slot in layer) for layer in cfg.frozen_periods]
            if len(frozen) != cfg.n_layers:
                raise ValueError(
                    "frozen_periods must carry one slot tuple per layer "
                    f"(got {len(frozen)} for n_layers={cfg.n_layers})"
                )
        for i in range(cfg.n_layers):
            self.add_module(
                f"blocks_{i}",
                TimesBlock(
                    d_model=cfg.d_model,
                    d_ff=cfg.hidden_ff,
                    kernel_set=tuple(tuple(int(k) for k in ks) for ks in cfg.kernel_set),
                    activation=cfg.activation,
                    bottleneck_ratio=cfg.bottleneck_ratio,
                    min_period=self.min_thresh,
                    max_period=pmax,
                    p_cap=p_cap,
                    log_base=resolve_log_base(cfg.period_binning, i),
                    max_unique=resolve_max_unique(cfg.period_max_unique, i),
                    conv_dtype=cfg.compute_dtype,
                    dropout=cfg.dropout,
                    frozen=frozen[i],
                    period_buckets=cfg.period_buckets,
                ),
            )
        self.layer_norm = LayerNorm32(cfg.d_model)
        self.forecast_time_proj = Dense(cfg.input_len, cfg.pred_len)
        self.mu_head = Dense(cfg.d_model, cfg.c_in)
        self.sigma_head = Dense(cfg.d_model, cfg.c_in)
        if ctx_dim > 0 and cfg.use_late_bias_head:
            self.late_bias_norm = LayerNorm32(ctx_dim)
            self.late_bias_head = Dense(ctx_dim, cfg.out_steps)
            self.late_bias_gate = nn.Parameter(torch.full((1, cfg.out_steps, 1), 0.05))

    def _context(self, B: int, N: int, series_static, series_ids, device):
        cfg = self.cfg
        context = None
        if cfg.static_dim > 0 and series_static is not None:
            if series_static.dim() == 2:
                static_in = series_static[None].expand((B,) + tuple(series_static.shape))
            elif series_static.dim() == 3:
                static_in = series_static
            else:
                raise ValueError("series_static must have shape [N, F] or [B, N, F]")
            context = self.static_proj(static_in.float())
            if cfg.static_layernorm:
                context = self.static_norm(context)
        if cfg.id_embed_dim > 0:
            if series_ids is None:
                ids = torch.arange(N, device=device)[None].expand(B, N)
            else:
                ids = series_ids if series_ids.dim() > 1 else series_ids[None]
                if ids.shape[0] == 1 and B > 1:
                    ids = ids.expand(B, N)
            emb = self.series_embedding(ids)
            context = emb if context is None else torch.cat([context, emb], dim=-1)
        return context

    def _run_block(self, block, seq, row_valid, generator):
        """One layer: the shared selector, then the block (a frozen block
        re-derives its weights from its static bins)."""

        cfg = self.cfg
        sel = (None if block.frozen is not None else
               select_periods(seq, cfg.k_periods, cfg.pmax, self.min_thresh, row_valid))
        return block(seq, sel, row_valid, generator)

    def _run_block_remat(self, block, seq, row_valid, generator):
        """:meth:`_run_block` as one rematerialised region: autograd keeps
        only its inputs, and the backward runs it again to rebuild what it
        needs (``torch.utils.checkpoint``, non-reentrant). The recompute
        draws no dropout: it replays the masks the forward drew and kept
        (:class:`~.embedding.DropoutTape`). It records no telemetry either:
        the block's record is the forward's."""

        tape = None if generator is None else DropoutTape(generator)
        calls = []

        def region(x, rv):
            if not calls:  # the forward
                calls.append(True)
                return self._run_block(block, x, rv, tape)
            if tape is not None:
                tape.replay()
            record, block.telemetry = block.telemetry, None
            try:
                return self._run_block(block, x, rv, tape)
            finally:
                block.telemetry = record

        return checkpoint(region, seq, row_valid, use_reentrant=False, preserve_rng_state=False)

    def forward(
        self,
        x: torch.Tensor,
        x_mark: Optional[torch.Tensor] = None,
        series_static: Optional[torch.Tensor] = None,
        series_ids: Optional[torch.Tensor] = None,
        dispersion_floor: Optional[torch.Tensor] = None,
        row_valid: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``row_valid`` [B] is 0 for padded batch rows; ``generator`` drives
        dropout in training mode and is ignored in eval mode."""

        cfg = self.cfg
        if not self.training:
            generator = None
        elif generator is None and cfg.dropout > 0:
            raise ValueError("a training forward with dropout needs a torch.Generator")
        if x.dim() != 3:
            raise ValueError("TimesNet expects input shaped [B, T, N]")
        B, T, N = x.shape
        if T < cfg.input_len:
            raise ValueError(
                f"Input sequence length {T} is shorter than required input_len {cfg.input_len}"
            )
        if N != cfg.c_in:
            raise ValueError("Number of series differs from configured c_in")
        L = cfg.input_len
        x_val = x[:, -L:, :]
        marks = x_mark[:, -L:, :] if x_mark is not None else None
        target_steps = cfg.out_steps

        # context: static covariates + series-id embedding
        context = self._context(B, N, series_static, series_ids, x.device)
        x_feat = x_val
        if context is not None:
            context = self.context_norm(context)
            if cfg.use_zero_mean_context and cfg.context_rank > 0:
                coeff = self.context_coeff(context.float())
                signal = self.temporal_context(coeff, L)
                x_feat = x_val + signal.to(x_val.dtype)
            if cfg.use_constant_context_bias:
                bias = self.context_proj(context.float())[..., 0]
                x_feat = x_feat + bias.to(x_feat.dtype)[:, None, :]

        # embedding + copy-last history baseline
        seq = self.embedding(x_feat, marks, generator)
        hist_steps = min(target_steps, L)
        history_tail = x_val[:, -hist_steps:, :]
        if hist_steps < target_steps:
            pad = history_tail[:, -1:, :].expand(B, target_steps - hist_steps, N)
            history_tail = torch.cat([history_tail, pad], dim=1)

        # shared period selection + TimesBlock stack; the residual dropout and
        # the norm stay outside a rematerialised region, as in JAX
        remat = cfg.use_checkpoint and self.training and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            block = getattr(self, f"blocks_{i}")
            run = self._run_block_remat if remat else self._run_block
            updated = run(block, seq, row_valid, generator)
            seq = self.layer_norm(seq + dropout(updated - seq, cfg.dropout, generator))

        # heads: Dense over time on [B, D, L], then per-feature heads
        baseline_bn = self.forecast_time_proj(seq.transpose(1, 2))  # [B, D, pred_len]
        if target_steps != cfg.pred_len:
            baseline_bn = baseline_bn[:, :, -target_steps:]
        baseline_hidden = baseline_bn.transpose(1, 2)  # [B, out_steps, D]
        mu = self.mu_head(baseline_hidden)
        rate_preact = mu + history_tail.to(mu.dtype)
        if context is not None and cfg.use_late_bias_head:
            c = self.late_bias_norm(context.float())
            late = self.late_bias_head(c).transpose(1, 2)  # [B, out_steps, N]
            rate_preact = rate_preact + (self.late_bias_gate * late).to(rate_preact.dtype)
        rate = softplus20(rate_preact.float()).to(rate_preact.dtype) + 1e-6

        sigma = self.sigma_head(baseline_hidden)
        sigma_sp = softplus20(sigma.float()).to(sigma.dtype)
        if dispersion_floor is not None:
            floor = torch.as_tensor(dispersion_floor, dtype=sigma_sp.dtype, device=sigma_sp.device)
            if floor.dim() == 1:
                floor = floor.reshape(1, 1, -1)
            floor = floor.expand_as(sigma_sp)
        else:
            floor = torch.full_like(sigma_sp, cfg.min_sigma)
        dispersion = sigma_sp + floor + 1e-6
        return rate, dispersion
