"""Forward, rollout, training and evaluation steps (counterpart of
``flow_timesnet_tpu/engine.py``).

``train_step`` takes one optimizer step (or one accumulation micro-step)
with gradients through the fold conv's hand kernels; ``evaluate`` streams
the masked NLL and sMAPE sums over a pass and reads them once at its end.
Neither reads a value back to the host inside a step: losses and stats come
back as device tensors. ``collect_period_telemetry`` records each block's
period selection in one deterministic forward, and the static
``frozen_spec_*`` helpers turn it, or a config's stored spec, into the
``frozen_periods`` of an engine on the frozen-period path, which takes the
same parameters and ``TrainState``.

The device-resident epoch (the JAX package's ``lax.scan`` over an epoch,
with the window gather inside it) is ``train_epoch_resident`` over
``data/device_windows.py``'s staged arrays and ``[S, B]`` plan, beside
``evaluate_resident`` and ``collect_period_telemetry_staged``.

On a CUDA device, ``forward``, ``rollout`` (the whole recursive decode),
``train_step`` (without accumulation), each step of
``train_epoch_resident`` and each batch of ``evaluate_resident`` replay a
CUDA graph (``graphs.py``), the counterpart of the JAX package's
compiled programs: one per input signature and, for training, per
``TrainState`` and generator. The first call captures it, after eager
warm-up calls whose effects on the state are undone; a failed capture
raises. On the CPU every path runs the same body eagerly. (The attribute
``Engine.cuda_graphs``, True on the card, may be set to False to dispatch
every op from Python there: the yardstick that the card tests and
``chip_smoke.py`` hold the graphs against.)

Under data parallelism (a group of ``parallel/mesh.py``) each rank steps on
its rows of the global batch: the loss divides by the global count of valid
elements, the gradients and the loss are summed over the ranks in one flat
bucket before the update (a row-sharded series table keeps its own rows'
gradient out of it, and the clip adds its norm), evaluation sums are summed
before the metrics, and the resident passes take their columns of the
global plan. NCCL's collectives are captured with the step; under gloo,
whose collectives cannot be, every step runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from . import graphs, tracing
from .data.device_windows import StagedWindows, gather_batch, strip_augment
from .device import resolve_device
from .losses import negative_binomial_mask, negative_binomial_nll
from .models.timesnet import TimesNet, TimesNetConfig
from .optim import Optimizer, build_optimizer
from .parallel import mesh
from .utils.metrics import smape_batch_sums, wsmape_batch_sums

_ARGS = ("x", "x_mark", "static", "ids", "floor")
_STEP_KEYS = _ARGS + ("row_valid", "y", "mask")  # what a training step reads of a batch
# rows of a resident plan buffer: the JAX trainer's default longest dispatch
# (train.resident_max_dispatch_steps); a longer plan gets a larger buffer
RESIDENT_PLAN_ROWS = 512


@dataclass
class TrainState:
    """What a training run carries from step to step.

    ``params`` are the engine model's own parameters, updated in place by
    the optimizer (which holds the Adam moments); ``grad_accum`` holds the
    running mean gradient when accumulating, else None; ``ema`` the
    Polyak-averaged parameters when ``ema_decay > 0``, else None.
    """

    params: Dict[str, torch.nn.Parameter]
    optimizer: Optimizer
    grad_accum: Optional[Dict[str, torch.Tensor]] = None
    ema: Optional[Dict[str, torch.Tensor]] = None

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a step updates in place, in a fixed order:
        parameters, Adam moments and step counts, accumulator, EMA."""

        out = list(self.params.values()) + self.optimizer.state_tensors()
        for extra in (self.grad_accum, self.ema):
            if extra is not None:
                out.extend(extra.values())
        return out


def _safe_ratio(num, den) -> float:
    """Metric sum / count, +inf on zero coverage or a non-finite sum: a
    diverged model masks every element out, and 0/0 must not read as a
    perfect score."""

    num, den = float(num), float(den)
    if den <= 0.0 or not np.isfinite(num) or not np.isfinite(den):
        return float("inf")
    return num / den


def first_non_finite(state: TrainState, finite: torch.Tensor) -> Optional[str]:
    """What a step's finiteness flags (``stats["finite"]`` under
    ``debug_nans``: the loss, each parameter's gradient, then each parameter
    after the update, in ``state.params`` order) name as not finite, or
    None. Reads the flags, which waits for the card."""

    flags = finite.tolist()
    if all(flags):
        return None
    names = list(state.params)
    parts = [] if flags[0] else ["the loss"]
    for what, part in (("the gradient of {}", flags[1:1 + len(names)]),
                       ("{} after the update", flags[1 + len(names):])):
        bad = [n for n, ok in zip(names, part) if not ok]
        if bad:
            parts.append(what.format(bad[0]) + (f" (and {len(bad) - 1} more)" if bad[1:] else ""))
    return ", ".join(parts)


def _flagged(stats: Dict[str, Any], finite: Optional[List[torch.Tensor]],
             params: List[torch.Tensor]) -> Dict[str, Any]:
    """``stats`` with ``finite``: the flags given, then whether each
    parameter is finite (after the update), where flags are given."""

    if finite is not None:
        stats["finite"] = torch.stack(finite + [torch.isfinite(p).all() for p in params])
    return stats


def _base_mask(y, mask, row_valid, use_loss_masking: bool) -> torch.Tensor:
    base = (mask > 0.0) if use_loss_masking else torch.ones_like(y, dtype=torch.bool)
    if row_valid is not None:
        base = base & (row_valid[:, None, None] > 0.0)
    return base


class Engine:
    """A TimesNet bound to one parameter set on one device, with its steps."""

    def __init__(
        self,
        cfg: TimesNetConfig,
        params: Mapping[str, torch.Tensor],
        device="cuda",
        *,
        use_loss_masking: bool = False,
        accumulation_steps: int = 1,
        grad_clip_norm: float = 0.0,
        weight_decay: float = 0.0,
        num_series: int = 1,
        ema_decay: float = 0.0,
        debug_nans: bool = False,
        shard_table: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = TimesNet(cfg)
        self.model.load_state_dict(dict(params))
        # data parallelism: the series table split by rows over the ranks
        self.sharded: tuple = ()
        if shard_table and mesh.world() > 1 and cfg.id_embed_dim > 0:
            self.model.series_embedding.shard()
            self.sharded = (mesh.TABLE_NAME,)
        self.model.to(self.device).eval()
        self.use_loss_masking = bool(use_loss_masking)
        self.accum_steps = max(1, int(accumulation_steps))
        self.ema_decay = float(ema_decay)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError("ema_decay must be in [0, 1)")
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.weight_decay = float(weight_decay or 0.0)
        self.num_series = int(num_series)
        # each step also flags whether its loss, each gradient and each updated
        # parameter are finite (``stats["finite"]``), for the caller to read:
        # ``train.debug_nans``
        self.debug_nans = bool(debug_nans)
        # replay graphs (see the module's doc); not under gloo, whose
        # collectives a graph cannot capture: there every step runs eagerly
        self.cuda_graphs = self.device.type == "cuda" and mesh.graphs_allowed()
        # graphs by key: its kind first, the tracing state (marks captured) last
        self._graphs: Dict[tuple, graphs.Captured] = {}
        self._graph_state: Optional[TrainState] = None  # the state the training graphs hold
        self._marked = False  # whether a graph holds tracing's marks
        self._pool = None

    # -- CUDA graphs -------------------------------------------------------------

    def _key(self, *parts) -> tuple:
        """A graph's key: ``parts`` (its kind first) and the tracing state,
        so that a marked graph and an unmarked one never share a key."""

        return (*parts, tracing.enabled())

    def _graph(self, key: tuple) -> Optional[graphs.Captured]:
        """The graph captured under ``key``, or None. With tracing off, the
        marked graphs are dropped first."""

        if self._marked and not key[-1]:
            self._graphs = {k: g for k, g in self._graphs.items() if not k[-1]}
            self._marked = False
        return self._graphs.get(key)

    def _capture(self, key: tuple, body, **kwargs) -> graphs.Captured:
        """Capture ``body`` into this engine's memory pool under ``key``: a
        new pool where no graph holds the last one (a capture may share a
        pool only with a live graph)."""

        if self._pool is None or not self._graphs:
            self._pool = torch.cuda.graph_pool_handle()
        graph = graphs.capture(body, self._pool, kind=key[0], **kwargs)
        self._graphs[key] = graph
        self._marked = self._marked or key[-1]
        return graph

    def _training_graphs(self, state: TrainState) -> None:
        """Graphs that train read and write a ``TrainState``'s tensors: a
        new state drops those of the last one (and the evaluation graphs
        captured beside them), so a graph never outlives its state."""

        if state is not self._graph_state:
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[0] in ("forward", "rollout")}
            self._graph_state = state

    # -- forward / decode ------------------------------------------------------

    def _apply(self, params, *args, **kwargs):
        """The model on ``params`` (a name -> tensor mapping), or on its own
        parameters when ``params`` is None."""

        if params is None:
            return self.model(*args, **kwargs)
        return functional_call(self.model, dict(params), args, kwargs)

    @torch.inference_mode()
    def forward(self, x, x_mark=None, static=None, ids=None, floor=None, row_valid=None):
        """Direct forward: ``(rate, dispersion)`` each [B, out_steps, N].

        On the card it replays one CUDA graph per input signature (shapes,
        dtypes, and which inputs are None): the inputs are copied into the
        graph's buffers and the outputs are cloned out.
        """

        self.model.eval()
        args = (x, x_mark, static, ids, floor, row_valid)
        with tracing.span("engine.replay"):
            if not self.cuda_graphs:
                return self._served(*args)
            key = self._key("forward", graphs.signature(args))
            graph = self._graph(key)
            if graph is None:
                bufs = graphs.static_copies(args)
                graph = self._capture(key, lambda: self._served(*bufs), inputs=bufs)
                rate, disp = graph.replay()
            else:
                rate, disp = graph.replay(args)
            return rate.clone(), disp.clone()

    def _served(self, *args):
        """The model's forward on ``args``: a served request's device work."""

        with tracing.region("model.forward", self.device):
            return self.model(*args)

    @torch.inference_mode()
    def rollout(self, x, horizon, x_mark=None, y_mark=None, static=None, ids=None, floor=None,
                row_valid=None):
        """Recursive ``horizon``-step decode: each step's last rate is
        appended to the window (and the next future mark to the marks).

        On the card the whole decode (the ``horizon`` forwards, the windows'
        and the marks' concatenations and the stacking of the steps) is one
        CUDA graph per input signature and horizon, the counterpart of the
        JAX package's ``lax.scan`` decode; a replay equals the eager loop
        bit for bit."""

        self.model.eval()
        horizon = int(horizon)
        args = (x, x_mark, y_mark, static, ids, floor, row_valid)

        def decode(x, x_mark, y_mark, *rest):
            with tracing.region("model.forward", self.device):
                return self._rollout(None, x, horizon, x_mark, y_mark, *rest)

        with tracing.span("engine.replay"):
            if not self.cuda_graphs:
                return decode(*args)
            key = self._key("rollout", horizon, graphs.signature(args))
            graph = self._graph(key)
            if graph is None:
                bufs = graphs.static_copies(args)
                graph = self._capture(key, lambda: decode(*bufs), inputs=bufs)
                rate, disp = graph.replay()
            else:
                rate, disp = graph.replay(args)
            return rate.clone(), disp.clone()

    def _rollout(self, params, x, horizon, x_mark, y_mark, static, ids, floor, row_valid):
        if x_mark is not None and y_mark is None:
            raise ValueError(
                "Temporal features provided for history but missing future marks "
                "during recursive forecast"
            )
        window, marks = x, x_mark
        rates, disps = [], []
        for step in range(int(horizon)):
            rate, disp = self._apply(params, window, marks, static, ids, floor, row_valid)
            rates.append(rate[:, -1, :])
            disps.append(disp[:, -1, :])
            window = torch.cat([window[:, 1:, :], rate[:, -1:, :]], dim=1)
            if marks is not None:
                marks = torch.cat([marks[:, 1:, :], y_mark[:, step : step + 1, :]], dim=1)
        return torch.stack(rates, dim=1), torch.stack(disps, dim=1)

    # -- observability ---------------------------------------------------------

    @torch.inference_mode()
    def collect_period_telemetry(self, params, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """One deterministic forward that records each block's period selection.

        Returns ``{"blocks_i": {"periods", "valid", "group_count",
        "freq_indices"}}`` as the JAX package's does (numpy arrays, an int
        count); a frozen block gives its constants. ``params`` is a name ->
        tensor mapping or None for the model's own; ``batch`` holds the
        model's inputs (``x``, and ``x_mark``, ``static``, ``ids``, ``floor``
        where the model takes them) on the engine's device. Every recorded
        tensor comes to the host in one copy.
        """

        self.model.eval()
        blocks = [getattr(self.model, f"blocks_{i}") for i in range(self.cfg.n_layers)]
        for block in blocks:
            block.telemetry = {}
        try:
            self._apply(params, *(batch.get(k) for k in _ARGS))
            records = [block.telemetry for block in blocks]
        finally:
            for block in blocks:
                block.telemetry = None
        names = ("selected_periods", "period_valid", "group_count", "freq_indices")
        parts = [rec[n] for rec in records if rec for n in names]
        flat = (torch.cat([t.reshape(-1).to(device=self.device, dtype=torch.int64)
                           for t in parts]).cpu().numpy() if parts else None)
        out, at = {}, 0
        for i, rec in enumerate(records):
            if not rec:  # a block with no candidate records nothing, as in JAX
                continue
            values = []
            for n in names:
                size = rec[n].numel()
                values.append(flat[at:at + size])
                at += size
            periods, valid, count, freqs = values
            out[f"blocks_{i}"] = {
                "periods": periods.astype(np.int32), "valid": valid.astype(bool),
                "group_count": int(count[0]), "freq_indices": freqs.astype(np.int32),
            }
        return out

    @staticmethod
    def frozen_spec_from_telemetry(telemetry: Mapping[str, Any], n_layers: int):
        """Telemetry -> the per-layer frozen spec, or None when a layer's
        snapshot (or its ``freq_indices``) is missing.

        Each layer's ``(period, freq_bin, valid)`` slots take the canonical
        order of the JAX package: valid slots first, then sorted. The
        softmax weights sum over slots, so their order does not change the
        result, and a top-k swap of equal amplitudes is not drift.
        """

        layers = []
        for i in range(n_layers):
            info = telemetry.get(f"blocks_{i}")
            if not info or "freq_indices" not in info:
                return None
            slots = [(int(p), int(f), bool(v)) for p, f, v in
                     zip(info["periods"], info["freq_indices"], info["valid"])]
            slots.sort(key=lambda s: (not s[2], s[0], s[1]))
            layers.append(tuple(slots))
        return tuple(layers)

    @staticmethod
    def parse_freeze_mode(raw: Any) -> str:
        """``predict.freeze_periods`` as ``off``, ``auto`` or ``on``. YAML
        1.1 reads a bare ``on``/``off``/``yes``/``no`` as a boolean, so
        booleans map to their mode."""

        if isinstance(raw, bool):
            return "on" if raw else "off"
        mode = str(raw).strip().lower()
        if mode in ("off", "false", "0", "no", ""):
            return "off"
        if mode in ("on", "true", "1", "yes"):
            return "on"
        if mode == "auto":
            return "auto"
        raise ValueError(f"predict.freeze_periods must be off|auto|on, got '{raw}'")

    @staticmethod
    def frozen_spec_from_config(raw: Any, n_layers: int):
        """A stored ``train.frozen_periods_spec`` (nested lists) -> the
        per-layer spec that ``TimesNetConfig.frozen_periods`` takes.

        None when absent; ``ValueError`` on a malformed spec or one whose
        layer count is not the model's, so that a caller can fall back to
        the dynamic path rather than run a wrong one.
        """

        if not raw:
            return None
        try:
            layers = tuple(tuple((int(p), int(f), bool(v)) for p, f, v in layer)
                           for layer in raw)
        except (TypeError, ValueError) as err:
            raise ValueError(f"Malformed frozen_periods_spec: {err}") from err
        if len(layers) != int(n_layers):
            raise ValueError(f"frozen_periods_spec carries {len(layers)} layers but the "
                             f"model has n_layers={n_layers}")
        return layers

    # -- training ---------------------------------------------------------------

    def _bind(self, state: TrainState) -> None:
        """Make ``state.params`` the model's own parameters where they are
        another engine's: an engine on the frozen-period path continues a
        run of the dynamic one (or the other way round) on the same
        parameters, optimizer and EMA, as the JAX package's trainer swaps
        engines between epochs."""

        own = dict(self.model.named_parameters())
        if own.keys() != state.params.keys():
            raise ValueError("the TrainState's parameters are not this model's")
        for name, p in state.params.items():
            if own[name] is not p:
                module, _, leaf = name.rpartition(".")
                self.model.get_submodule(module)._parameters[leaf] = p
                self._graphs.clear()  # they hold the parameters they were captured on

    def init_state(self, params: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
        """Load ``params`` (if given) into the model and start a run on them:
        fresh Adam moments, a zero accumulator when accumulating and an EMA
        that starts at the parameters when ``ema_decay > 0``."""

        if params is not None:
            params = dict(params)
            if self.sharded and params[mesh.TABLE_NAME].shape[0] == self.cfg.id_vocab:
                params = mesh.shard_train_state(params, self.sharded)
            self.model.load_state_dict(params)
        named = dict(self.model.named_parameters())
        accum = None
        if self.accum_steps > 1:
            accum = {k: torch.zeros_like(p) for k, p in named.items()}
        ema = None
        if self.ema_decay > 0.0:
            ema = {k: p.detach().clone() for k, p in named.items()}
        optimizer = build_optimizer(named.values(), self.grad_clip_norm, self.weight_decay,
                                    [i for i, k in enumerate(named) if k in self.sharded])
        return TrainState(params=named, optimizer=optimizer, grad_accum=accum, ema=ema)

    def _loss(self, batch: Mapping[str, Any], generator: Optional[torch.Generator]):
        """Masked NB-NLL of the model on ``batch`` and the mask stats, as
        device tensors; dropout draws from ``generator`` in training mode.

        Under a group, ``batch`` is this rank's rows: the counts are summed
        over the ranks, the loss is this rank's sum over the global count (so
        the ranks' losses and gradients sum to the global batch's), and the
        stats are the global batch's."""

        rv = batch.get("row_valid")
        rate, dispersion = self.model(
            *(batch.get(k) for k in _ARGS), row_valid=rv, generator=generator
        )
        y = batch["y"]
        base = _base_mask(y, batch["mask"], rv, self.use_loss_masking)
        nbm = negative_binomial_mask(y, rate, dispersion, base)
        if rv is not None:
            # coverage over real rows only (padding adds row_valid=0 rows)
            total = rv.float().sum() * float(y.shape[1] * y.shape[2])
        else:
            total = torch.full((), float(y.numel()), device=y.device)
        if mesh.grouped():
            counts = mesh.all_sum_(torch.stack([nbm.sum().float(), total.detach().float()]))
            loss = negative_binomial_nll(y, rate, dispersion, nbm, count=counts[0])
            return loss, {"mask_true": counts[0], "mask_total": counts[1]}
        loss = negative_binomial_nll(y, rate, dispersion, nbm)
        return loss, {"mask_true": nbm.sum().float(), "mask_total": total}

    def _reduce(self, grads: List[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
        """Sum the gradients (a sharded table's excepted: each rank holds the
        whole gradient of its rows) and the loss over the group in one flat
        bucket, one ``all_reduce`` a step; the sums are copied back into
        ``grads`` (views of the bucket would start at other alignments,
        and the clip's norm would then sum in another order). Returns the
        summed loss."""

        keep = [grads[i] for i, (k, _) in enumerate(self.model.named_parameters())
                if k not in self.sharded]
        flat = mesh.all_sum_(torch.cat([g.reshape(-1) for g in keep]
                                       + [loss.detach().reshape(1)]))
        parts = torch.split(flat[:-1], [g.numel() for g in keep])
        torch._foreach_copy_(keep, [part.view_as(g) for part, g in zip(parts, keep)])
        return flat[-1]

    def _train_body(self, state: TrainState, generator: Optional[torch.Generator],
                    batch: Mapping[str, Any], do_update: bool = True):
        """One step on ``batch`` at the optimizer's learning rate: the body of
        ``train_step``, of its graph and of each resident step."""

        params = list(state.params.values())
        for p in params:
            p.grad = None
        with tracing.region("step.forward", self.device):
            loss, stats = self._loss(batch, generator)
        with tracing.region("step.backward", self.device):
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if mesh.grouped():
                loss = self._reduce(grads, loss)
        # debug_nans: the loss and each gradient, and each parameter after the
        # update (the step's outputs, as JAX's jax_debug_nans checks them)
        finite = ([torch.isfinite(loss).all()] + [torch.isfinite(g).all() for g in grads]
                  if self.debug_nans else None)
        if self.accum_steps > 1:
            accum = list(state.grad_accum.values())
            torch._foreach_add_(accum, grads, alpha=1.0 / self.accum_steps)
            if not do_update:
                return loss.detach(), _flagged(stats, finite, params)
            grads = [a.clone() for a in accum]
            torch._foreach_zero_(accum)
        with torch.no_grad(), tracing.region("step.optimizer", self.device):
            state.optimizer.step(grads)
            if state.ema is not None:
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, self.ema_decay)
                torch._foreach_add_(ema, params, alpha=1.0 - self.ema_decay)
        return loss.detach(), _flagged(stats, finite, params)

    def train_step(self, state: TrainState, lr: float, generator: Optional[torch.Generator],
                   batch: Mapping[str, Any], do_update: bool = True):
        """One gradient step on ``batch``: ``(state, loss, stats)``.

        With ``accumulation_steps > 1`` the gradient is added to the running
        mean and the update waits for ``do_update``. ``lr`` is this step's
        learning rate; ``generator`` (on the engine's device) drives dropout.
        The state is updated in place and returned. Under ``debug_nans`` the
        stats also hold ``finite`` (see :func:`first_non_finite`).

        On the card, without accumulation, the step replays one CUDA graph
        per ``(TrainState, generator, batch signature)``: the batch is
        copied into the graph's buffers, and the loss and stats come back as
        clones. Accumulation runs eagerly, as the JAX package's resident
        path refuses it.
        """

        self._bind(state)
        self.model.train()
        state.optimizer.set_lr(lr)
        if not self.cuda_graphs or self.accum_steps > 1:
            loss, stats = self._train_body(state, generator, batch, do_update)
            return state, loss, stats
        self._training_graphs(state)
        tensors = [batch.get(k) for k in _STEP_KEYS]
        key = self._key("step", id(generator), graphs.signature(tensors))
        graph = self._graph(key)
        if graph is None:
            bufs = graphs.static_copies(tensors)
            static_batch = dict(zip(_STEP_KEYS, bufs))

            graph = self._capture(key, lambda: self._train_body(state, generator, static_batch),
                                  inputs=bufs, state=state.tensors(), generators=(generator,),
                                  pins=(generator,))
            loss, stats = graph.replay()
        else:
            loss, stats = graph.replay(tensors)
        return state, loss.clone(), {k: v.clone() for k, v in stats.items()}

    # -- device-resident epoch (gather inside the step) --------------------------

    def gather_staged_batch(self, staged: StagedWindows, flat_idx, row_valid) -> Dict[str, Any]:
        """One batch gathered from the staged arrays (a probe, an init
        batch): the clean windows (:func:`strip_augment`), with ``y_mark``
        in recursive mode."""

        return gather_batch(strip_augment(staged), self._on_device(flat_idx, torch.int32),
                            self._on_device(row_valid, torch.float32),
                            with_y_mark=self.cfg.mode != "direct")

    def collect_period_telemetry_staged(self, params, staged: StagedWindows, flat_idx,
                                        row_valid) -> Dict[str, Any]:
        """:meth:`collect_period_telemetry` of the batch that ``flat_idx``
        and ``row_valid`` [B] gather from ``staged``: the resident trainer's
        probe, run eagerly on a fixed batch and read back once. Under a
        group ``flat_idx`` is the global batch's row and each rank gathers
        its own rows of it."""

        rows = mesh.rank_rows(len(flat_idx)) if mesh.world() > 1 else slice(None)
        return self.collect_period_telemetry(
            params, self.gather_staged_batch(staged, flat_idx[rows], row_valid[rows]))

    def _on_device(self, a, dtype) -> torch.Tensor:
        """A plan (numpy or a tensor) as ``dtype`` on the engine's device."""

        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _resident_buffers(self, rows: int, B: int, sums: bool) -> Dict[str, torch.Tensor]:
        """A plan buffer [rows, B] (indices and row_valid), the step counter
        and either the per-step outputs (training; under ``debug_nans`` also
        the last step's finiteness flags) or the six sums (eval)."""

        dev = self.device
        out = {"idx": torch.zeros((rows, B), dtype=torch.int32, device=dev),
               "rv": torch.zeros((rows, B), dtype=torch.float32, device=dev),
               "counter": torch.zeros((1,), dtype=torch.int64, device=dev)}
        if sums:
            out["sums"] = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(4)] + [
                torch.zeros(self.num_series, dtype=torch.float32, device=dev) for _ in range(2)]
        else:
            out["losses"] = torch.zeros(rows, dtype=torch.float32, device=dev)
            out["mask_true"] = torch.zeros(rows, dtype=torch.float32, device=dev)
            if self.debug_nans:
                out["finite"] = torch.ones(1 + 2 * len(list(self.model.parameters())),
                                           dtype=torch.bool, device=dev)
        return out

    def _plan_row(self, buf: Dict[str, torch.Tensor]):
        """Row ``counter`` of the plan buffer, read on the device."""

        counter = buf["counter"]
        return (torch.index_select(buf["idx"], 0, counter)[0],
                torch.index_select(buf["rv"], 0, counter)[0])

    def _resident(self, key: tuple, S: int, B: int, sums: bool, make_body, *,
                  state=(), generators=(), pins=()):
        """The buffers and the step function of a resident pass of ``S``
        steps of ``B`` rows: on the card a graph (captured under ``key``,
        anew where its plan buffer is shorter than ``S``; the buffers are its
        first pin) whose replay is one step; on the CPU the body itself, on
        buffers of ``S`` rows. ``state``/``generators``/``pins`` are
        :func:`graphs.capture`'s."""

        if not self.cuda_graphs:
            buf = self._resident_buffers(S, B, sums)
            return buf, make_body(buf)
        graph = self._graph(key)
        if graph is None or graph.pins[0]["idx"].shape[0] < S:
            buf = self._resident_buffers(max(RESIDENT_PLAN_ROWS, S), B, sums)
            outputs = buf["sums"] if sums else [buf[k] for k in ("losses", "mask_true", "finite")
                                                if k in buf]
            graph = self._capture(key, make_body(buf), state=[buf["counter"], *outputs, *state],
                                  generators=generators, pins=(buf, *pins))
        return graph.pins[0], graph.replay

    def train_epoch_resident(self, state: TrainState, lr: float,
                             generator: Optional[torch.Generator], staged: StagedWindows, idx,
                             row_valid, step_offset: int = 0, on_step=None):
        """One epoch's steps (or one chunk of them) over device-resident
        data: ``(state, losses [S], mask_true [S])``, as device tensors that
        the caller fetches once.

        ``idx``/``row_valid`` are an [S, B] plan from
        :func:`~flow_timesnet_tpu_torch.data.device_windows.epoch_index_plan`
        (numpy or tensors). It is copied once into a device buffer; each
        step then reads its row on the device, gathers the batch
        (:func:`gather_batch`), takes :meth:`train_step`'s step, writes its
        loss and ``mask_true`` at its row and counts on: on the card one
        graph replay a step, with no host work between steps. Under a group
        the plan is the global one, ``[S, dp_batch_rows]``, and each rank
        takes its columns (the losses and counts are the global batch's,
        as :meth:`_loss` sums them). The staged
        windows' augmentation and dropout draw from ``generator``, in that
        order, and every step advances it, so chunked calls give what one
        call gives (the JAX package needs ``step_offset``, the chunk's first
        step, to derive per-step keys; here it only numbers the steps).
        ``on_step(step, finite)``, where given (it needs ``debug_nans``), is
        called after each step with its number in the epoch (from 1) and its
        finiteness flags, and may raise. Requires ``accumulation_steps ==
        1``.
        """

        if self.accum_steps != 1:
            raise ValueError("device-resident training requires accumulation_steps == 1")
        self._bind(state)
        self.model.train()
        state.optimizer.set_lr(lr)
        idx_t = self._on_device(mesh.plan_columns(idx), torch.int32)
        rv_t = self._on_device(mesh.plan_columns(row_valid), torch.float32)
        S, B = (int(n) for n in idx_t.shape)
        if on_step is not None and not self.debug_nans:
            raise ValueError("on_step reads the finiteness flags of an engine with debug_nans")
        if self.cuda_graphs:
            self._training_graphs(state)

        def make_body(buf):
            def body():
                with tracing.region("step.gather", self.device):
                    flat, rv = self._plan_row(buf)
                    batch = gather_batch(staged, flat, rv, generator=generator)
                loss, stats = self._train_body(state, generator, batch)
                with torch.no_grad():
                    buf["losses"].index_copy_(0, buf["counter"], loss.reshape(1))
                    buf["mask_true"].index_copy_(0, buf["counter"], stats["mask_true"].reshape(1))
                    if self.debug_nans:
                        buf["finite"].copy_(stats["finite"])
                    buf["counter"].add_(1)
            return body

        with tracing.span("train.chunk"):
            buf, step = self._resident(self._key("epoch", id(generator), id(staged), B), S, B,
                                       False, make_body, state=state.tensors(),
                                       generators=(generator,), pins=(generator, staged))
            buf["idx"][:S].copy_(idx_t)
            buf["rv"][:S].copy_(rv_t)
            buf["counter"].zero_()
            for k in range(S):
                with tracing.span("engine.replay"):
                    step()
                if on_step is not None:
                    on_step(step_offset + k + 1, buf["finite"])
            return state, buf["losses"][:S].clone(), buf["mask_true"][:S].clone()

    # -- evaluation ---------------------------------------------------------------

    def eval_step(self, params, batch: Mapping[str, Any]):
        """Streaming sums of one batch: ``(nll * count, count, smape_sum,
        smape_count, series_sums[N], series_counts[N])`` as device tensors."""

        y = batch["y"]
        args = [batch.get(k) for k in _ARGS]
        rv = batch.get("row_valid")
        if self.cfg.mode == "direct":
            rate, dispersion = self._apply(params, *args, rv)
        else:
            x, x_mark, static, ids, floor = args
            rate, dispersion = self._rollout(params, x, int(y.shape[1]), x_mark,
                                             batch.get("y_mark"), static, ids, floor, rv)
        rate = rate[:, : y.shape[1], :]
        dispersion = dispersion[:, : y.shape[1], :]
        base = _base_mask(y, batch["mask"], rv, self.use_loss_masking)
        nbm = negative_binomial_mask(y, rate, dispersion, base)
        nb_loss = negative_binomial_nll(y, rate, dispersion, nbm)
        # an all-masked batch contributes (0, 0)
        denom = nbm.float().sum()
        maskf = nbm.to(y.dtype)
        y_eval, rate_eval = y * maskf, rate * maskf
        smape_s, smape_c = smape_batch_sums(y_eval, rate_eval)
        if batch.get("ids") is not None:
            sid = batch["ids"]
        else:
            sid = torch.arange(y.shape[2], device=y.device)[None].expand(y.shape[0], y.shape[2])
        ws_sums, ws_cnts = wsmape_batch_sums(y_eval, rate_eval, sid, self.num_series)
        return nb_loss * denom, denom, smape_s, smape_c, ws_sums, ws_cnts

    @torch.inference_mode()
    def evaluate(self, params, batches: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
        """Stream eval metrics of ``params`` (a name -> tensor mapping such as
        ``state.ema``, or None for the model's own) over device-ready
        batches: the sums stay on the device and are read once at the end.
        Under a group each rank streams its rows of the same batches, and
        the sums are summed over the ranks before the metrics are formed."""

        self.model.eval()
        totals = None
        for batch in batches:
            out = self.eval_step(params, batch)
            totals = out if totals is None else tuple(a + b for a, b in zip(totals, out))
        return self._metrics(totals)

    def _metrics(self, totals) -> Dict[str, Any]:
        """The pass's metrics from its six sums, read in one copy."""

        if totals is None:
            # an empty eval stream must not masquerade as a perfect score
            return {
                "nll": float("inf"),
                "smape": float("inf"),
                "series_sums": np.zeros(self.num_series, np.float32),
                "series_cnts": np.zeros(self.num_series, np.float32),
            }
        # one copy to the host for the whole pass, after one sum over the group
        flat = mesh.all_sum_(torch.cat([t.reshape(-1).float() for t in totals])).cpu().numpy()
        nll_num, nll_den, s_sum, s_cnt = flat[:4]
        return {
            "nll": _safe_ratio(nll_num, nll_den),
            "smape": _safe_ratio(s_sum, s_cnt),
            "series_sums": flat[4 : 4 + self.num_series],
            "series_cnts": flat[4 + self.num_series :],
        }

    def evaluate_resident(self, params, staged: StagedWindows, idx, row_valid,
                          max_dispatch_steps: int = 0) -> Dict[str, Any]:
        """:meth:`evaluate` over a plan of the staged arrays' clean windows
        (:func:`strip_augment`): ``idx`` and ``row_valid`` [S, B] (numpy or
        tensors), ``params`` as there (the trainer passes ``state.ema``).

        Each batch is gathered on the device and its six sums are added to
        device accumulators (on the card one graph replay a batch), which
        are read once at the end. ``max_dispatch_steps`` > 0 copies the plan
        into the device buffer that many rows at a time; the sums carry
        over, so chunks compose by addition.
        """

        self.model.eval()
        idx_t = self._on_device(mesh.plan_columns(idx), torch.int32)
        rv_t = self._on_device(mesh.plan_columns(row_valid), torch.float32)
        S, B = (int(n) for n in idx_t.shape)
        if S == 0:
            return self._metrics(None)
        chunk = min(S, int(max_dispatch_steps)) if max_dispatch_steps else S
        pinned = tuple(params.values()) if params is not None else ()
        clean = strip_augment(staged)

        def make_body(buf):
            def body():
                with torch.no_grad():
                    flat, rv = self._plan_row(buf)
                    batch = gather_batch(clean, flat, rv, with_y_mark=self.cfg.mode != "direct")
                    for acc, v in zip(buf["sums"], self.eval_step(params, batch)):
                        acc.add_(v)
                    buf["counter"].add_(1)
            return body

        key = self._key("eval", id(staged), B, tuple(id(t) for t in pinned))
        buf, step = self._resident(key, chunk, B, True, make_body, pins=(staged, clean, pinned))
        for acc in buf["sums"]:
            acc.zero_()
        for start in range(0, S, chunk):
            n = min(chunk, S - start)
            buf["idx"][:n].copy_(idx_t[start:start + n])
            buf["rv"][:n].copy_(rv_t[start:start + n])
            buf["counter"].zero_()
            for _ in range(n):
                step()
        return self._metrics(buf["sums"])


def batch_to_device(batch, floor=None, device="cuda") -> Dict[str, Any]:
    """WindowBatch -> dict of tensors on ``device`` (None-preserving); float
    fields in float32, series ids in int32."""

    def put(a, dtype):
        return None if a is None else torch.from_numpy(np.asarray(a, dtype)).to(device)

    return {
        "x": put(batch.x, np.float32),
        "y": put(batch.y, np.float32),
        "mask": put(batch.mask, np.float32),
        "row_valid": put(batch.row_valid, np.float32),
        "x_mark": put(batch.x_mark, np.float32),
        "y_mark": put(batch.y_mark, np.float32),
        "static": put(batch.static, np.float32),
        "ids": put(batch.series_ids, np.int32),
        "floor": put(floor, np.float32),
    }
