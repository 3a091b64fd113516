"""A training cell: ``Engine.train_epoch_resident`` over folds staged once.

Set-up builds one engine and one ``TrainState`` from the seed, stages the
configuration's training fold and drives the first three steps through the
window's own call (the first captures its CUDA graph), keeping what the
check needs: the starting parameters, each step's loss, the Adam moments
after step 1 and the parameters (and EMA) after step 3. It then warms one
chunk. The window feeds the same object chunks of a seeded epoch plan
until ``--seconds`` have passed, each chunk ending in a synchronise. After
the window the reference follows the first three steps from the same
inputs, and each compared number is held to its limit.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from portbench.harness import data as hdata
from portbench.harness import program, trace
from portbench.harness.fold_bound import PEAK_OPS_PER_S, bound
from portbench.reference import inputs
from portbench.reference import timesnet as rnet
from portbench.reference import train as rtrain

BETA1 = 0.9  # AdamW's first-moment decay: after step 1 its moment is (1 - b1) g
# what a training mix sets: the steps of a call in the window, the steps
# the check follows, the steps of the profiled span
TRAFFIC_KEYS = ("chunk_steps", "checked_steps", "traced_steps")


def _clone(tensors: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach().clone() for k, v in tensors.items()}


class Cell:
    def __init__(self, run) -> None:
        self.run = run
        torch = run.torch
        cfg = run.config
        self.model, self.train = cfg["model"], cfg["train"]
        self.L, self.H = int(self.model["input_len"]), int(self.model["pred_len"])
        self.B = int(self.train["batch_size"])
        self.ds = hdata.dataset(cfg)
        self.X, self.M, self.marks = hdata.training_fold(self.ds)
        run.mark("data")
        self.tn = program.model_config(cfg, self.ds)
        self.params = program.weights(self.tn, self.model, run.seed, run.device)
        run.mark("weights")
        self.engine = program.Engine(
            self.tn, self.params, run.device,
            use_loss_masking=bool(self.train["use_loss_masking"]),
            grad_clip_norm=float(self.train["grad_clip_norm"]),
            weight_decay=float(self.train["weight_decay"]),
            num_series=self.X.shape[1], ema_decay=float(self.train["ema_decay"]))
        self.state = self.engine.init_state()
        run.mark("engine")
        self.gen_seed = (int(run.seed) * 7919 + 1) % (2 ** 63)
        self.gen = torch.Generator(device=run.device).manual_seed(self.gen_seed)
        self.staged = program.stage(self.X, self.M, self.marks, self.ds, self.L, self.H,
                                    run.device)
        total = hdata.windows_total(self.ds, self.L, self.H)
        self.plan = hdata.Plan(total, self.B, run.seed)
        self.lr = float(self.train["lr"])

    def call(self, rows: np.ndarray):
        """The timed entry on ``rows`` [S, B] of the plan: ``losses`` [S]."""

        rv = np.ones(rows.shape, np.float32)
        self.state, losses, _ = self.engine.train_epoch_resident(
            self.state, self.lr, self.gen, self.staged, rows, rv)
        return losses

    def setup(self) -> None:
        run, torch = self.run, self.run.torch
        n = int(run.traffic["checked_steps"])
        self.checked_rows = self.plan.take(n)
        t0 = time.perf_counter()
        first = self.call(self.checked_rows[:1])
        run.sync()
        run.ctx["capture_s"] = time.perf_counter() - t0
        opt = self.state.optimizer.adamw.state
        self.moment1 = {k: opt[p]["exp_avg"].detach().clone()
                        for k, p in self.state.params.items()}
        rest = self.call(self.checked_rows[1:])
        self.checked_losses = torch.cat([first, rest]).float().cpu().numpy()
        self.after = _clone(self.state.params)
        self.ema_after = _clone(self.state.ema) if self.state.ema is not None else None
        self.chunk = int(run.traffic["chunk_steps"])
        self.call(self.plan.take(self.chunk))  # the window's chunk shape, warmed
        run.sync()

    def window(self, seconds: float) -> None:
        run = self.run
        losses = []
        t0 = time.perf_counter()
        while True:
            losses.append(self.call(self.plan.take(self.chunk)))
            run.sync()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        steps = len(losses) * self.chunk
        bad = int((~run.torch.isfinite(run.torch.cat(losses))).sum())
        run.ctx.update(train_windows=steps * self.B, window_s=elapsed, steps=steps,
                       step_s=elapsed / steps)
        run.attempted, run.failed = steps, bad

    def traced(self) -> None:
        """A profiled span of ``traced_steps`` steps, taken again over half
        as many where its fold-conv records fall short of the kernels' own
        count, and each traced step's fold-conv least time at the periods
        its batch selects."""

        run, torch = self.run, self.run.torch
        want = int(run.traffic["traced_steps"])
        for _ in range(trace.TRIES):
            rows = self.plan.take(want)
            program.clear_runs()
            tr = trace.record(torch, lambda: self.call(rows))
            run.ctx.update(trace=tr, trace_ok=tr.matching("tap_conv", "reduce")[0]
                           == program.runs_total() > 0)
            if run.ctx["trace_ok"]:
                break
            want = max(1, want // 2)
        run.ctx["flops_per_unit"] = program.step_flops(run.config, self.ds, self.B)
        run.ctx["peak_flops"] = PEAK_OPS_PER_S[self.tn.compute_dtype]
        if not run.ctx["trace_ok"]:
            return
        run.ctx["traced_units"] = len(rows)
        run.ctx["fold_device_s"] = tr.matching("tap_conv")[1]
        least = 0.0
        remat = 2 if self.tn.use_checkpoint else 1
        for row in rows:
            tele = self.engine.collect_period_telemetry_staged(
                None, self.staged, row, np.ones(len(row), np.float32))
            for i in range(int(self.model["n_layers"])):
                periods = [int(p) for p in tele[f"blocks_{i}"]["periods"]]
                for kh, kw in self.model["kernel_set"]:
                    for kind, times in (("fwd", remat), ("dh", 1), ("dw", 1)):
                        least += 2 * times * 1e-3 * bound(
                            periods, kh, kw, self.tn.compute_dtype, self.B, kind,
                            2 * self.L - 1, self.L, program.mid(self.tn))[0]
        run.ctx["fold_least_s"] = least

    def check(self) -> None:
        """The reference follows the first three steps; each number's gap."""

        run, torch = self.run, self.run.torch
        program_state = {
            "losses": self.checked_losses,
            "grad1": {k: v / (1.0 - BETA1) for k, v in self.moment1.items()},
            "change": {k: self.after[k] - self.params[k] for k in self.after},
            "ema_change": ({k: self.ema_after[k] - self.params[k] for k in self.ema_after}
                           if self.ema_after is not None else None),
        }
        program_state = {k: ({n: float(torch.linalg.vector_norm(t.double()))
                              for n, t in v.items()} if isinstance(v, dict) else v)
                         for k, v in program_state.items()}
        start = self.params
        for name in ("engine", "state", "staged", "moment1", "after", "ema_after", "params"):
            setattr(self, name, None)
        run.release()
        run.judge(compare(run, start, self.checked_rows, program_state, self.gen_seed))


def reference_batches(run, rows: np.ndarray) -> List[Dict[str, Any]]:
    """The reference's own windows of the plan's rows, on the run's device."""

    torch, cfg = run.torch, run.config
    ds = hdata.dataset(cfg)
    X, M, marks = hdata.training_fold(ds)
    L, H = int(cfg["model"]["input_len"]), int(cfg["model"]["pred_len"])
    out = []
    for row in rows:
        w = inputs.windows(row, X, M, marks, L, H)
        s = w["series"]

        def put(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a)).to(run.device, dtype)

        out.append({"x": put(w["x"]), "y": put(w["y"]), "mask": put(w["mask"]),
                    "x_mark": put(w["x_mark"]),
                    "static": put(ds.static[s][:, None, :]),
                    "ids": put(s[:, None], torch.int64), "floor": put(ds.floors[s][:, None, None]),
                    "row_valid": put(np.ones(len(s)))})
    return out


def reference_states(run, start, rows, gen_seed: int, rounding: str,
                     ties: bool = True) -> List[Dict[str, Any]]:
    """The reference's three steps from ``start``: losses, first clipped
    gradient, change after the last step (and the EMA's), as leaf norms;
    one state for each way of resolving the selector's near-ties over the
    three steps (``rtrain``'s ``Ties``), or with ``ties`` off the one by
    score alone."""

    torch = run.torch
    batches = reference_batches(run, rows)

    def follow(tie):
        trainer = rtrain.Trainer(start, run.config["model"], run.config["train"], rounding)
        gen = torch.Generator(device=run.device).manual_seed(gen_seed)
        losses, grad1 = [], None
        for batch in batches:
            loss, grads = trainer.step(batch, gen, tie)
            losses.append(float(loss))
            grad1 = grad1 if grad1 is not None else rtrain.leaf_norms(grads)
        change = rtrain.leaf_norms({k: trainer.p[k] - start[k] for k in start})
        ema = (rtrain.leaf_norms({k: trainer.ema[k] - start[k] for k in start})
               if trainer.ema is not None else None)
        return {"losses": np.asarray(losses), "grad1": grad1, "change": change,
                "ema_change": ema}

    if not ties:
        return [follow(None)]
    return rnet.tie_branches(follow, rnet.Ties.TOL[rounding])


def closest(got: Dict[str, Any], wants: List[Dict[str, Any]], limits: Dict[str, float]):
    """The reference state whose readings lie furthest inside ``limits``:
    where the selector was tied, the program may have taken either bin."""

    def worst(want):
        r = readings(got, want)
        return max(r[k] / limits[k] for k in r if k in limits)

    return min(wants, key=worst)


def readings(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """Each compared number: the relative gap of the first step's loss (the
    later steps' losses swing with Adam's first update, see PERF.md); the
    gap of the first gradient's norm and of the change after the checked
    steps, by the worst leaf and by the median leaf (the worst swings with
    one small leaf's rounding), and of the EMA's change by the worst leaf.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the changes."""

    return {k: (v[0] if isinstance(v, tuple) else v)
            for k, v in readings_by_leaf(got, want).items()}


def readings_by_leaf(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, tuple]:
    """:func:`readings`, the worst-leaf ones with the leaf (the loss with the
    steps' gaps) that gives them."""

    quiet = rtrain.quiet_leaves(want["grad1"])
    gaps = np.abs(got["losses"] - want["losses"]) / np.abs(want["losses"])
    out = {"loss_gap": (float(gaps[0]), "steps " + " ".join(f"{g:.3e}" for g in gaps)),
           "grad_gap": rtrain.worst_leaf_gap(got["grad1"], want["grad1"]),
           "grad_median_gap": rtrain.median_leaf_gap(got["grad1"], want["grad1"]),
           "change_gap": rtrain.worst_leaf_gap(got["change"], want["change"], quiet),
           "change_median_gap": rtrain.median_leaf_gap(got["change"], want["change"], quiet)}
    if want["ema_change"] is not None:
        out["ema_gap"] = rtrain.worst_leaf_gap(got["ema_change"], want["ema_change"], quiet)
    return out


def compare(run, start, rows, program_state, gen_seed: int) -> Dict[str, float]:
    wants = reference_states(run, start, rows, gen_seed, run.config["model"]["compute_dtype"])
    want = closest(program_state, wants, run.limits)
    run.ctx["tie_branches"] = len(wants)
    run.ctx["leaves"] = {k: v[1] for k, v in readings_by_leaf(program_state, want).items()
                         if isinstance(v, tuple)}
    run.ctx["quiet_leaves"] = rtrain.quiet_leaves(want["grad1"])
    return readings(program_state, want)

