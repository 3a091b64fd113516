"""A serving cell: ``Forecaster.forecast`` in a closed loop with one caller.

Set-up builds one ``Forecaster`` over every series of the configuration,
with seeded weights, and serves one request (warm-up and graph capture,
timed as ``capture_s``) and a few more. Each request asks for ``pred_len``
steps of every series from the ``input_len`` steps before a cut drawn from
the seed, with their stamps; the next request is sent when the last
returns. A request is timed from the call until its numpy result is on
the host. After the window a seeded sample of the requests it served is
forecast again by the reference, from the same raw history and stamps.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from portbench.harness import data as hdata
from portbench.harness import program, trace
from portbench.harness.fold_bound import PEAK_OPS_PER_S, bound
from portbench.reference import inputs
from portbench.reference import timesnet as rnet

WARM_REQUESTS = 5
# what a serving mix sets: the cuts drawn (the requests cycle over them),
# the served requests the check forecasts again, the requests of the
# profiled span, the request and forward pairs of ``host_ms.serve``
TRAFFIC_KEYS = ("cuts", "checked_requests", "traced_requests", "host_pairs")


class Cell:
    def __init__(self, run) -> None:
        self.run = run
        cfg = run.config
        self.model = cfg["model"]
        self.L, self.H = int(self.model["input_len"]), int(self.model["pred_len"])
        self.ds = hdata.dataset(cfg)
        self.tn = program.model_config(cfg, self.ds)
        self.params = program.weights(self.tn, self.model, run.seed, run.device)
        ds = self.ds
        scaler = (None if ds.mean is None else
                  {sid: (float(m), float(s)) for sid, m, s in zip(ds.ids, ds.mean, ds.std)})
        self.fc = program.Forecaster(
            self.params, self.tn, ds.ids, scaler, "zscore" if scaler else "none", ds.static,
            ds.floors, {"enabled": True, "features": ds.features, "encoding": "cyclical",
                        "normalize": True}, freq=ds.freq, device=run.device)
        self.cuts = hdata.cuts(ds, self.L, int(run.traffic["cuts"]), run.seed)
        self.sent = 0
        self.served: List[tuple] = []  # (cut, forecast) of each request in the window

    def request(self):
        """The next request: ``(cut, history, stamps)``."""

        c = int(self.cuts[self.sent % len(self.cuts)])
        self.sent += 1
        return c, self.ds.values[c - self.L:c], self.ds.stamps[c - self.L:c]

    def setup(self) -> None:
        run = self.run
        _, hist, stamps = self.request()
        t0 = time.perf_counter()
        self.fc.forecast(hist, dates=stamps)
        run.sync()
        run.ctx["capture_s"] = time.perf_counter() - t0
        for _ in range(WARM_REQUESTS):
            _, hist, stamps = self.request()
            self.fc.forecast(hist, dates=stamps)

    def window(self, seconds: float) -> None:
        run = self.run
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            c, hist, stamps = self.request()
            t = time.perf_counter()
            out = self.fc.forecast(hist, dates=stamps)
            lat.append(time.perf_counter() - t)
            self.served.append((c, out))
        elapsed = time.perf_counter() - t0
        lat = np.asarray(lat)
        bad = sum(1 for _, out in self.served if not np.isfinite(out).all())
        run.ctx.update(latencies_s=lat, window_s=elapsed, requests=len(lat),
                       request_mean_s=elapsed / len(lat))
        run.attempted, run.failed = len(lat), bad

    def traced(self) -> None:
        """A profiled span of ``traced_requests`` requests (taken again over
        half as many where the fold-conv records fall short of the kernels'
        own count), each request's fold-conv least time at the periods it
        selects, and the host's share: request minus forward on the same
        prepared inputs, in interleaved pairs."""

        run, torch = self.run, self.run.torch
        want = int(run.traffic["traced_requests"])
        for _ in range(trace.TRIES):
            reqs = [self.request() for _ in range(want)]
            program.clear_runs()
            tr = trace.record(torch, lambda: [self.fc.forecast(h, dates=s) for _, h, s in reqs])
            run.ctx.update(trace=tr, trace_ok=tr.matching("tap_conv", "reduce")[0]
                           == program.runs_total() > 0)
            if run.ctx["trace_ok"]:
                break
            want = max(1, want // 2)
        if run.ctx["trace_ok"]:
            run.ctx["traced_units"] = len(reqs)
            run.ctx["fold_device_s"] = tr.matching("tap_conv")[1]
            least = 0.0
            n = len(self.ds.ids)
            for _, h, s in reqs:
                x, x_mark, static, ids, floor = program.request_batch(self.fc, h, s)
                tele = self.fc.engine.collect_period_telemetry(
                    None, {"x": x, "x_mark": x_mark, "static": static, "ids": ids,
                           "floor": floor})
                for i in range(int(self.model["n_layers"])):
                    periods = [int(p) for p in tele[f"blocks_{i}"]["periods"]]
                    for kh, kw in self.model["kernel_set"]:
                        least += 2 * 1e-3 * bound(periods, kh, kw, self.tn.compute_dtype, n,
                                                  "fwd", 2 * self.L - 1, self.L,
                                                  program.mid(self.tn))[0]
            run.ctx["fold_least_s"] = least
        run.ctx["flops_per_unit"] = program.forward_flops(run.config, self.ds, len(self.ds.ids))
        run.ctx["peak_flops"] = PEAK_OPS_PER_S[self.tn.compute_dtype]

        _, h, s = self.request()
        args = program.request_batch(self.fc, h, s)
        req, fwd = [], []
        for _ in range(int(run.traffic["host_pairs"])):
            t = time.perf_counter()
            self.fc.forecast(h, dates=s)
            req.append(time.perf_counter() - t)
            t = time.perf_counter()
            self.fc.engine.forward(*args)
            run.sync()
            fwd.append(time.perf_counter() - t)
        run.ctx["host_s"] = float(np.median(req) - np.median(fwd))

    def check(self) -> None:
        """A seeded sample of the served requests, forecast again by the
        reference; the widest gap."""

        run = self.run
        rng = np.random.default_rng([run.seed, 2])
        n = min(int(run.traffic["checked_requests"]), len(self.served))
        picked = [self.served[i] for i in sorted(rng.choice(len(self.served), n, replace=False))]
        params = {k: v.detach().clone() for k, v in self.params.items()}
        self.fc = self.params = None
        run.release()
        run.judge({"forecast_gap": forecast_gap(run, self.ds, params, picked,
                                                self.model["compute_dtype"])})


def reference_forecasts(run, ds, params, cut: int, rounding: str, ties: bool = True) -> list:
    """The reference's forecast [pred_len, N] in data units from the raw
    history before ``cut`` and its stamps: one for each way of resolving
    the selector's near-ties (with ``ties`` off, the one by score alone)."""

    torch, model = run.torch, run.config["model"]
    L, H = int(model["input_len"]), int(model["pred_len"])
    hist = ds.values[cut - L:cut]
    if ds.mean is not None:
        hist = inputs.zscore(hist, ds.mean, ds.std)
    marks = inputs.calendar(ds.stamps[cut - L:cut], ds.features)
    n = hist.shape[1]

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(run.device, dtype)

    args = (put(hist.T[:, :, None]), put(np.broadcast_to(marks, (n,) + marks.shape)),
            put(ds.static[:, None, :]), put(np.arange(n)[:, None], torch.int64),
            put(ds.floors[:, None, None]))

    def forecast(tie):
        with torch.no_grad():
            rate, _ = rnet.forward(params, model, *args, None, rnet.Rounding(rounding), None, tie)
        out = rate[:, :H, 0].T.cpu().numpy()
        if ds.mean is not None:
            out = inputs.unscale(out, ds.mean, ds.std)
        return np.clip(out, 0.0, None)

    if not ties:
        return [forecast(None)]
    return rnet.tie_branches(forecast, rnet.Ties.TOL[rounding])


def forecast_gap(run, ds, params, picked, rounding: str) -> float:
    """The widest gap of the served forecasts from the reference's, in data
    units against the larger of the reference's value and 1; each request
    against the reference's forecast closest to it where the selector was
    tied."""

    worst = 0.0
    for cut, got in picked:
        gaps = [float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))
                for want in reference_forecasts(run, ds, params, cut, rounding)]
        worst = max(worst, min(gaps))
    return worst
