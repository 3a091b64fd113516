#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of flow-timesnet-tpu on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card, ``nvcc`` and
PyTorch built for CUDA (no JAX is needed or imported):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: versions and the card's name and power limit;
2. build: every CUDA source of the port, one ``nvcc`` each, all at once;
3. kernels: the fold-conv kernel against its plain PyTorch version on the
   card at the serving shape (K=2 candidates, B=192 series, L=28, Lp=55,
   32 channels) for 3x3, 5x5 and 7x7, three period sets and bf16 and
   float32, within 1e-4;
4. serve: a ``Forecaster`` at the full width of the flagship model
   (``configs/demand_benchmark.yaml``: d_model 128, d_ff 512, two layers,
   2,536,356 parameters, bf16 conv islands) with seeded random weights
   answers 200 timed requests of 192 series x 28 days; the kernel must be
   launched 12 times per request, the forecasts must be finite and >= 0,
   and a float32 request must match the same request on the CPU within 1e-4.
   Then 200 requests interleaved with 200 forwards on the request's own
   device inputs split the request into host and forward;
5. profile: device time per request by kernel (torch.profiler, 50
   requests) against the request's p50, which gives the device's busy and
   idle share;
6. timing: each kernel at the periods the served requests selected, beside
   its plain version, a cuDNN convolution over the exact fold grids (a
   yardstick the port never calls) and its bound on the card.

The last lines are the ``kernels`` JSON line, the card line of ``nvidia-smi``
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = REPO / "flow_timesnet_tpu_torch"

# H100 SXM data-sheet peaks (dense): the bounds below use them.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

L, LP, C, K, B = 28, 55, 32, 2, 192  # the fold conv's serving shape (Lp = L + L - 1)
KERNEL_SIZES = ((3, 3), (5, 5), (7, 7))
PERIOD_SETS = ((7, 14), (4, 27), (1, 27))
TOL = 1e-4
REQUESTS = 200  # timed requests per serving measurement (about 12 ms each)
PROFILED = 50  # requests under the profiler
LAUNCHES_PER_REQUEST = 12  # 2 layers x 2 inception blocks x 3 branches
REPLACES = "flow_timesnet_tpu/ops/pallas_fold.py:174"
SOURCE = "flow_timesnet_tpu_torch/csrc/tap_conv_fwd.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def flagship_config(timesnet):
    """The ``model:`` block of configs/demand_benchmark.yaml, with the data
    dimensions of its 192-series benchmark (5 static features, 8 cyclical
    calendar features)."""

    return timesnet.TimesNetConfig(
        input_len=28, pred_len=7, d_model=128, d_ff=512, n_layers=2, k_periods=2,
        kernel_set=KERNEL_SIZES, dropout=0.0675, activation="gelu", mode="direct",
        bottleneck_ratio=4.0, min_period_threshold=7, use_embedding_norm=True,
        id_embed_dim=32, static_dim=5, static_proj_dim=32, static_layernorm=True,
        use_zero_mean_context=True, context_rank=8, context_scale=0.05,
        use_constant_context_bias=False, time_features=8, id_vocab=B,
        compute_dtype="bfloat16",
    )


def spread(np, values) -> str:
    """p50 with the p10-p90 range and the extremes, to 3 decimals."""

    p10, p50, p90 = np.percentile(values, [10, 50, 90])
    return (f"p50 {p50:.3f} (p10 {p10:.3f}, p90 {p90:.3f}, "
            f"min {np.min(values):.3f}, max {np.max(values):.3f}; n={len(values)})")


def time_ms(torch, fn, iters: int = 100) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls
    after a warm-up (inputs stay in L2, as they do between the model's ops)."""

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def valid_taps(periods, kh: int, kw: int) -> int:
    """(output row, tap) pairs inside the fold grid, over the K candidates."""

    total = 0
    for p in periods:
        cycles = -(-L // p)
        for t in range(LP):
            row, col = divmod(t, p)
            total += sum(
                1 for dc in range(-(kh // 2), kh // 2 + 1) if 0 <= row + dc < cycles
            ) * sum(1 for dj in range(-(kw // 2), kw // 2 + 1) if 0 <= col + dj < p)
    return total


def bound(periods, kh: int, kw: int, dtype: str):
    """Least time for one call on an H100 SXM: each input read once and the
    output written once over the memory rate, against the multiply-adds of
    the taps that these periods leave inside the grid over the peak rate of
    the input type. Returns (ms, bound_by, ms counting all kh*kw taps)."""

    elt = 2 if dtype == "bfloat16" else 4
    nbytes = K * B * LP * C * elt + kh * kw * C * C * elt + C * 4 + 2 * K * 4 + K * B * LP * C * 4
    ops = 2 * B * C * C * valid_taps(periods, kh, kw)
    ops_all = 2 * K * B * LP * kh * kw * C * C
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    t_all = max(t_mem, ops_all / PEAK_OPS_PER_S[dtype])
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations"), 1e3 * t_all


def library_conv(torch, F, h, periods, weight, bias, kh, kw):
    """cuDNN over each candidate's exact [cycles, p] grid: the yardstick.

    Returns the K convolution calls (grids built beforehand) and a function
    that scatters their output back to the [K, B, Lp, Cout] fold layout."""

    grids, calls = [], []
    w = weight.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    for k, p in enumerate(periods):
        cycles = -(-L // p)
        grid = h[k, :, : cycles * p].reshape(B, cycles, p, C).permute(0, 3, 1, 2).contiguous()
        grids.append((grid, cycles, p))
        calls.append(lambda g=grid: F.conv2d(g, w, bias, padding=(kh // 2, kw // 2)))

    def run():
        return [c() for c in calls]

    def unfold(outs):
        return [o.permute(0, 2, 3, 1).reshape(B, cyc * p, C) for o, (_, cyc, p) in zip(outs, grids)]

    return run, unfold


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    if not (PACKAGE / "csrc").is_dir():
        fail(f"{PACKAGE} is missing: run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(REPO))

    import numpy as np
    import torch.nn.functional as F

    from flow_timesnet_tpu_torch import convert, forecaster
    from flow_timesnet_tpu_torch.device import resolve_device
    from flow_timesnet_tpu_torch.models import timesnet
    from flow_timesnet_tpu_torch.ops import _build, cuda_fold, fold

    # 1. environment ----------------------------------------------------------
    dev = resolve_device("cuda")  # the port's device policy, TF32 off included
    card = card_line()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[env] card: {card}")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        print(f"[build] {name} -> {path.relative_to(REPO)}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    # 3. each kernel against its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {f"{kh}x{kw}": 0.0 for kh, kw in KERNEL_SIZES}
    for kh, kw in KERNEL_SIZES:
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        for periods in PERIOD_SETS:
            geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=dev), L, L - 1)
            check(geom.Lp == LP, f"Lp {geom.Lp} != {LP}")
            # every row holds data, the tail beyond L too: later convs read it
            h32 = torch.randn((K, B, LP, C), generator=gen, device=dev)
            for dtype in (torch.bfloat16, torch.float32):
                h = h32.to(dtype)
                got = cuda_fold.tap_conv_cuda(h, geom.periods, geom.cycles, weight, bias, kh, kw)
                want = fold.tap_conv(h, geom, weight, bias, kh, kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
                max_err[f"{kh}x{kw}"] = max(max_err[f"{kh}x{kw}"], err)
                print(f"[kernel] {kh}x{kw} periods {list(periods)} {str(dtype)[6:]}: "
                      f"max |kernel - plain| {err:.3e} {'ok' if ok else 'FAIL'}")
                check(ok, f"tap_conv_fwd {kh}x{kw} {periods} {dtype} disagrees with the plain "
                          f"version: {err:.3e} > {TOL}")
                if dtype == torch.bfloat16:  # the serving path's type: time it here too
                    ms = time_ms(torch, lambda: cuda_fold.tap_conv_cuda(
                        h, geom.periods, geom.cycles, weight, bias, kh, kw))
                    plain = time_ms(torch, lambda: fold.tap_conv(h, geom, weight, bias, kh, kw),
                                    iters=20)
                    run, _ = library_conv(torch, F, h, periods, weight.to(dtype),
                                          bias.to(dtype), kh, kw)
                    b_ms, b_by, _ = bound(periods, kh, kw, "bfloat16")
                    print(f"[kernel]   time: kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us,"
                          f" cuDNN grid conv {time_ms(torch, run) * 1e3:.2f} us, bound "
                          f"{b_ms * 1e3:.3f} us ({b_by})")
            # the fold identity itself: the kernel equals cuDNN over the exact grid
            run, unfold = library_conv(torch, F, h32, periods, weight, bias, kh, kw)
            got = cuda_fold.tap_conv_cuda(h32, geom.periods, geom.cycles, weight, bias, kh, kw)
            err = max(float((got[k, :, : ref.shape[1]] - ref).abs().max())
                      for k, ref in enumerate(unfold(run())))
            print(f"[kernel] {kh}x{kw} periods {list(periods)} float32: "
                  f"max |kernel - cuDNN over the exact grids| {err:.3e}")
            check(err <= 1e-3, f"{kh}x{kw} {periods}: kernel vs cuDNN grid conv {err:.3e}")

    # 4. serve at the flagship width -------------------------------------------
    cfg = flagship_config(timesnet)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    n_params = sum(v.numel() for v in params.values())
    check(n_params == 2_536_356, f"flagship parameter count {n_params}")
    heads = torch.Generator().manual_seed(1)
    for name in ("mu_head.kernel", "sigma_head.kernel", "context_coeff.kernel",
                 "late_bias_head.kernel"):
        params[name] = torch.randn(params[name].shape, generator=heads) * 0.05

    rng = np.random.default_rng(0)
    T = 28
    ids = [f"store{i // 12}_item{i % 12}" for i in range(B)]
    weekly = 1.0 + 0.5 * np.sin(2 * np.pi * (np.arange(T)[:, None] / 7.0 + rng.uniform(0, 1, B)))
    history = rng.poisson(rng.gamma(2.0, 6.0, B) * weekly).astype(np.float32)  # [T, B]
    dates = np.datetime64("2024-03-04") + np.arange(T)
    scaler = {sid: (float(history[:, j].mean()), float(history[:, j].std() + 1.0))
              for j, sid in enumerate(ids)}
    static = rng.standard_normal((B, 5)).astype(np.float32)
    sigma = rng.uniform(0.01, 0.1, B).astype(np.float32)
    tf_cfg = {"features": ["day_of_week", "day_of_month", "month", "day_of_year"],
              "encoding": "cyclical", "normalize": True}

    fc = forecaster.Forecaster(params, cfg, ids, scaler, "zscore", static, sigma, tf_cfg)
    check(fc.device.type == "cuda", f"default device is {fc.device}")
    # warm-up request (cuFFT plans, allocator); hooks record the periods the
    # selector hands each block and the device inputs of the model's forward
    selected, fwd_args = [], []
    hooks = [
        getattr(fc.engine.model, f"blocks_{i}").register_forward_pre_hook(
            lambda mod, a, i=i: selected.append((i, a[1].periods.clone())))
        for i in range(cfg.n_layers)
    ]
    hooks.append(fc.engine.model.register_forward_pre_hook(lambda mod, a: fwd_args.append(a)))
    first = fc.forecast(history, dates=dates)
    torch.cuda.synchronize()
    for hook in hooks:
        hook.remove()
    served = sorted({tuple(int(p) for p in per.tolist()) for _, per in selected})
    torch.cuda.reset_peak_memory_stats()

    cuda_fold.launches.clear()  # the main path's launches, from here ...
    latencies, outs = [], []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        outs.append(fc.forecast(history, dates=dates))
        latencies.append(1e3 * (time.perf_counter() - t0))
    counts = dict(cuda_fold.launches)  # ... to here
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    for out in outs:
        check(out.shape == (cfg.pred_len, B), f"forecast shape {out.shape}")
        check(bool(np.isfinite(out).all()) and bool((out >= 0).all()), "non-finite or negative")
    for kh, kw in KERNEL_SIZES:
        n = counts.get(f"{kh}x{kw}", 0)
        check(n == REQUESTS * LAUNCHES_PER_REQUEST // len(KERNEL_SIZES),
              f"tap_conv_fwd {kh}x{kw} launched {n} times in {REQUESTS} requests")
    check(sum(counts.values()) == REQUESTS * LAUNCHES_PER_REQUEST, f"launches {counts}")
    p50 = float(np.median(latencies))
    print(f"[serve] {REQUESTS} requests of {B} series x {T} days: launches {counts}, "
          f"latency ms {spread(np, latencies)}, "
          f"peak device memory {peak_mib:.1f} MiB, selected periods {served}")
    print(f"[serve] forecast range [{float(first.min()):.3f}, {float(first.max()):.3f}], "
          f"history mean {float(history.mean()):.3f}, every request equal to the first: "
          f"{all(np.array_equal(first, o) for o in outs)}")

    # request against the forward alone on that request's own device inputs,
    # interleaved one for one: the difference is the host's share (scaling,
    # calendar features, copies to and from the card)
    (args,) = fwd_args
    req, fwd = [], []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        fc.forecast(history, dates=dates)
        req.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        fc.engine.forward(*args)
        torch.cuda.synchronize()
        fwd.append(1e3 * (time.perf_counter() - t0))
    host = np.asarray(req) - np.asarray(fwd)
    print(f"[layers] {REQUESTS} interleaved pairs: request ms {spread(np, req)}")
    print(f"[layers] forward alone (the request's device inputs) ms {spread(np, fwd)}")
    print(f"[layers] request minus forward, pair by pair, ms {spread(np, host)}")

    # float32 on the card against float32 on the CPU, same request
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    raw = {}
    for device in ("cuda", "cpu"):
        f32 = forecaster.Forecaster(params, cfg32, ids, scaler, "zscore", static, sigma, tf_cfg,
                                    device=device)
        raw[device] = f32._forecast_raw(history, dates=dates)[:2]
    for name, a, b in zip(("rate", "dispersion"), raw["cuda"], raw["cpu"]):
        err = float(np.abs(a - b).max())
        print(f"[serve] float32 card vs CPU {name}: max abs diff {err:.3e}")
        check(np.allclose(a, b, rtol=TOL, atol=TOL), f"float32 {name} card vs CPU {err:.3e}")

    # 5. where the request's device time goes ----------------------------------
    profile(torch, fc, history, dates, p50)

    # 6. timing at the periods the requests selected ---------------------------
    kernels = []
    for kh, kw in KERNEL_SIZES:
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        h = torch.randn((K, B, LP, C), generator=gen, device=dev).to(torch.bfloat16)
        rows = []
        for periods in served:
            geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=dev), L, L - 1)
            ms = time_ms(torch, lambda: cuda_fold.tap_conv_cuda(
                h, geom.periods, geom.cycles, weight, bias, kh, kw))
            plain = time_ms(torch, lambda: fold.tap_conv(h, geom, weight, bias, kh, kw), iters=20)
            run, _ = library_conv(torch, F, h, periods, weight.to(torch.bfloat16),
                                  bias.to(torch.bfloat16), kh, kw)
            lib = time_ms(torch, run)
            b_ms, b_by, b_all = bound(periods, kh, kw, "bfloat16")
            rows.append((ms, plain, lib, b_ms, b_by, b_all))
            print(f"[time] {kh}x{kw} periods {list(periods)} bf16: kernel {ms * 1e3:.2f} us, "
                  f"plain {plain * 1e3:.2f} us, cuDNN grid conv {lib * 1e3:.2f} us, "
                  f"bound {b_ms * 1e3:.3f} us ({b_by}; {b_all * 1e3:.3f} us counting all taps)")
        mean = [float(np.mean([r[j] for r in rows])) for j in (0, 1, 2, 3, 5)]
        kernels.append({
            "name": f"tap_conv_fwd_{kh}x{kw}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": counts[f"{kh}x{kw}"],
            "max_abs_err": max_err[f"{kh}x{kw}"], "ms": mean[0], "plain_ms": mean[1],
            "bound_ms": mean[3], "bound_by": rows[0][4], "library_ms": mean[2],
            "bound_ms_all_taps": mean[4], "periods": [list(p) for p in served],
        })

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def profile(torch, fc, history, dates, p50_ms: float) -> None:
    """Device time by kernel over ``PROFILED`` requests, against the request
    p50 measured without the profiler: the device's busy and idle share."""

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fc.forecast(history, dates=dates)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / (1e3 * PROFILED)
    if busy_ms <= 0:
        print("[profile] device time not measured (the profiler saw no device activity)")
        return
    launches = sum(e.count for e in events) / PROFILED
    print(f"[profile] {PROFILED} requests: device busy {busy_ms:.3f} ms per request in "
          f"{launches:.0f} launches of {len(events)} kernels: "
          f"{100 * busy_ms / p50_ms:.1f} % of the p50 request, idle "
          f"{100 - 100 * busy_ms / p50_ms:.1f} %")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / PROFILED:9.2f} us/request "
              f"x{e.count / PROFILED:<5.1f} {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
