#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of flow-timesnet-tpu on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card, ``nvcc`` and
PyTorch built for CUDA (no JAX is needed or imported):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: versions and the card's name and power limit;
2. build: every CUDA source of the port, one ``nvcc`` each, all at once;
3. kernels: the fold-conv forward against its plain PyTorch version on the
   card at the serving shape (K=2 candidates, B=192 series, L=28, Lp=55,
   32 channels) for 3x3, 5x5 and 7x7, three period sets and bf16 (the
   tensor-core template, whose plan must equal the wrapper's mirror of it)
   and float32 (the CUDA-core kernel), within 1e-4, and in float32 against
   cuDNN over the exact fold grids within 1e-3;
4. serve: a ``Forecaster`` at the full width of the flagship model
   (``configs/demand_benchmark.yaml``: d_model 128, d_ff 512, two layers,
   2,536,356 parameters, bf16 conv islands) with seeded random weights
   answers 200 timed requests of 192 series x 28 days; the forward must be
   launched 12 times per request, all on the tensor-core route, the forecasts must be finite and >= 0,
   and a float32 request must match the same request on the CPU within 1e-4.
   Then 200 requests interleaved with 200 forwards on the request's own
   device inputs split the request into host and forward;
5. profile: device time per request by kernel (torch.profiler, 50
   requests) against the request's p50, which gives the device's busy and
   idle share;
6. backward kernels: the dh-adjoint and weight-gradient kernels against
   their plain versions at the training shape (K=2, B=256, Lp=55, 32
   channels) for the three sizes, three period sets and bf16 and float32
   (dh within 1e-4, rows past each fold extent exactly 0; dW within rtol
   1e-4 and 1e-4 of its largest value, as it sums 28,160 products), each
   launched twice with the same bits both times. bf16 dh and dW take their
   tensor-core kernels, float32 the CUDA-core kernels; every plan must
   equal the wrapper's mirror of it. float32 is also held against cuDNN's
   convolution backward over the exact fold grids within 1e-3 (of the
   largest dW);
7. train: the flagship at full width and depth takes 5 + 100 timed
   ``Engine.train_step`` calls at B=256 on seeded windows of 192 series x
   365 days (``SlidingWindowSource`` -> ``WindowBatcher`` ->
   ``batch_to_device``; lr from ``LRController``, dropout 0.0675, EMA 0.99,
   bf16); the losses must be finite and each step must launch the forward,
   dh and dW exactly 12 times each, all on the tensor-core routes; 30 steps on one fixed
   batch must lower its loss, and ``Engine.evaluate`` over 8 held-out
   batches (the last one padded) must give a finite NLL and sMAPE. A float32
   step with dropout 0 on the card must match the same step on the CPU (loss
   within 1e-5 relative, gradients within 1e-4 of the largest, the NB-NLL
   alone within 1e-5), its forward, dh and dW on the CUDA-core routes (12
   launches each, none on a tensor-core route); then device time per step
   by kernel over 20 profiled steps, of the bf16 step and of a float32 one
   (``compute_dtype="float32"``, the JAX package's default: 20 timed steps,
   then 20 profiled), each with the fold conv's device time per step;
8. timing: each kernel, both routes, at the periods its path selected
   (served requests for the forward, training steps for the backward),
   beside its plain
   version, cuDNN over the exact fold grids (a yardstick the port never
   calls) and its bound on the card, the float32 dh and dW also beside
   the times of their previous design. Times are device time (torch.profiler's
   kernel time, mean of 100 calls; a profiler session that loses records is
   taken again, and the run fails if they keep being lost); the kernel's and
   cuDNN's calls are also timed back to back by CUDA events, which adds the
   host's launch work where that is the longer.

The last lines are the ``kernels`` JSON line, the card line of ``nvidia-smi``
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
B_TRAIN = 256  # the flagship's training batch
P_MAX = L - 1  # make_geometry's p_cap on both paths: the plans' zero rows cover it
KERNEL_SIZES = ((3, 3), (5, 5), (7, 7))
PERIOD_SETS = ((7, 14), (4, 27), (1, 27))
TOL = 1e-4
REQUESTS = 200  # timed requests per serving measurement (about 12 ms each)
PROFILED = 50  # requests under the profiler
PROFILER_TRIES = 5  # profiler sessions a device time may take before the run fails
LAUNCHES_PER_PASS = 12  # 2 layers x 2 inception blocks x 3 branches, per forward or backward
# device us of the previous design of the float32 dh and dW kernels at these
# shapes and periods on an H100 80GB HBM3 at 700 W (PERF.md's kernel table,
# "Before"), printed beside this run's
BEFORE_F32_US = {"dh": (64.80, 140.00, 235.46), "dw": (171.02, 194.47, 336.00)}
REPLACES = "flow_timesnet_tpu/ops/pallas_fold.py:174"
REPLACES_DH = "flow_timesnet_tpu/ops/pallas_fold.py:174 (sign=-1, 133-138)"
SOURCE_MMA = "flow_timesnet_tpu_torch/csrc/tap_conv_mma.cu"
REPLACES_DW = "flow_timesnet_tpu/ops/fold.py:265 (XLA; companion of pallas_fold.py:133)"
SOURCE = "flow_timesnet_tpu_torch/csrc/tap_conv_fwd.cu"
SOURCE_BWD = "flow_timesnet_tpu_torch/csrc/tap_conv_bwd.cu"
# the train: block of configs/demand_benchmark.yaml
TRAIN = dict(lr=9.878e-4, epochs=30, warmup_steps=400, eta_min=1e-5)
ENGINE = dict(use_loss_masking=True, grad_clip_norm=1.0, weight_decay=1e-6, ema_decay=0.99,
              num_series=B)
DAYS, HELD_OUT_DAYS = 365, 44  # 44 days hold 10 windows a series: 8 batches, the last padded
WARMUP_STEPS, TIMED_STEPS, OVERFIT_STEPS, PROFILED_STEPS = 5, 100, 30, 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def kernel_label(ptxas_line: str) -> str:
    """``tap_conv_mma_kernel<1, 32>`` from ptxas's line naming a mangled kernel."""

    m = re.search(r"(tap_conv_[a-z_]+?_kernel)(?:I((?:Lin?\d+E)+)E)?", ptxas_line)
    if not m:
        return ptxas_line.strip()
    args = re.findall(r"Li(n?\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(a.replace('n', '-') for a in args)}>" if args else "")


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


def flagship_params(torch, convert, cfg) -> dict:
    """Seeded random weights of the flagship, with non-zero heads."""

    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    heads = torch.Generator().manual_seed(1)
    for name in ("mu_head.kernel", "sigma_head.kernel", "context_coeff.kernel",
                 "late_bias_head.kernel"):
        params[name] = torch.randn(params[name].shape, generator=heads) * 0.05
    return params


def spread(np, values) -> str:
    """p50 with the p10-p90 range and the extremes, to 3 decimals."""

    p10, p50, p90 = np.percentile(values, [10, 50, 90])
    return (f"p50 {p50:.3f} (p10 {p10:.3f}, p90 {p90:.3f}, "
            f"min {np.min(values):.3f}, max {np.max(values):.3f}; n={len(values)})")


def time_ms(torch, fn, iters: int = 100) -> float:
    """Device time of one call: what its kernels take on the card, from
    torch.profiler over ``iters`` calls after a warm-up (inputs stay in L2,
    as they do between the model's ops). The host's time between launches is
    not in it: a call whose kernels take a few tens of us can take longer
    from the host than on the card (see :func:`call_ms`).

    Each kernel counts with the mean time of its recorded launches times its
    launches per call, so a launch the profiler failed to record does not
    lower the time; such a shortfall is printed. A session that recorded no
    device time, or lost a tenth of a kernel's launches (one that lost half
    of them has read a kernel far below its time), is taken again, up to
    ``PROFILER_TRIES`` sessions in all; then the run fails."""

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, whole = 0.0, True
        for e in prof.key_averages():
            if e.device_type.name != "CUDA" or e.count == 0:
                continue
            per_call = max(1, round(e.count / iters))  # every call launches the same kernels
            if e.count != per_call * iters:
                print(f"[time] the profiler recorded {e.count} launches of {e.key[:60]} in "
                      f"{iters} calls")
                whole = whole and e.count >= 0.9 * per_call * iters
            us += e.self_device_time_total / e.count * per_call
        if us > 0 and whole:
            return us / 1e3
        print(f"[time] the profiler lost this session ({us:.2f} us recorded): taking it again")
    fail(f"the profiler lost {PROFILER_TRIES} sessions in a row: device time not measured")


def call_ms(torch, fn, iters: int = 100) -> float:
    """Time of one call back to back with the next, from CUDA events around
    ``iters`` calls after a warm-up: the device time, or the host's launch
    work where that is longer."""

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


def measure(torch, kernel, plain, lib, bnd) -> dict:
    """One kernel's numbers on one set of inputs, under the keys of the
    ``kernels`` line: device time of the kernel, of its plain version and of
    cuDNN (``lib``); the bound ``bnd`` = (ms, bound_by, ms counting all
    taps); and the time of a call back to back, of the kernel and of cuDNN."""

    b_ms, b_by, b_all = bnd
    return {"ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain, iters=20),
            "library_ms": time_ms(torch, lib), "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_all_taps": b_all, "call_ms": call_ms(torch, kernel),
            "library_call_ms": call_ms(torch, lib)}


def mean_of(np, rows) -> dict:
    """:func:`measure`'s numbers averaged over the period sets."""

    return {k: rows[0][k] if isinstance(rows[0][k], str) else float(np.mean([r[k] for r in rows]))
            for k in rows[0]}


def described(t: dict) -> str:
    return (f"kernel {t['ms'] * 1e3:.2f} us (a call back to back {t['call_ms'] * 1e3:.2f} us), "
            f"plain {t['plain_ms'] * 1e3:.2f} us, cuDNN {t['library_ms'] * 1e3:.2f} us (a call "
            f"back to back {t['library_call_ms'] * 1e3:.2f} us), bound {t['bound_ms'] * 1e3:.3f} "
            f"us ({t['bound_by']}; {t['bound_ms_all_taps'] * 1e3:.3f} us counting all taps)")


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


def bound(periods, kh: int, kw: int, dtype: str, batch: int = B, kind: str = "fwd"):
    """Least time for one call on an H100 SXM: each input read once and the
    output written once over the memory rate, against the multiply-adds of
    the taps that these periods leave inside the grid over the peak rate of
    the input type. ``kind``: the forward (h, W, bias in; float32 out), the
    dh adjoint (ct, W in; float32 dh out) or the weight gradient (h, ct in;
    float32 dW out); all three do one multiply-add per valid (row, tap)
    pair and channel pair. Returns (ms, bound_by, ms counting all kh*kw taps)."""

    elt = 2 if dtype == "bfloat16" else 4
    act, w = K * batch * LP * C, kh * kw * C * C
    nbytes = {
        "fwd": act * elt + w * elt + C * 4 + 2 * K * 4 + act * 4,
        "dh": act * elt + w * elt + 2 * K * 4 + act * 4,
        "dw": 2 * act * elt + 2 * K * 4 + w * 4,
    }[kind]
    ops = 2 * batch * C * C * valid_taps(periods, kh, kw)
    ops_all = 2 * K * batch * LP * kh * kw * C * C
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


def library_conv_bwd(torch, h, ct, periods, weight, kh, kw, batch):
    """cuDNN's convolution backward over each candidate's exact [cycles, p]
    grid: the yardstick of the dh and dW kernels. Returns the K
    ``conv2d_input`` calls, the K ``conv2d_weight`` calls (grids built
    beforehand) and the grids' extents."""

    from torch.nn import grad as nn_grad

    w = weight.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    pad = (kh // 2, kw // 2)
    grids = []
    for k, p in enumerate(periods):
        cycles = -(-L // p)

        def to_grid(x, k=k, p=p, cycles=cycles):
            return x[k, :, : cycles * p].reshape(batch, cycles, p, C).permute(0, 3, 1, 2).contiguous()

        grids.append((to_grid(h), to_grid(ct), cycles, p))

    def dh():
        return [nn_grad.conv2d_input(hg.shape, w, cg, padding=pad) for hg, cg, _, _ in grids]

    def dw():
        return [nn_grad.conv2d_weight(hg, w.shape, cg, padding=pad) for hg, cg, _, _ in grids]

    return dh, dw, [(cyc, p) for _, _, cyc, p in grids]


def check_fold_plan(cuda_fold, sign: int, batch: int, kh: int, kw: int) -> None:
    """The tensor-core forward (sign +1) or dh (sign -1) plan at this shape:
    the wrapper's mirror must equal the kernel's own."""

    name = "tap_conv_fwd_mma" if sign > 0 else "tap_conv_dh_mma"
    plan = cuda_fold.fold_mma_plan(sign, K, batch, LP, C, C, kh, kw, P_MAX)
    check(cuda_fold.fold_mma_plan_of_kernel(sign, K, batch, LP, C, C, kh, kw, P_MAX) == plan,
          f"{name} {kh}x{kw}: the wrapper's plan differs from the kernel's")
    print(f"[kernel] {name} {kh}x{kw} plan (the kernel's own): {plan._asdict()}")


def check_backward_kernels(torch, fold, cuda_fold, gen, dev):
    """Phase 6: the dh and dW kernels against their plain versions and, in
    float32, against cuDNN's convolution backward. Returns the largest
    kernel-vs-plain differences by name."""

    max_err = {}
    for kh, kw in KERNEL_SIZES:
        key = f"{kh}x{kw}"
        plan = cuda_fold.dw_mma_plan(K, B_TRAIN, LP, C, C, kh, kw, P_MAX)
        check(cuda_fold.dw_mma_plan_of_kernel(K, B_TRAIN, LP, C, C, kh, kw, P_MAX) == plan,
              f"tap_conv_dw_mma {key}: the wrapper's plan differs from the kernel's")
        print(f"[kernel] dW {key} bf16 tensor-core plan (the kernel's own): {plan._asdict()}, "
              f"scratch {4 * plan.scratch_elems(kh, kw, C, C) / 1e6:.2f} MB")
        check_fold_plan(cuda_fold, -1, B_TRAIN, kh, kw)
        dh_plan = cuda_fold.dh_f32_plan(K, B_TRAIN, LP, C, C, kh, kw, P_MAX)
        dw_plan = cuda_fold.dw_f32_plan(K, B_TRAIN, LP, C, C, kh, kw)
        check(cuda_fold.dh_f32_plan_of_kernel(K, B_TRAIN, LP, C, C, kh, kw, P_MAX) == dh_plan and
              cuda_fold.dw_f32_plan_of_kernel(K, B_TRAIN, LP, C, C, kh, kw) == dw_plan,
              f"float32 dh or dW {key}: the wrapper's plan differs from the kernel's")
        print(f"[kernel] dh {key} float32 plan (the kernel's own): {dh_plan._asdict()}")
        print(f"[kernel] dW {key} float32 plan (the kernel's own): {dw_plan._asdict()}, "
              f"scratch {4 * dw_plan.scratch_elems(kh, kw, C, C) / 1e6:.2f} MB")
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        for periods in PERIOD_SETS:
            geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=dev), L, P_MAX)
            h32 = torch.randn((K, B_TRAIN, LP, C), generator=gen, device=dev)
            # a cotangent over all Lp rows: rows beyond L feed the next conv
            ct32 = torch.randn((K, B_TRAIN, LP, C), generator=gen, device=dev)
            for dtype in (torch.bfloat16, torch.float32):
                h, ct = h32.to(dtype), ct32.to(dtype)
                dh = cuda_fold.tap_conv_dh_cuda(ct, geom, weight, kh, kw)
                dw = cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
                same = (torch.equal(dh, cuda_fold.tap_conv_dh_cuda(ct, geom, weight, kh, kw)) and
                        torch.equal(dw, cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)))
                want_dh = fold.tap_conv_dh(ct, geom, weight, kh, kw)
                want_dw = fold.tap_weight_grad(h, geom, ct, kh, kw)
                torch.cuda.synchronize()
                err_dh = float((dh - want_dh).abs().max())
                err_dw = float((dw - want_dw).abs().max())
                scale = float(want_dw.abs().max())
                ok_dh = bool(torch.allclose(dh, want_dh, rtol=TOL, atol=TOL))
                ok_dw = bool(torch.allclose(dw, want_dw, rtol=TOL, atol=TOL * scale))
                tail = all(not bool(dh[k, :, t:].any()) for k, t in enumerate(geom.total.tolist()))
                route = "mma" if dtype == torch.bfloat16 else "f32"
                for name, err in ((f"dh_{route}_{key}", err_dh), (f"dw_{route}_{key}", err_dw)):
                    max_err[name] = max(max_err.get(name, 0.0), err)
                print(f"[kernel] {key} periods {list(periods)} {str(dtype)[6:]}: max |dh - plain| "
                      f"{err_dh:.3e} {'ok' if ok_dh else 'FAIL'}, dh rows beyond the fold 0: "
                      f"{tail}, max |dW - plain| {err_dw:.3e} of max |dW| {scale:.3e} "
                      f"{'ok' if ok_dw else 'FAIL'}, the same bits twice: {same}")
                check(same, f"dh or dW {key} {periods} {dtype}: the bits differ from run to run")
                check(ok_dh and tail, f"tap_conv_dh {key} {periods} {dtype}: {err_dh:.3e}")
                check(ok_dw, f"tap_conv_dw {key} {periods} {dtype}: {err_dw:.3e} of {scale:.3e}")
                if dtype == torch.bfloat16:  # the training path's type: time it here too
                    t = time_backward(torch, fold, cuda_fold, h, ct, geom, periods, weight, kh, kw)
                    for kind in ("dh", "dw"):
                        print(f"[kernel]   time {kind}: {described(t[kind])}")
            # the adjoint identity itself: the kernels equal cuDNN's backward
            # over the exact grids, for a cotangent that is 0 beyond each grid
            ct_grid = ct32.clone()
            for k, t in enumerate(geom.total.tolist()):
                ct_grid[k, :, t:] = 0.0
            run_dh, run_dw, extents = library_conv_bwd(torch, h32, ct_grid, periods, weight,
                                                       kh, kw, B_TRAIN)
            dh = cuda_fold.tap_conv_dh_cuda(ct_grid, geom, weight, kh, kw)
            dw = cuda_fold.tap_conv_dw_cuda(h32, geom, ct_grid, kh, kw)
            err_dh = max(float((dh[k, :, : cyc * p] - ref.permute(0, 2, 3, 1).reshape(
                B_TRAIN, cyc * p, C)).abs().max()) for k, (ref, (cyc, p)) in
                enumerate(zip(run_dh(), extents)))
            ref_dw = sum(run_dw()).permute(2, 3, 1, 0)
            err_dw = float((dw - ref_dw).abs().max()) / max(1.0, float(ref_dw.abs().max()))
            print(f"[kernel] {key} periods {list(periods)} float32: max |dh - cuDNN| {err_dh:.3e},"
                  f" max |dW - cuDNN| / max |dW| {err_dw:.3e}")
            check(err_dh <= 1e-3 and err_dw <= 1e-3,
                  f"{key} {periods}: backward kernels vs cuDNN {err_dh:.3e} / {err_dw:.3e}")
    return max_err


def time_forward(torch, F, fold, cuda_fold, h, geom, periods, weight, bias, kh, kw):
    """:func:`measure` of the forward kernel on these inputs; the route is
    that of their dtype."""

    run, _ = library_conv(torch, F, h, periods, weight.to(h.dtype), bias.to(h.dtype), kh, kw)
    dtype = "bfloat16" if h.dtype == torch.bfloat16 else "float32"
    return measure(
        torch,
        lambda: cuda_fold.tap_conv_cuda(h, geom, weight, bias, kh, kw),
        lambda: fold.tap_conv(h, geom, weight, bias, kh, kw), run, bound(periods, kh, kw, dtype))


def time_backward(torch, fold, cuda_fold, h, ct, geom, periods, weight, kh, kw,
                  kinds=("dh", "dw")):
    """:func:`measure` of the dh and dW kernels (``kinds``) on these inputs,
    by kind; each takes the route of their dtype."""

    run_dh, run_dw, _ = library_conv_bwd(torch, h, ct, periods, weight.to(h.dtype), kh, kw,
                                         h.shape[1])
    dtype = "bfloat16" if h.dtype == torch.bfloat16 else "float32"
    out = {}
    for kind, kernel, plain, lib in (
        ("dh", lambda: cuda_fold.tap_conv_dh_cuda(ct, geom, weight, kh, kw),
         lambda: fold.tap_conv_dh(ct, geom, weight, kh, kw), run_dh),
        ("dw", lambda: cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw),
         lambda: fold.tap_weight_grad(h, geom, ct, kh, kw), run_dw),
    ):
        if kind not in kinds:
            continue
        out[kind] = measure(torch, kernel, plain, lib,
                            bound(periods, kh, kw, dtype, h.shape[1], kind))
    return out


def train_data(np, windows, L_in: int, H_out: int):
    """Seeded Poisson counts with a weekly cycle, 192 series x 365 days, 5
    static features and the 8 cyclical calendar features of the flagship:
    the training batcher (shuffled, B=256) over the first 321 days, the
    held-out batcher (padded final batch) over the last 44, and the
    per-series dispersion floors."""

    rng = np.random.default_rng(2)
    weekly = 1.0 + 0.5 * np.sin(2 * np.pi * (np.arange(DAYS)[:, None] / 7.0 + rng.uniform(0, 1, B)))
    values = rng.poisson(rng.gamma(2.0, 6.0, B) * weekly).astype(np.float32)  # [DAYS, B]
    dates = np.datetime64("2023-03-06") + np.arange(DAYS)
    static = rng.standard_normal((B, 5)).astype(np.float32)
    sigma = rng.uniform(0.01, 0.1, B).astype(np.float32)
    tf_cfg = {"enabled": True, "features": ["day_of_week", "day_of_month", "month", "day_of_year"],
              "encoding": "cyclical", "normalize": True}

    def source(lo, hi):
        return windows.SlidingWindowSource(
            values[lo:hi], L_in, H_out, "direct", series_static=static, series_ids=np.arange(B),
            time_index=dates[lo:hi], time_feature_config=tf_cfg)

    split = DAYS - HELD_OUT_DAYS
    train = windows.WindowBatcher([source(0, split)], B_TRAIN, shuffle=True, drop_last=True, seed=0)
    held_out = windows.WindowBatcher([source(split, DAYS)], B_TRAIN, shuffle=False,
                                     drop_last=False, seed=1, pad_final=True)
    return train, held_out, sigma


def train_phase(torch, np, modules, cfg, params, dev):
    """Phase 7: flagship training steps on the card. Returns the launch
    counts of the timed steps, the step p50 in ms and the periods the steps
    selected."""

    windows, engine_mod, optim, cuda_fold = modules
    train, held_out, sigma = train_data(np, windows, cfg.input_len, cfg.pred_len)
    check(len(held_out) == 8, f"{len(held_out)} held-out batches")
    warmup = optim.resolve_warmup(TRAIN["warmup_steps"], None, len(train))
    lr_ctl = optim.LRController(TRAIN["lr"], TRAIN["epochs"],
                                {"type": "cosine", "eta_min": TRAIN["eta_min"]}, warmup)
    lr = lr_ctl.lr_for_epoch(1)

    def to_device(batch):
        floor = sigma[batch.series_ids.reshape(-1)].reshape(-1, 1, 1)
        return engine_mod.batch_to_device(batch, floor=floor, device=dev)

    t0 = time.perf_counter()
    host_batches = [b for _, b in zip(range(WARMUP_STEPS + TIMED_STEPS), train)]
    gather_ms = 1e3 * (time.perf_counter() - t0) / len(host_batches)
    eng = engine_mod.Engine(cfg, params, **ENGINE)
    check(eng.device.type == "cuda", f"default device is {eng.device}")
    state = eng.init_state()
    gen = torch.Generator(device=dev).manual_seed(0)
    selected = []
    hooks = [getattr(eng.model, f"blocks_{i}").register_forward_pre_hook(
        lambda mod, a: selected.append(tuple(int(p) for p in a[1].periods.tolist())))
        for i in range(cfg.n_layers)]
    losses = []
    for batch in host_batches[:WARMUP_STEPS]:
        state, loss, _ = eng.train_step(state, lr, gen, to_device(batch))
        losses.append(loss)
    torch.cuda.synchronize()
    for hook in hooks:
        hook.remove()

    torch.cuda.reset_peak_memory_stats()
    counters = path_counters(cuda_fold)
    for counter in counters.values():
        counter.clear()  # the training path's launches, from here ...
    step_ms = []
    for batch in host_batches[WARMUP_STEPS:]:
        t0 = time.perf_counter()
        state, loss, stats = eng.train_step(state, lr, gen, to_device(batch))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
    counts = {name: dict(c) for name, c in counters.items()}  # ... to here
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    for name, got in counts.items():  # every launch on the tensor-core routes
        for kh, kw in KERNEL_SIZES:
            n = got.get(f"{kh}x{kw}", 0)
            check(n == TIMED_STEPS * LAUNCHES_PER_PASS // len(KERNEL_SIZES),
                  f"{name} {kh}x{kw} launched {n} times in {TIMED_STEPS} steps")
    p50 = float(np.median(step_ms))
    print(f"[train] {TIMED_STEPS} steps of {B_TRAIN} windows (after {WARMUP_STEPS} warm-up), "
          f"lr {lr:.4e} (epoch 1 of the cosine schedule with {TRAIN['warmup_steps']} warm-up "
          f"steps over {len(train)} batches an epoch): step ms {spread(np, step_ms)}")
    print(f"[train] windows/s at the p50 {B_TRAIN / p50 * 1e3:.1f}, peak device memory "
          f"{peak_mib:.1f} MiB, host gather {gather_ms:.3f} ms a batch (before the timing), "
          f"launches {counts}, selected periods "
          f"{sorted(set(selected))}, loss first {losses[0]:.4f} last {losses[-1]:.4f}, "
          f"mask_true {float(stats['mask_true']):.0f} of {float(stats['mask_total']):.0f}")

    # 30 steps on one fixed batch at the schedule's base rate lower its loss
    fixed = to_device(host_batches[0])
    fit = engine_mod.Engine(cfg, params, **ENGINE)
    fit_state = fit.init_state()
    fit_losses = [fit.train_step(fit_state, TRAIN["lr"], gen, fixed)[1]
                  for _ in range(OVERFIT_STEPS)]
    fit_losses = torch.stack(fit_losses).cpu().numpy()
    last = float(np.mean(fit_losses[-5:]))
    print(f"[train] {OVERFIT_STEPS} steps on one batch at lr {TRAIN['lr']}: loss "
          f"{fit_losses[0]:.4f} -> {last:.4f} (mean of the last 5)")
    check(bool(np.isfinite(fit_losses).all()) and last < float(fit_losses[0]),
          "the fixed-batch loss did not fall")

    result = eng.evaluate(state.ema, [to_device(b) for b in held_out])
    print(f"[train] evaluate (EMA) over {len(held_out)} held-out batches "
          f"({held_out.total} windows, the last batch padded): nll {result['nll']:.5f}, "
          f"smape {result['smape']:.5f}")
    check(np.isfinite(result["nll"]) and np.isfinite(result["smape"]), f"evaluate {result}")

    def step(batch=fixed):
        eng.train_step(state, lr, gen, batch)

    parity_batch = engine_mod.batch_to_device(
        host_batches[0], floor=sigma[host_batches[0].series_ids.reshape(-1)].reshape(-1, 1, 1),
        device="cpu")
    return dict(counts=counts, p50=p50, periods=sorted(set(selected)), step=step,
                parity_batch=parity_batch, fixed=fixed, lr=lr)


def float32_steps(torch, np, engine_mod, cfg, params, batch, lr, dev):
    """Phase 7, float32: the flagship at full width with
    ``compute_dtype="float32"`` (the JAX package's default, which runs the
    CUDA-core fold-conv kernels) takes 5 + 20 timed steps on one batch, then
    20 under the profiler: device time per step and the fold conv's."""

    eng = engine_mod.Engine(dataclasses.replace(cfg, compute_dtype="float32"), params, **ENGINE)
    state = eng.init_state()
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        eng.train_step(state, lr, gen, batch)

    for _ in range(WARMUP_STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(PROFILED_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    p50 = float(np.median(step_ms))
    print(f"[train] float32 steps of {B_TRAIN} windows on one batch: step ms {spread(np, step_ms)}")
    profile(torch, step, PROFILED_STEPS, "float32 step", p50)


def train_parity(torch, np, engine_mod, losses_mod, cuda_fold, cfg, params, batch_cpu):
    """Phase 7, parity: one float32 step with dropout 0, card against CPU.
    Returns the card step's launches of each kernel by size: the CUDA-core
    routes, 12 each, and none on a tensor-core route."""

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", dropout=0.0)
    out = {}
    for device in ("cuda", "cpu"):
        eng = engine_mod.Engine(cfg32, params, device=device, **ENGINE)
        eng.model.train()
        batch = {k: None if v is None else v.to(device) for k, v in batch_cpu.items()}
        counters = path_counters(cuda_fold)
        for counter in counters.values():
            counter.clear()  # the float32 step's launches, from here ...
        loss, _ = eng._loss(batch, None)
        loss.backward()
        if device == "cuda":
            f32 = {name: dict(c) for name, c in counters.items()}  # ... to here
            per = LAUNCHES_PER_PASS // len(KERNEL_SIZES)
            check(all(f32[name].get(f"{kh}x{kw}", 0) == (0 if name.endswith("_mma") else per)
                      for name in f32 for kh, kw in KERNEL_SIZES),
                  f"float32 step launches {f32}: 12 of each CUDA-core kernel, no tensor-core one")
        out[device] = (float(loss.detach()), {k: p.grad.cpu() for k, p in
                                              eng.model.named_parameters()})
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = out["cuda"], out["cpu"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    scale = max(1.0, max(float(g.abs().max()) for g in g_cpu.values()))
    err = max(float((g_gpu[k] - g_cpu[k]).abs().max()) for k in g_cpu)
    worst = max(g_cpu, key=lambda k: float((g_gpu[k] - g_cpu[k]).abs().max()))
    print(f"[train] float32 step card vs CPU: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (relative "
          f"{rel:.3e}); max gradient difference {err:.3e} ({worst}) of max |g| {scale:.3e}")
    check(rel <= 1e-5, f"float32 loss card vs CPU {rel:.3e}")
    check(err <= 1e-4 * scale, f"float32 gradients card vs CPU {err:.3e}")

    # the NB-NLL alone (torch.lgamma on the card against the CPU)
    rng = np.random.default_rng(3)
    rate = rng.gamma(2.0, 6.0, (B_TRAIN, 7, 1)).astype(np.float32)
    disp = rng.uniform(0.01, 1.0, rate.shape).astype(np.float32)
    y = rng.poisson(rate).astype(np.float32)
    nll = {}
    for device in ("cuda", "cpu"):
        args = [torch.from_numpy(a).to(device) for a in (y, rate, disp)]
        nll[device] = float(losses_mod.negative_binomial_nll(*args))
    diff = abs(nll["cuda"] - nll["cpu"])
    print(f"[train] NB-NLL card vs CPU: {nll['cuda']:.7f} vs {nll['cpu']:.7f}, "
          f"difference {diff:.3e}")
    check(diff <= 1e-5 * max(1.0, abs(nll["cpu"])), f"NB-NLL card vs CPU {diff:.3e}")
    return f32


def path_counters(cuda_fold) -> dict:
    """The launch counters of the fold-conv kernels: every route of each
    kernel, and the tensor-core one."""

    return {"tap_conv_fwd": cuda_fold.launches, "tap_conv_fwd_mma": cuda_fold.launches_mma,
            "tap_conv_dh": cuda_fold.launches_dh, "tap_conv_dh_mma": cuda_fold.launches_dh_mma,
            "tap_conv_dw": cuda_fold.launches_dw, "tap_conv_dw_mma": cuda_fold.launches_dw_mma}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    if not (PACKAGE / "csrc").is_dir():
        fail(f"{PACKAGE} is missing: run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(REPO))

    import numpy as np
    import torch.nn.functional as F

    from flow_timesnet_tpu_torch import convert, forecaster, optim
    from flow_timesnet_tpu_torch import engine as engine_mod
    from flow_timesnet_tpu_torch import losses as losses_mod
    from flow_timesnet_tpu_torch.data import windows
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
        kernel = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line)
            elif "registers" in line or "spill" in line:
                print(f"[build]   {kernel}: {line.strip()}")

    # 3. each kernel against its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {}
    for kh, kw in KERNEL_SIZES:
        check_fold_plan(cuda_fold, 1, B, kh, kw)
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        for periods in PERIOD_SETS:
            geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=dev), L, P_MAX)
            check(geom.Lp == LP, f"Lp {geom.Lp} != {LP}")
            # every row holds data, the tail beyond L too: later convs read it
            h32 = torch.randn((K, B, LP, C), generator=gen, device=dev)
            for dtype in (torch.bfloat16, torch.float32):
                h = h32.to(dtype)
                got = cuda_fold.tap_conv_cuda(h, geom, weight, bias, kh, kw)
                want = fold.tap_conv(h, geom, weight, bias, kh, kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
                name = f"fwd_{'mma' if dtype == torch.bfloat16 else 'f32'}_{kh}x{kw}"
                max_err[name] = max(max_err.get(name, 0.0), err)
                print(f"[kernel] {kh}x{kw} periods {list(periods)} {str(dtype)[6:]}: "
                      f"max |kernel - plain| {err:.3e} {'ok' if ok else 'FAIL'}")
                check(ok, f"tap_conv_fwd {kh}x{kw} {periods} {dtype} disagrees with the plain "
                          f"version: {err:.3e} > {TOL}")
                if dtype == torch.bfloat16:  # the serving path's type: time it here too
                    t = time_forward(torch, F, fold, cuda_fold, h, geom, periods, weight, bias,
                                     kh, kw)
                    print(f"[kernel]   time: {described(t)}")
            # the fold identity itself: the kernel equals cuDNN over the exact grid
            run, unfold = library_conv(torch, F, h32, periods, weight, bias, kh, kw)
            got = cuda_fold.tap_conv_cuda(h32, geom, weight, bias, kh, kw)
            err = max(float((got[k, :, : ref.shape[1]] - ref).abs().max())
                      for k, ref in enumerate(unfold(run())))
            print(f"[kernel] {kh}x{kw} periods {list(periods)} float32: "
                  f"max |kernel - cuDNN over the exact grids| {err:.3e}")
            check(err <= 1e-3, f"{kh}x{kw} {periods}: kernel vs cuDNN grid conv {err:.3e}")

    # 4. serve at the flagship width -------------------------------------------
    cfg = flagship_config(timesnet)
    params = flagship_params(torch, convert, cfg)
    n_params = sum(v.numel() for v in params.values())
    check(n_params == 2_536_356, f"flagship parameter count {n_params}")

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

    for counter in path_counters(cuda_fold).values():
        counter.clear()  # the main path's launches, from here ...
    latencies, outs = [], []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        outs.append(fc.forecast(history, dates=dates))
        latencies.append(1e3 * (time.perf_counter() - t0))
    counts, counts_mma = dict(cuda_fold.launches), dict(cuda_fold.launches_mma)  # ... to here
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    for out in outs:
        check(out.shape == (cfg.pred_len, B), f"forecast shape {out.shape}")
        check(bool(np.isfinite(out).all()) and bool((out >= 0).all()), "non-finite or negative")
    for kh, kw in KERNEL_SIZES:
        n, n_mma = counts.get(f"{kh}x{kw}", 0), counts_mma.get(f"{kh}x{kw}", 0)
        check(n == n_mma == REQUESTS * LAUNCHES_PER_PASS // len(KERNEL_SIZES),
              f"tap_conv_fwd {kh}x{kw} launched {n} times in {REQUESTS} requests, {n_mma} on "
              f"the tensor-core route")
    check(sum(counts.values()) == REQUESTS * LAUNCHES_PER_PASS, f"launches {counts}")
    p50 = float(np.median(latencies))
    print(f"[serve] {REQUESTS} requests of {B} series x {T} days: launches {counts} "
          f"(tensor-core route {counts_mma}), "
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
    profile(torch, lambda: fc.forecast(history, dates=dates), PROFILED, "request", p50)

    # 6. the backward kernels against their plain versions ------------------------
    bwd_err = check_backward_kernels(torch, fold, cuda_fold, gen, dev)

    # 7. train at the flagship width -----------------------------------------------
    trained = train_phase(torch, np, (windows, engine_mod, optim, cuda_fold), cfg, params, dev)
    f32_counts = train_parity(torch, np, engine_mod, losses_mod, cuda_fold, cfg, params,
                                 trained["parity_batch"])
    profile(torch, trained["step"], PROFILED_STEPS, "step", trained["p50"])

    # 8. timing at the periods each path selected, both routes -------------------------
    # the float32 routes run on the float32 path (the card-vs-CPU step), not the bf16 one
    from_f32 = {"launches_from": "float32 parity step"}
    kernels = []
    for kh, kw in KERNEL_SIZES:
        key = f"{kh}x{kw}"
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        h = torch.randn((K, B, LP, C), generator=gen, device=dev).to(torch.bfloat16)
        rows = {"mma": [], "f32": []}
        for periods in served:
            geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=dev), L, P_MAX)
            for route, x in (("mma", h), ("f32", h.float())):  # the same values in both types
                rows[route].append(time_forward(torch, F, fold, cuda_fold, x, geom, periods,
                                                weight, bias, kh, kw))
                print(f"[time] fwd_{route} {key} periods {list(periods)} "
                      f"{'bf16' if route == 'mma' else 'float32'}: {described(rows[route][-1])}")
        for route, source, launched, extra in (
                ("mma", SOURCE_MMA, counts_mma[key],
                 {"launches_train": trained["counts"]["tap_conv_fwd_mma"][key]}),
                ("f32", SOURCE, f32_counts["tap_conv_fwd"][key], from_f32)):
            kernels.append({
                "name": f"tap_conv_fwd_{route}_{key}", "route": "cuda", "source": source,
                "replaces": REPLACES, "launches": launched,
                "max_abs_err": max_err[f"fwd_{route}_{key}"], **mean_of(np, rows[route]),
                "periods": [list(p) for p in served], **extra,
            })
    for kh, kw in KERNEL_SIZES:
        key = f"{kh}x{kw}"
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        h, ct = (torch.randn((K, B_TRAIN, LP, C), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        rows = []
        for periods in trained["periods"]:
            geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=dev), L, P_MAX)
            t = {f"{kind}_mma": v for kind, v in time_backward(
                torch, fold, cuda_fold, h, ct, geom, periods, weight, kh, kw).items()}
            # the float32 routes (the CUDA-core kernels) on the same values
            t.update({f"{kind}_f32": v for kind, v in time_backward(
                torch, fold, cuda_fold, h.float(), ct.float(), geom, periods, weight, kh,
                kw).items()})
            rows.append(t)
            for kind in ("dh_mma", "dh_f32", "dw_mma", "dw_f32"):
                print(f"[time] {kind} {key} periods {list(periods)} "
                      f"{'bf16' if kind.endswith('mma') else 'float32'} B={B_TRAIN}: "
                      f"{described(t[kind])}")
        for kind in ("dh", "dw"):
            mean = mean_of(np, [r[f"{kind}_f32"] for r in rows])
            print(f"[time] {kind}_f32 {key} over the periods {trained['periods']}: kernel "
                  f"{mean['ms'] * 1e3:.2f} us against the previous design's "
                  f"{BEFORE_F32_US[kind][KERNEL_SIZES.index((kh, kw))]:.2f} us, cuDNN "
                  f"{mean['library_ms'] * 1e3:.2f} us, bound {mean['bound_ms'] * 1e3:.3f} us "
                  f"({mean['ms'] / mean['library_ms']:.2f}x cuDNN)")
        for kind, replaces, source in (("dh_mma", REPLACES_DH, SOURCE_MMA),
                                       ("dh_f32", REPLACES_DH, SOURCE_BWD),
                                       ("dw_mma", REPLACES_DW, SOURCE_BWD),
                                       ("dw_f32", REPLACES_DW, SOURCE_BWD)):
            mma = kind.endswith("mma")
            launched = (trained["counts"] if mma else f32_counts)[
                f"tap_conv_{kind[:2]}{'_mma' if mma else ''}"][key]
            kernels.append({
                "name": f"tap_conv_{kind}_{key}", "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": bwd_err[f"{kind}_{key}"], **mean_of(np, [r[kind] for r in rows]),
                "periods": [list(p) for p in trained["periods"]], **({} if mma else from_f32),
            })

    # the float32 step's profile, after the kernel timings: a profiler session
    # of a whole step, just before them, made later sessions lose records
    float32_steps(torch, np, engine_mod, cfg, params, trained["fixed"], trained["lr"], dev)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def profile(torch, run, n: int, unit: str, p50_ms: float) -> None:
    """Device time by kernel over ``n`` calls of ``run`` (one request or one
    step each), against the p50 of such a call measured without the
    profiler: the device's busy and idle share."""

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    # device-side ranges of user annotations (``Optimizer.step#AdamW.step``)
    # span kernels that are counted on their own: leave them out
    averages = prof.key_averages()
    ranges = {e.key for e in averages if getattr(e, "is_user_annotation", False)}
    events = [e for e in averages if e.device_type.name == "CUDA"]
    for e in [e for e in events if e.key in ranges]:
        print(f"[profile] left out, a range over other kernels: {e.key[:60]} "
              f"{e.self_device_time_total / n:.2f} us/{unit}")
        events.remove(e)
    busy_ms = sum(e.self_device_time_total for e in events) / (1e3 * n)
    if busy_ms <= 0:
        print("[profile] device time not measured (the profiler saw no device activity)")
        return
    fold_conv = [e for e in events if "tap_conv" in e.key]
    print(f"[profile] fold conv ({unit}): "
          f"{sum(e.self_device_time_total for e in fold_conv) / n:.2f} us per {unit} in "
          f"{sum(e.count for e in fold_conv) / n:.0f} launches of {len(fold_conv)} kernels")
    launches = sum(e.count for e in events) / n
    print(f"[profile] {n} {unit}s: device busy {busy_ms:.3f} ms per {unit} in "
          f"{launches:.0f} launches of {len(events)} kernels: "
          f"{100 * busy_ms / p50_ms:.1f} % of the p50 {unit}, idle "
          f"{100 - 100 * busy_ms / p50_ms:.1f} %")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the 12 largest, then the port's own kernels wherever they rank
    for i, e in enumerate(ranked):
        if i < 12 or "tap_conv" in e.key:
            print(f"[profile]   {e.self_device_time_total / n:9.2f} us/{unit} "
                  f"x{e.count / n:<5.1f} #{i + 1} {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
