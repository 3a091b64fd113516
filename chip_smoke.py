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
   tensor-core template) and float32 (the CUDA-core kernel), within 1e-4
   over every row of Lp, and in float32 against cuDNN over the exact fold
   grids within 1e-3; the float32 kernel gives the same bits twice, and
   each route's plan (at B=192 and B=256) must equal the wrapper's mirror
   of it. Then the exact extent of the frozen-period path
   (``make_dense_geometry``: K=1, Lp=total, p_max=p) at p=7 (Lp 28) and
   p=27 (Lp 54): every route of the forward (B=192), dh and dW (B=256),
   bf16 and float32, against its plain version (1e-4; dW 1e-4 of its
   largest value), the same bits twice, each plan equal to its mirror, and
   in float32 against cuDNN's conv2d forward and backward over the grid
   within 1e-3 (each is timed in phase 8). Then the long-context recipe's shapes
   (``configs/long_context.yaml``: L=512, 3x3 and 5x5, B=64, 32 channels):
   every route of the three kernels on the dynamic fold (K=4 at periods
   511, 168, 24 and 7, Lp 1023, p_cap 511) and the exact extents of p=25
   and p=171 (Lp 525 and 513), each plan equal to its mirror (the bf16
   dW's band 1, ``tap_conv_dw_wgmma_kernel``: 128-row items at Lp 1023,
   64-row ones at the exact extents), each kernel equal to its plain
   version (1e-4; dW rtol 1e-4 and 1e-4 of its largest value) with the
   same bits twice, then timed over 20 calls beside its bound and cuDNN
   over the exact grids, the bf16 dW also beside the time of its previous
   design (the band kernel it replaced; printed) and with the scratch
   bytes it allocated;
4. serve: a ``Forecaster`` at the full width of the flagship model
   (``configs/demand_benchmark.yaml``: d_model 128, d_ff 512, two layers,
   2,536,356 parameters, bf16 conv islands) with seeded random weights
   answers 200 timed requests of 192 series x 28 days; the forward must be
   launched 12 times per request, all on the tensor-core route, the forecasts must be finite and >= 0,
   and a float32 request must match the same request on the CPU within 1e-4,
   its forward launched 12 times, none on the tensor-core route.
   Then 200 requests interleaved with 200 forwards on the request's own
   device inputs split the request into host and forward;
5. profile: device time per request by kernel (torch.profiler, 50
   requests) against the request's p50, which gives the device's busy and
   idle share. Then ``[serve-frozen]``: the frozen spec from
   ``Engine.collect_period_telemetry`` on the serving batch, stored as JSON
   and read back with ``frozen_spec_from_config``; the ``Forecaster`` on
   it answers 100 timed requests, each launching the forward 2 x 3 x U
   times (U: the unique valid periods, summed over layers), all on the
   tensor-core route, forecasts finite and >= 0; a float32 frozen request
   equals the same request on the CPU within 1e-4 and the float32 dynamic
   request on the card within rtol 1e-5 / atol 1e-6 (its spec the live
   selection; its profile comes at the end of phase 8, beside the dynamic
   request's);
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
   then 20 profiled), each with the fold conv's device time per step.
   Then ``[train-frozen]``: the spec from telemetry on a training batch,
   and an engine on it that continues the dynamic run's ``TrainState`` for
   5 + 50 timed steps (p50 with p10-p90, windows/s), each launching the
   forward, dh and dW 2 x 3 x U times on the tensor-core routes; a float32
   frozen step with dropout 0 equals the same step on the CPU (loss within
   1e-5 relative, gradients within 1e-4 of the largest), its kernels on
   the CUDA-core routes; its profile (at the end) beside the dynamic step's;
8. timing: each kernel, both routes, at the periods its path selected
   (served requests for the forward, training steps for the backward),
   beside its plain
   version, cuDNN over the exact fold grids (a yardstick the port never
   calls) and its bound on the card, the float32 forward, dh and dW also
   beside the times of their previous design (the float32 forward also at
   B=256 on the training path's periods, where a float32 step runs it; the
   ``kernels`` line keeps B=192). Times are device time (torch.profiler's
   kernel time, mean of 100 calls; a profiler session that loses records is
   taken again, and the run fails if they keep being lost); the kernel's and
   cuDNN's calls are also timed back to back by CUDA events, which adds the
   host's launch work where that is the longer. Then each route of each
   kernel at the exact extent of p=7 and p=27, beside its bound over the
   valid taps of K=1 and Lp=total and cuDNN over the same grid (the plain
   versions, run in phase 3, are not timed again), and at the end the
   float32 step's, the frozen request's and the frozen step's profiles.

9. serve-graph: ``Forecaster.forecast`` as served by default, the forward
   replayed from its CUDA graph: 200 requests on the dynamic path and 200
   on the frozen spec of phase 5, each running the forward 12 times (2 x 3
   x U) on the card, forecasts equal to the eager ones of phases 4-5
   within rtol/atol 1e-5, p50 beside the eager p50, and 50 replayed
   requests under the profiler (device busy, busy share, launches);
10. train-graph: ``Engine.train_step`` as trained by default, replayed from
   its CUDA graph: 5 + 100 dynamic steps, then 5 + 100 frozen ones
   continuing the state, against eager steps from the same state,
   generator and batches (losses within 1e-5 relative, the state within
   1e-4 of its largest value), 12 runs of each kernel a step on the card
   (2 x 3 x U), p50 and windows/s beside the eager ones, 20 replayed steps
   of each path under the profiler;
11. train-resident: ``Engine.train_epoch_resident`` over the staged
   192-series data of phase 7, four epochs of 215 steps as the JAX
   package's trainer runs them (the staged probe, equal to the eager one;
   two dynamic epochs, then two frozen ones on the probe's spec; the
   second of each under ``set_sync_debug_mode("error")`` and with 12 runs
   of each kernel a step on the card), epoch seconds and windows/s, the
   losses of epochs 1 and 3 against the host pipeline's eager epoch from
   the same state (1e-5 relative; its seconds beside them),
   ``evaluate_resident`` against ``evaluate`` on the 8 held-out batches
   (1e-5 relative), peak device memory, and a 20-step chunk of each path
   under the profiler;
12. serve-long: the long-context recipe at full width (d_model 128, d_ff
   256, K=4, ``use_checkpoint``, bf16, seeded random weights) serves one
   request of 48 series x 512 hours with 24 ahead on the live selector,
   made with numpy from a seed as ``tools/make_long_context_benchmark.py``
   makes its data: 50 eager and 50 replayed requests (p50, the forward
   launched 2 x 2 times a size each, replays equal to eager), 20 of each
   under the profiler, and a float32 request card vs CPU within 1e-4;
13. train-long: steps at B=64 and the recipe's rate, remat on: 3 + 20
   eager then replayed steps on the dynamic path, then as many on the
   frozen spec of a training batch's telemetry continuing the state
   (replayed = eager, the forward launched twice a pass, the recompute's
   included); peak device memory and the eager step p50 with
   ``use_checkpoint`` on and off; 30 steps on one batch lower its loss; a
   float32 step at B=16 card vs CPU on both paths (loss 1e-5 relative,
   gradients 1e-4 of the largest); 10 replayed steps of each path under
   the profiler;
14. train-long-resident: the training windows (1,328 hours a series)
   staged on the card and two resident epochs of 594 steps (a plan longer
   than the 512-row buffer), the first with its capture, its first 20
   losses equal to the host pipeline's eager steps from the same state, the
   second steady with no synchronising call;
15. train-once: the flagship benchmark's CSV (``tools/make_demand_benchmark.py``'s
   ``train.csv``, 192 series x 560 days, written with numpy byte for byte as
   the generator writes it) and ``train.py::train_once`` on
   configs/demand_benchmark.yaml as the port's config layer reads it (overrides
   for the data paths, ``artifacts.dir`` and ``train.epochs=3`` only): full
   width and depth on the resident pipeline, a freeze by epoch 3, every
   artifact written, each epoch's seconds and windows/s, the graphs' warm-up
   and capture time, the host time around the epochs, every bf16 kernel run
   on the card at each size (no float32 one); then ``Forecaster.from_artifacts``
   on the artifact directory serves the CSV's last window, finite and >= 0;
16. train-once-long: the same for configs/long_context.yaml on its
   benchmark's ``train.csv`` (48 series x 2,400 hours), one epoch;
17. predict: ``python -m flow_timesnet_tpu_torch.cli predict`` (``cli.main``)
   on configs/demand_benchmark.yaml and phase 15's artifacts, before their
   temporary directory goes, overridden for paths only, on the benchmark's
   five TEST files and ``sample_submission.csv`` (written with numpy, the
   generator's bytes): the sample's header and 35 rows in its order, finite
   and >= 0, the bf16 forward run at each size (the kernels' own counts),
   the wall seconds, the seconds to read and pivot and to render and write,
   and each TEST file's forward in ms (the first with its warm-up and
   capture, then replayed); ``model.compute_dtype=float32`` on the card =
   on the CPU within 1e-4, the bf16 run = the bf16 CPU run within
   ``BF16_CPU_TOL``; 64-row chunks on the frozen spec phase 15 froze on
   (float32) = the whole batch within 1e-5, one graph captured and replayed
   for all 15 chunks; ``predict.quantiles`` three more files, ordered; a
   two-member ensemble of the artifacts and a copy = the single model;
18. evaluate: ``cli.main(["evaluate", ...])`` on the same artifacts (the
   last 56 days of the training CSV, the resident pass, with
   ``evaluation.quantiles``): NLL, sMAPE, wsMAPE finite, coverage in [0, 1]
   rising with q, the bf16 forward run at each size; the artifacts with a
   float32 ``config_used.yaml``, card = CPU within 1e-4 relative;
19. predict-long: phase 17's checks (no ensemble) on phase 16's artifacts:
   two TEST files x 48 series x 512 hours, 24 ahead, 16-row chunks on the
   last probe's spec (one epoch never freezes).

The recipes' blocks (the models, schedules and engine settings of phases
4-14) are read from configs/demand_benchmark.yaml and
configs/long_context.yaml through the port's config layer.

Launches are counted twice. The wrappers count where they launch a kernel
(``cuda_fold.launches*``), and each kernel counts its own runs on the card
(``cuda_fold.kernel_runs``, ``csrc/run_count.cuh``). A graph's replay runs
no wrapper, so phases 9-11 hold the wrappers to the first call's warm-up
and capture ((3 + 1) x a pass) and to nothing after it, and the card's
counts to every run: the warm-up calls and each replay (the capture runs
nothing). Phase 4 holds the two counts equal over its 200 eager requests.
Phases 4-8 set ``Engine.cuda_graphs = False`` on their engines and
forecasters (op-by-op dispatch), the yardstick of phases 9-11.
The ``kernels`` line also gives each kernel's exact-extent numbers
(``exact_extent``, at p=7 and p=27), its launches on the frozen request
and step (``launches_serve_frozen``, ``launches_train_frozen``; the float32
rows from the float32 frozen request and parity step) and its runs on the
card in the replayed paths of phases 9-11 (``launches_serve_graph`` over
200 replayed requests, ``launches_train_graph`` over 100 replayed steps,
``launches_resident`` over a steady resident epoch of 215 steps, each also
``_frozen``; bf16, so the float32 rows count 0 there), and for 3x3 and 5x5
``long_context``: the long-context times of phase 3 by geometry and the launches of
phases 12-14 (the float32 rows from the long float32 parity steps), and
``launches_train_once`` / ``launches_train_once_long``: each kernel's runs on
the card in phases 15 and 16 (bf16 recipes: the float32 rows count 0), and
``launches_predict``, ``launches_evaluate`` and ``launches_predict_long``:
each kernel's runs on the card in the recipe-as-shipped runs of phases
17-19 (the same).
``[clock]`` lines give the time since the start at the end of each phase.

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
from typing import NamedTuple

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
DENSE_PERIODS = (7, 27)  # the frozen paths' exact extents: Lp = total = 28 and 54
REQUESTS = 200  # timed requests per serving measurement (about 12 ms each)
FROZEN_REQUESTS, FROZEN_STEPS = 100, 50  # timed on the frozen-period path
PROFILED = 50  # requests under the profiler
PROFILER_TRIES = 10  # profiler sessions a device time may take before the run fails
LAUNCHES_PER_PASS = 12  # 2 layers x 2 inception blocks x 3 branches, per forward or backward
# device us of the previous design of the float32 forward (B=192, the served
# periods), dh and dW (B=256, the training periods) kernels on an H100 80GB
# HBM3 at 700 W (PERF.md's kernel table, "Before"), printed beside this run's
BEFORE_F32_US = {"fwd": (46.61, 78.29, 125.42), "dh": (64.80, 140.00, 235.46),
                 "dw": (171.02, 194.47, 336.00)}
# device us of the previous design of the bf16 dW at the long-context shapes
# (the band kernel it replaced, B=64, 32 channels) on an H100 80GB HBM3 at 700 W
# (PERF.md's long-context table, "Before"), printed beside this run's
BEFORE_LONG_DW_US = {"3x3": {"dynamic": 90.78, "p25": 17.81, "p171": 17.82},
                     "5x5": {"dynamic": 201.67, "p25": 33.89, "p171": 33.64}}
REPLACES = "flow_timesnet_tpu/ops/pallas_fold.py:174"
REPLACES_DH = "flow_timesnet_tpu/ops/pallas_fold.py:174 (sign=-1, 133-138)"
SOURCE_MMA = "flow_timesnet_tpu_torch/csrc/tap_conv_mma.cu"
REPLACES_DW = "flow_timesnet_tpu/ops/fold.py:265 (XLA; companion of pallas_fold.py:133)"
SOURCE = "flow_timesnet_tpu_torch/csrc/tap_conv_fwd.cu"
SOURCE_BWD = "flow_timesnet_tpu_torch/csrc/tap_conv_bwd.cu"
DAYS, HELD_OUT_DAYS = 365, 44  # 44 days hold 10 windows a series: 8 batches, the last padded
WARMUP_STEPS, TIMED_STEPS, OVERFIT_STEPS, PROFILED_STEPS = 5, 100, 30, 20
GRAPH_REQUESTS, GRAPH_STEPS = 200, 100  # replayed from CUDA graphs, each path
RESIDENT_CHUNK = 20  # resident steps under the profiler, each path
DEVICE = "cuda"
# the long-context recipe (configs/long_context.yaml): hourly, 48 series x 2,400 hours
LONG_L, LONG_H, LONG_SERIES, LONG_HOURS, LONG_HOLDOUT, LONG_B = 512, 24, 48, 2400, 1072, 64
LONG_SIZES = ((3, 3), (5, 5))
LONG_PERIODS = (511, 168, 24, 7)  # the dynamic kernel shape: K=4, Lp 1023, p_cap 511
LONG_DENSE = (25, 171)  # the daily and weekly periods' exact extents: Lp 525 and 513
LONG_REQUESTS = 50  # timed long requests, eager and replayed
LONG_WARMUP, LONG_STEPS, LONG_MEM_STEPS = 3, 20, 10  # long training steps, each path
LONG_HOST_STEPS = 20  # resident losses held against the host pipeline's eager steps
LONG_PARITY_B = 16  # rows of the float32 card-vs-CPU long step
LONG_ITERS = 20  # calls a long-context kernel timing takes
TRAIN_ONCE_EPOCHS, TRAIN_ONCE_LONG_EPOCHS = 3, 1  # train_once's epochs on each recipe
PREDICT_CHUNK, PREDICT_CHUNK_LONG = 64, 16  # rows a chunk of the chunked predict: 3 a file


def eager(obj):
    """``obj``, an ``Engine`` or a ``Forecaster``, set to dispatch op by op
    on the card (``Engine.cuda_graphs = False``): phases 4-8 and the eager
    references of phases 9-11, the yardstick of the graphs."""

    getattr(obj, "engine", obj).cuda_graphs = False
    return obj


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


class Recipe(NamedTuple):
    """One recipe as the phases take it: the merged config ``train_once``
    builds from its YAML, and from its ``train:`` and ``data:`` blocks the
    schedule, the engine's settings and the calendar features."""

    merged: dict
    schedule: dict  # lr, epochs, warmup_steps, eta_min
    engine: dict  # Engine keyword arguments
    time_features: dict


def load_recipes() -> dict:
    """Read configs/demand_benchmark.yaml (``"flagship"``, 192 series) and
    configs/long_context.yaml (``"long"``, 48 series) through the port's
    config layer (``build.merged_config_from_yaml``)."""

    from flow_timesnet_tpu_torch.build import merged_config_from_yaml

    def recipe(path: str, num_series: int) -> Recipe:
        merged = merged_config_from_yaml(str(REPO / "configs" / path))
        t = merged["train"]
        return Recipe(
            merged,
            dict(lr=float(t["lr"]), epochs=int(t["epochs"]),
                 warmup_steps=int(t["lr_warmup_steps"]),
                 eta_min=float(t["lr_scheduler"]["eta_min"])),
            dict(use_loss_masking=bool(t["use_loss_masking"]),
                 grad_clip_norm=float(t["grad_clip_norm"]), weight_decay=float(t["weight_decay"]),
                 ema_decay=float(t.get("ema_decay", 0.0) or 0.0), num_series=num_series),
            dict(merged["data"]["time_features"]))

    return {"flagship": recipe("demand_benchmark.yaml", B),
            "long": recipe("long_context.yaml", LONG_SERIES)}


def recipe_config(rec: Recipe, static_dim: int, id_vocab: int):
    """The recipe's model (``build.timesnet_config_from_dict``), with the
    data dimensions of its benchmark."""

    from flow_timesnet_tpu_torch.build import time_feature_dim_of, timesnet_config_from_dict

    return timesnet_config_from_dict(rec.merged, static_dim=static_dim,
                                     time_feature_dim=time_feature_dim_of(rec.merged),
                                     id_vocab=id_vocab)


def flagship_config(rec: Recipe):
    """The ``model:`` block of configs/demand_benchmark.yaml, with the data
    dimensions of its 192-series benchmark (5 static features, 8 cyclical
    calendar features)."""

    return recipe_config(rec, 5, B)


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
    ``PROFILER_TRIES`` sessions in all; then the run fails. Late in a long
    process a session can lose the same number of records every time (11
    of 100 launches, session after session, on an H100): each retry takes
    twice the calls of the one before (at most ``8 * iters``), so that such
    a loss is a smaller share of the session."""

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_TRIES):
        calls = iters * 2 ** min(attempt, 3)
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, whole = 0.0, True
        for e in prof.key_averages():
            if e.device_type.name != "CUDA" or e.count == 0:
                continue
            per_call = max(1, round(e.count / calls))  # every call launches the same kernels
            if e.count != per_call * calls:
                print(f"[time] the profiler recorded {e.count} launches of {e.key[:60]} in "
                      f"{calls} calls")
                whole = whole and e.count >= 0.9 * per_call * calls
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


def measure(torch, kernel, plain, lib, bnd, iters: int = 100) -> dict:
    """One kernel's numbers on one set of inputs, under the keys of the
    ``kernels`` line: device time of the kernel, of its plain version and of
    cuDNN (``lib``); the bound ``bnd`` = (ms, bound_by, ms counting all
    taps); and the time of a call back to back, of the kernel and of cuDNN,
    each over ``iters`` calls. ``plain`` None leaves the plain version
    untimed (``plain_ms`` None)."""

    b_ms, b_by, b_all = bnd
    return {"ms": time_ms(torch, kernel, iters),
            "plain_ms": None if plain is None else time_ms(torch, plain, iters=20),
            "library_ms": time_ms(torch, lib, iters), "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_all_taps": b_all, "call_ms": call_ms(torch, kernel, iters),
            "library_call_ms": call_ms(torch, lib, iters)}


def mean_of(np, rows) -> dict:
    """:func:`measure`'s numbers averaged over the period sets."""

    return {k: rows[0][k] if isinstance(rows[0][k], str) else float(np.mean([r[k] for r in rows]))
            for k in rows[0]}


def described(t: dict) -> str:
    plain = "not timed" if t["plain_ms"] is None else f"{t['plain_ms'] * 1e3:.2f} us"
    return (f"kernel {t['ms'] * 1e3:.2f} us (a call back to back {t['call_ms'] * 1e3:.2f} us), "
            f"plain {plain}, cuDNN {t['library_ms'] * 1e3:.2f} us (a call "
            f"back to back {t['library_call_ms'] * 1e3:.2f} us), bound {t['bound_ms'] * 1e3:.3f} "
            f"us ({t['bound_by']}; {t['bound_ms_all_taps'] * 1e3:.3f} us counting all taps)")


def valid_taps(periods, kh: int, kw: int, lp: int = LP, seq_len: int = L) -> int:
    """(output row, tap) pairs inside the fold grid of a ``seq_len``-step
    sequence, over the K candidates and ``lp`` rows each (``Lp`` on the
    dynamic path, ``total`` at the exact extent)."""

    total = 0
    for p in periods:
        cycles = -(-seq_len // p)
        for t in range(lp):
            row, col = divmod(t, p)
            total += sum(
                1 for dc in range(-(kh // 2), kh // 2 + 1) if 0 <= row + dc < cycles
            ) * sum(1 for dj in range(-(kw // 2), kw // 2 + 1) if 0 <= col + dj < p)
    return total


def bound(periods, kh: int, kw: int, dtype: str, batch: int = B, kind: str = "fwd",
          lp: int = LP, seq_len: int = L):
    """Least time for one call on an H100 SXM: each input read once and the
    output written once over the memory rate, against the multiply-adds of
    the taps that these periods leave inside the grid over the peak rate of
    the input type. ``kind``: the forward (h, W, bias in; float32 out), the
    dh adjoint (ct, W in; float32 dh out) or the weight gradient (h, ct in;
    float32 dW out); all three do one multiply-add per valid (row, tap)
    pair and channel pair. K is ``len(periods)``, each over ``lp`` rows of
    a ``seq_len``-step fold. Returns (ms, bound_by, ms counting all kh*kw taps)."""

    k = len(periods)
    elt = 2 if dtype == "bfloat16" else 4
    act, w = k * batch * lp * C, kh * kw * C * C
    nbytes = {
        "fwd": act * elt + w * elt + C * 4 + 2 * k * 4 + act * 4,
        "dh": act * elt + w * elt + 2 * k * 4 + act * 4,
        "dw": 2 * act * elt + 2 * k * 4 + w * 4,
    }[kind]
    ops = 2 * batch * C * C * valid_taps(periods, kh, kw, lp, seq_len)
    ops_all = 2 * k * batch * lp * kh * kw * C * C
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    t_all = max(t_mem, ops_all / PEAK_OPS_PER_S[dtype])
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations"), 1e3 * t_all


def library_conv(torch, F, h, periods, weight, bias, kh, kw, seq_len: int = L):
    """cuDNN over each candidate's exact [cycles, p] grid of a
    ``seq_len``-step fold: the yardstick.

    Returns the K convolution calls (grids built beforehand) and a function
    that scatters their output back to the [K, B, Lp, Cout] fold layout."""

    grids, calls = [], []
    batch = h.shape[1]
    w = weight.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    for k, p in enumerate(periods):
        cycles = -(-seq_len // p)
        grid = h[k, :, : cycles * p].reshape(batch, cycles, p, C).permute(0, 3, 1, 2).contiguous()
        grids.append((grid, cycles, p))
        calls.append(lambda g=grid: F.conv2d(g, w, bias, padding=(kh // 2, kw // 2)))

    def run():
        return [c() for c in calls]

    def unfold(outs):
        return [o.permute(0, 2, 3, 1).reshape(batch, cyc * p, C)
                for o, (_, cyc, p) in zip(outs, grids)]

    return run, unfold


def library_conv_bwd(torch, h, ct, periods, weight, kh, kw, batch, seq_len: int = L):
    """cuDNN's convolution backward over each candidate's exact [cycles, p]
    grid of a ``seq_len``-step fold: the yardstick of the dh and dW kernels.
    Returns the K ``conv2d_input`` calls, the K ``conv2d_weight`` calls
    (grids built beforehand) and the grids' extents."""

    from torch.nn import grad as nn_grad

    w = weight.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    pad = (kh // 2, kw // 2)
    grids = []
    for k, p in enumerate(periods):
        cycles = -(-seq_len // p)

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


def check_fwd_f32_plan(cuda_fold, batch: int, kh: int, kw: int) -> None:
    """The float32 forward's plan at this shape: the wrapper's mirror must
    equal the kernel's own."""

    plan = cuda_fold.fwd_f32_plan(K, batch, LP, C, C, kh, kw, P_MAX)
    check(cuda_fold.fwd_f32_plan_of_kernel(K, batch, LP, C, C, kh, kw, P_MAX) == plan,
          f"tap_conv_fwd {kh}x{kw} B={batch}: the wrapper's plan differs from the kernel's")
    print(f"[kernel] tap_conv_fwd {kh}x{kw} float32 B={batch} plan (the kernel's own): "
          f"{plan._asdict()}")


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


def check_forward(torch, fold, cuda_fold, h, geom, weight, bias, kh, kw, label: str) -> float:
    """Holds the forward kernel of h's dtype against its plain version over
    every row of Lp, and the float32 kernel (fixed order of summation)
    against a second launch for the same bits. Fails the run on either;
    returns the largest difference."""

    got = cuda_fold.tap_conv_cuda(h, geom, weight, bias, kh, kw)
    want = fold.tap_conv(h, geom, weight, bias, kh, kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=TOL, atol=TOL))
    f32 = h.dtype == torch.float32
    same = not f32 or torch.equal(got, cuda_fold.tap_conv_cuda(h, geom, weight, bias, kh, kw))
    print(f"[kernel] {label} {str(h.dtype)[6:]}: max |kernel - plain| {err:.3e} over all "
          f"{h.shape[2]} rows {'ok' if ok else 'FAIL'}"
          + (f", the same bits twice: {same}" if f32 else ""))
    check(ok, f"tap_conv_fwd {label} {h.dtype} disagrees with the plain version: "
              f"{err:.3e} > {TOL}")
    check(same, f"tap_conv_fwd {label} float32: the bits differ from run to run")
    return err


def time_forward(torch, F, fold, cuda_fold, h, geom, periods, weight, bias, kh, kw,
                 plain=True, iters: int = 100):
    """:func:`measure` of the forward kernel on these inputs; the route is
    that of their dtype; ``plain`` False leaves the plain version untimed."""

    run, _ = library_conv(torch, F, h, periods, weight.to(h.dtype), bias.to(h.dtype), kh, kw,
                          geom.L)
    dtype = "bfloat16" if h.dtype == torch.bfloat16 else "float32"
    return measure(
        torch,
        lambda: cuda_fold.tap_conv_cuda(h, geom, weight, bias, kh, kw),
        (lambda: fold.tap_conv(h, geom, weight, bias, kh, kw)) if plain else None, run,
        bound(periods, kh, kw, dtype, h.shape[1], lp=h.shape[2], seq_len=geom.L), iters)


def before_line(np, kind: str, key: str, rows, periods, batch: int) -> str:
    """A float32 kernel's mean over the period sets beside its previous
    design's time, cuDNN's and its bound."""

    mean = mean_of(np, rows)
    return (f"[time] {kind}_f32 {key} B={batch} over the periods {periods}: kernel "
            f"{mean['ms'] * 1e3:.2f} us against the previous design's "
            f"{BEFORE_F32_US[kind][[f'{a}x{b}' for a, b in KERNEL_SIZES].index(key)]:.2f} us, "
            f"cuDNN {mean['library_ms'] * 1e3:.2f} us, bound {mean['bound_ms'] * 1e3:.3f} us "
            f"({mean['ms'] / mean['library_ms']:.2f}x cuDNN)")


def time_backward(torch, fold, cuda_fold, h, ct, geom, periods, weight, kh, kw,
                  kinds=("dh", "dw"), plain=True, iters: int = 100):
    """:func:`measure` of the dh and dW kernels (``kinds``) on these inputs,
    by kind; each takes the route of their dtype; ``plain`` False leaves the
    plain versions untimed."""

    run_dh, run_dw, _ = library_conv_bwd(torch, h, ct, periods, weight.to(h.dtype), kh, kw,
                                         h.shape[1], geom.L)
    dtype = "bfloat16" if h.dtype == torch.bfloat16 else "float32"
    out = {}
    for kind, kernel, plain_fn, lib in (
        ("dh", lambda: cuda_fold.tap_conv_dh_cuda(ct, geom, weight, kh, kw),
         lambda: fold.tap_conv_dh(ct, geom, weight, kh, kw), run_dh),
        ("dw", lambda: cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw),
         lambda: fold.tap_weight_grad(h, geom, ct, kh, kw), run_dw),
    ):
        if kind not in kinds:
            continue
        out[kind] = measure(torch, kernel, plain_fn if plain else None, lib,
                            bound(periods, kh, kw, dtype, h.shape[1], kind, h.shape[2], geom.L),
                            iters)
    return out


def check_dense_kernels(torch, F, fold, cuda_fold, gen, dev) -> dict:
    """Phase 3, the exact extent: every route of the three kernels on the
    frozen-period path's geometry (``make_dense_geometry``: K=1, Lp=total,
    p_max=p) at p=7 (Lp 28) and p=27 (Lp 54), the forward at B=192 and dh
    and dW at B=256, bf16 and float32. Each plan must equal its mirror; each
    kernel its plain version within 1e-4 over every row (dW: rtol 1e-4 and
    1e-4 of its largest value), with the same bits twice; in float32 each
    must equal cuDNN's conv2d forward and backward over the grid within
    1e-3. Returns ``{name: {"max_abs_err": e}}``; :func:`time_dense_kernels`
    adds the times."""

    out = {}
    for kh, kw in KERNEL_SIZES:
        key = f"{kh}x{kw}"
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        for p in DENSE_PERIODS:
            geom = fold.make_dense_geometry(p, L, dev)
            lp = geom.Lp
            check(geom.p_max == p and int(geom.total[0]) == lp == L + (-L) % p,
                  f"dense geometry at p={p}: {geom.Lp}, {geom.p_max}")
            fwd, bwd = (1, B, lp, C, C, kh, kw, p), (1, B_TRAIN, lp, C, C, kh, kw, p)
            plans = (("tap_conv_fwd_mma", cuda_fold.fold_mma_plan(1, *fwd),
                      cuda_fold.fold_mma_plan_of_kernel(1, *fwd)),
                     ("tap_conv_dh_mma", cuda_fold.fold_mma_plan(-1, *bwd),
                      cuda_fold.fold_mma_plan_of_kernel(-1, *bwd)),
                     ("tap_conv_dw_mma", cuda_fold.dw_mma_plan(*bwd),
                      cuda_fold.dw_mma_plan_of_kernel(*bwd)),
                     ("tap_conv_fwd", cuda_fold.fwd_f32_plan(*fwd),
                      cuda_fold.fwd_f32_plan_of_kernel(*fwd)),
                     ("tap_conv_dh", cuda_fold.dh_f32_plan(*bwd),
                      cuda_fold.dh_f32_plan_of_kernel(*bwd)),
                     ("tap_conv_dw", cuda_fold.dw_f32_plan(*bwd[:-1]),
                      cuda_fold.dw_f32_plan_of_kernel(*bwd[:-1])))
            for name, plan, own in plans:
                check(plan == own,
                      f"{name} {key} p={p}: the wrapper's plan differs from the kernel's")
                print(f"[kernel] exact extent {name} {key} p={p} Lp={lp} plan (the kernel's own): "
                      f"{plan._asdict()}")
            h32 = torch.randn((1, B, lp, C), generator=gen, device=dev)
            hb32, ct32 = (torch.randn((1, B_TRAIN, lp, C), generator=gen, device=dev)
                          for _ in range(2))
            for dtype in (torch.bfloat16, torch.float32):
                route = "mma" if dtype == torch.bfloat16 else "f32"
                h, hb, ct = h32.to(dtype), hb32.to(dtype), ct32.to(dtype)
                runs = [(cuda_fold.tap_conv_cuda(h, geom, weight, bias, kh, kw),
                         cuda_fold.tap_conv_dh_cuda(ct, geom, weight, kh, kw),
                         cuda_fold.tap_conv_dw_cuda(hb, geom, ct, kh, kw)) for _ in range(2)]
                wants = (fold.tap_conv(h, geom, weight, bias, kh, kw),
                         fold.tap_conv_dh(ct, geom, weight, kh, kw),
                         fold.tap_weight_grad(hb, geom, ct, kh, kw))
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(*runs))
                line = []
                for kind, got, want in zip(("fwd", "dh", "dw"), runs[0], wants):
                    err = float((got - want).abs().max())
                    atol = TOL * float(want.abs().max()) if kind == "dw" else TOL
                    ok = bool(torch.allclose(got, want, rtol=TOL, atol=atol))
                    name = f"{kind}_{route}_{key}"
                    entry = out.setdefault(name, {"max_abs_err": 0.0})
                    entry["max_abs_err"] = max(entry["max_abs_err"], err)
                    line.append(f"{kind} {err:.3e} {'ok' if ok else 'FAIL'}")
                    check(ok, f"exact extent {name} p={p}: {err:.3e} against the plain version")
                print(f"[kernel] exact extent {key} p={p} Lp={lp} {str(dtype)[6:]}: max |kernel - "
                      f"plain| over every row: {', '.join(line)}; the same bits twice: {same}")
                check(same, f"exact extent {key} p={p} {dtype}: the bits differ from run to run")
            # float32 against cuDNN over the grid, forward and backward
            run, unfold = library_conv(torch, F, h32, (p,), weight, bias, kh, kw)
            got = cuda_fold.tap_conv_cuda(h32, geom, weight, bias, kh, kw)
            err_f = float((got[0] - unfold(run())[0]).abs().max())
            run_dh, run_dw, _ = library_conv_bwd(torch, hb32, ct32, (p,), weight, kh, kw,
                                                 B_TRAIN)
            dh = cuda_fold.tap_conv_dh_cuda(ct32, geom, weight, kh, kw)
            dw = cuda_fold.tap_conv_dw_cuda(hb32, geom, ct32, kh, kw)
            err_dh = float((dh[0] - run_dh()[0].permute(0, 2, 3, 1).reshape(B_TRAIN, lp, C))
                           .abs().max())
            ref_dw = run_dw()[0].permute(2, 3, 1, 0)
            err_dw = float((dw - ref_dw).abs().max()) / max(1.0, float(ref_dw.abs().max()))
            print(f"[kernel] exact extent {key} p={p} float32 against cuDNN over the grid: "
                  f"forward {err_f:.3e}, dh {err_dh:.3e}, dW / max |dW| {err_dw:.3e}")
            check(max(err_f, err_dh, err_dw) <= 1e-3,
                  f"exact extent {key} p={p}: kernels vs cuDNN {err_f:.3e} / {err_dh:.3e} / "
                  f"{err_dw:.3e}")
    return out


def time_dense_kernels(torch, F, fold, cuda_fold, gen, dev, dense: dict) -> None:
    """Phase 8, the exact extent: each route of each kernel timed as in
    ``[time]`` at p=7 and p=27 (the forward at B=192, dh and dW at B=256),
    beside its bound over the valid taps of K=1 and Lp=total and cuDNN over
    the same grid; into ``dense[name]["p7" / "p27"]``. The plain versions,
    which ``[kernel]`` ran, are not timed: their thousands of launches a
    session are what makes the profiler lose records in later sessions."""

    for kh, kw in KERNEL_SIZES:
        key = f"{kh}x{kw}"
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        for p in DENSE_PERIODS:
            geom = fold.make_dense_geometry(p, L, dev)
            h32 = torch.randn((1, B, geom.Lp, C), generator=gen, device=dev)
            hb32, ct32 = (torch.randn((1, B_TRAIN, geom.Lp, C), generator=gen, device=dev)
                          for _ in range(2))
            for dtype in (torch.bfloat16, torch.float32):
                route = "mma" if dtype == torch.bfloat16 else "f32"
                h, hb, ct = h32.to(dtype), hb32.to(dtype), ct32.to(dtype)
                times = {"fwd": time_forward(torch, F, fold, cuda_fold, h, geom, (p,), weight,
                                             bias, kh, kw, plain=False),
                         **time_backward(torch, fold, cuda_fold, hb, ct, geom, (p,), weight,
                                         kh, kw, plain=False)}
                for kind, t in times.items():
                    dense[f"{kind}_{route}_{key}"][f"p{p}"] = t
                    print(f"[time] exact extent {kind}_{route} {key} p={p} Lp={geom.Lp} "
                          f"B={B if kind == 'fwd' else B_TRAIN}: {described(t)}")


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


def train_phase(torch, np, modules, rec, cfg, params, dev):
    """Phase 7: flagship training steps on the card. Returns the launch
    counts of the timed steps, the step p50 in ms and the periods the steps
    selected."""

    windows, engine_mod, optim, cuda_fold = modules
    train, held_out, sigma = train_data(np, windows, cfg.input_len, cfg.pred_len)
    check(len(held_out) == 8, f"{len(held_out)} held-out batches")
    sched = rec.schedule
    warmup = optim.resolve_warmup(sched["warmup_steps"], None, len(train))
    lr_ctl = optim.LRController(sched["lr"], sched["epochs"],
                                {"type": "cosine", "eta_min": sched["eta_min"]}, warmup)
    lr = lr_ctl.lr_for_epoch(1)

    def to_device(batch):
        floor = sigma[batch.series_ids.reshape(-1)].reshape(-1, 1, 1)
        return engine_mod.batch_to_device(batch, floor=floor, device=dev)

    t0 = time.perf_counter()
    host_batches = [b for _, b in zip(range(WARMUP_STEPS + TIMED_STEPS), train)]
    gather_ms = 1e3 * (time.perf_counter() - t0) / len(host_batches)
    eng = eager(engine_mod.Engine(cfg, params, **rec.engine))
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
          f"lr {lr:.4e} (epoch 1 of the cosine schedule with {sched['warmup_steps']} warm-up "
          f"steps over {len(train)} batches an epoch): step ms {spread(np, step_ms)}")
    print(f"[train] windows/s at the p50 {B_TRAIN / p50 * 1e3:.1f}, peak device memory "
          f"{peak_mib:.1f} MiB, host gather {gather_ms:.3f} ms a batch (before the timing), "
          f"launches {counts}, selected periods "
          f"{sorted(set(selected))}, loss first {losses[0]:.4f} last {losses[-1]:.4f}, "
          f"mask_true {float(stats['mask_true']):.0f} of {float(stats['mask_total']):.0f}")

    # 30 steps on one fixed batch at the schedule's base rate lower its loss
    fixed = to_device(host_batches[0])
    fit = eager(engine_mod.Engine(cfg, params, **rec.engine))
    fit_state = fit.init_state()
    fit_losses = [fit.train_step(fit_state, sched["lr"], gen, fixed)[1]
                  for _ in range(OVERFIT_STEPS)]
    fit_losses = torch.stack(fit_losses).cpu().numpy()
    last = float(np.mean(fit_losses[-5:]))
    print(f"[train] {OVERFIT_STEPS} steps on one batch at lr {sched['lr']}: loss "
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
                parity_batch=parity_batch, fixed=fixed, lr=lr, engine=eng, state=state, gen=gen,
                batches=host_batches, to_device=to_device)


def float32_steps(torch, np, engine_mod, cfg, params, engine_kw, batch, lr, dev):
    """Phase 7, float32: the flagship at full width with
    ``compute_dtype="float32"`` (the JAX package's default, which runs the
    CUDA-core fold-conv kernels) takes 5 + 20 timed steps on one batch, then
    20 under the profiler: device time per step and the fold conv's."""

    eng = eager(engine_mod.Engine(dataclasses.replace(cfg, compute_dtype="float32"), params,
                                  **engine_kw))
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


def train_parity(torch, np, engine_mod, losses_mod, cuda_fold, cfg, params, engine_kw, batch_cpu,
                 per: int = LAUNCHES_PER_PASS // len(KERNEL_SIZES), what: str = "float32 step",
                 nll: bool = True):
    """Phase 7, parity: one float32 step with dropout 0, card against CPU
    (on ``cfg``'s path: dynamic, or frozen where it carries a spec). Returns
    the card step's launches of each kernel by size: the CUDA-core routes,
    ``per`` each (12 in all on the dynamic path; the forward twice as many
    where ``cfg.use_checkpoint`` recomputes it in the backward), and none on
    a tensor-core route. On the dynamic path (and ``nll``) the NB-NLL alone
    is held card against CPU too."""

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", dropout=0.0)
    sizes = tuple(tuple(k) for k in cfg.kernel_set)
    want = {name: 0 if name.endswith("_mma") else
            per * (2 if cfg.use_checkpoint and name == "tap_conv_fwd" else 1)
            for name in path_counters(cuda_fold)}
    out = {}
    for device in ("cuda", "cpu"):
        eng = engine_mod.Engine(cfg32, params, device=device, **engine_kw)
        eng.model.train()
        batch = {k: None if v is None else v.to(device) for k, v in batch_cpu.items()}
        counters = path_counters(cuda_fold)
        for counter in counters.values():
            counter.clear()  # the float32 step's launches, from here ...
        loss, _ = eng._loss(batch, None)
        loss.backward()
        if device == "cuda":
            f32 = {name: dict(c) for name, c in counters.items()}  # ... to here
            check(all(f32[name].get(f"{kh}x{kw}", 0) == want[name]
                      for name in f32 for kh, kw in sizes),
                  f"{what} launches {f32}: {want} of each CUDA-core kernel and size, no "
                  f"tensor-core one")
        out[device] = (float(loss.detach()), {k: p.grad.cpu() for k, p in
                                              eng.model.named_parameters()})
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = out["cuda"], out["cpu"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    scale = max(1.0, max(float(g.abs().max()) for g in g_cpu.values()))
    err = max(float((g_gpu[k] - g_cpu[k]).abs().max()) for k in g_cpu)
    worst = max(g_cpu, key=lambda k: float((g_gpu[k] - g_cpu[k]).abs().max()))
    print(f"[train] {what} card vs CPU: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (relative "
          f"{rel:.3e}); max gradient difference {err:.3e} ({worst}) of max |g| {scale:.3e}")
    check(rel <= 1e-5, f"{what} loss card vs CPU {rel:.3e}")
    check(err <= 1e-4 * scale, f"{what} gradients card vs CPU {err:.3e}")
    if cfg.frozen_periods is not None or not nll:
        return f32

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


def unique_periods(spec) -> int:
    """Σ over layers of the unique valid periods of a frozen spec: each runs
    the two inception stacks once, so each kernel size launches a kernel
    2 × this many times a pass (2 × 3 × this in all)."""

    return sum(len({p for p, _, v in layer if v}) for layer in spec)


def launch_counts(cuda_fold) -> dict:
    return {name: dict(c) for name, c in path_counters(cuda_fold).items()}


def clear_counts(cuda_fold) -> None:
    """Zero the wrappers' launch counters and the kernels' run counts."""

    for counter in path_counters(cuda_fold).values():
        counter.clear()
    cuda_fold.clear_kernel_runs()


def check_launches(got: dict, kinds, per_size, mma: bool, what: str,
                   sizes=KERNEL_SIZES) -> None:
    """Each kernel of ``kinds`` launched ``per_size`` times (an int, or a
    count by kind) at every kernel size of ``sizes``, all on the route its
    dtype picks: the tensor-core one (``mma``) or none on it."""

    for kind in kinds:
        want = per_size[kind] if isinstance(per_size, dict) else per_size
        for kh, kw in sizes:
            size = f"{kh}x{kw}"
            n, n_mma = got[kind].get(size, 0), got[f"{kind}_mma"].get(size, 0)
            check(n == want and n_mma == (want if mma else 0),
                  f"{what}: {kind} {size} launched {n} times, {n_mma} on the tensor-core "
                  f"route; {want} expected, {'all' if mma else 'none'} on it")


def run_counts(cuda_fold) -> dict:
    """The fold-conv launches the card ran since :func:`clear_counts`, as
    the kernels counted them (``cuda_fold.kernel_runs``; a graph's replay,
    which runs no wrapper, counts there), in :func:`launch_counts`' form:
    each kernel over both routes, and its tensor-core route under ``_mma``.
    Waits for the card."""

    runs = cuda_fold.kernel_runs()
    out = {}
    for kind in ("fwd", "dh", "dw"):
        mma, f32 = runs[f"{kind}_mma"], runs[f"{kind}_f32"]
        out[f"tap_conv_{kind}"] = {k: mma.get(k, 0) + f32.get(k, 0) for k in {*mma, *f32}}
        out[f"tap_conv_{kind}_mma"] = dict(mma)
    return out


def check_first_call(cuda_fold, kinds, per_size, what: str, sizes=KERNEL_SIZES) -> None:
    """A graphed path's first call, on the card: the wrappers launched
    ``kinds`` ``per_size`` times (a pass) at every size, on the tensor-core
    route, in each warm-up call and in the capture, and the card ran them in
    the warm-up calls and the first replay (the capture runs nothing): (3 +
    1) x a pass in both counts; no other kind."""

    from flow_timesnet_tpu_torch import graphs

    n = {k: (graphs.WARMUP_CALLS + 1) * (per_size[k] if isinstance(per_size, dict) else per_size)
         for k in kinds}
    others = [k for k in ("tap_conv_fwd", "tap_conv_dh", "tap_conv_dw") if k not in kinds]
    for got, by in ((launch_counts(cuda_fold), "wrappers"), (run_counts(cuda_fold), "card")):
        check_launches(got, kinds, n, True, f"{what} (warm-up, capture, replay; {by})", sizes)
        check(not any(got[k] for k in others), f"{what} ({by}): {got}")


def frozen_spec(engine_mod, eng, batch, n_layers: int):
    """The frozen spec from the engine's telemetry of ``batch``, carried as a
    checkpoint carries it (nested lists in JSON) and read back with
    ``frozen_spec_from_config``; it must round-trip and hold a valid slot."""

    spec = engine_mod.Engine.frozen_spec_from_telemetry(
        eng.collect_period_telemetry(None, batch), n_layers)
    check(spec is not None, "telemetry gave no frozen spec")
    stored = json.loads(json.dumps(spec))
    back = engine_mod.Engine.frozen_spec_from_config(stored, n_layers)
    check(back == spec, f"frozen spec {spec} read back as {back}")
    check(unique_periods(back) >= 1, f"frozen spec {spec} has no valid slot")
    return back


def serve_frozen(torch, np, engine_mod, cuda_fold, make_fc, request, cfg, batch, p50_dynamic):
    """Phase 5, frozen: the spec from ``collect_period_telemetry`` on the
    serving batch, through ``frozen_spec_from_config``; the flagship
    ``Forecaster`` on it answers ``FROZEN_REQUESTS`` timed requests, each
    launching the forward 2 × 3 × Σ U times, all on the tensor-core route,
    with forecasts finite and >= 0. A float32 frozen request equals the same
    request on the CPU within 1e-4, and the float32 dynamic request on the
    card within rtol 1e-5 / atol 1e-6 when the spec is that request's live
    selection. Returns the request function, its p50, the spec and the
    launches of the timed requests and of the float32 one."""

    spec = frozen_spec(engine_mod, make_fc(cfg).engine, batch, cfg.n_layers)
    per = 2 * unique_periods(spec)
    print(f"[serve-frozen] spec {spec} (from the telemetry of the serving batch, read back "
          f"from JSON), {per} launches of each kernel size a request")
    fc = make_fc(dataclasses.replace(cfg, frozen_periods=spec))
    first = request(fc)  # warm-up: the geometry of each period is built once
    torch.cuda.synchronize()
    clear_counts(cuda_fold)  # the frozen request's launches, from here ...
    latencies, outs = [], []
    for _ in range(FROZEN_REQUESTS):
        t0 = time.perf_counter()
        outs.append(request(fc))
        latencies.append(1e3 * (time.perf_counter() - t0))
    got = launch_counts(cuda_fold)  # ... to here
    check_launches(got, ("tap_conv_fwd",), FROZEN_REQUESTS * per, True, "frozen requests")
    check(not any(got[k] for k in ("tap_conv_dh", "tap_conv_dw")), f"frozen requests {got}")
    for out in outs:
        check(out.shape == first.shape and bool(np.isfinite(out).all()) and
              bool((out >= 0).all()), "frozen forecast non-finite, negative or misshapen")
    p50 = float(np.median(latencies))
    print(f"[serve-frozen] {FROZEN_REQUESTS} requests: launches {got['tap_conv_fwd']} (tensor-"
          f"core route {got['tap_conv_fwd_mma']}), latency ms {spread(np, latencies)} (dynamic "
          f"p50 {p50_dynamic:.3f}), forecast range [{float(first.min()):.3f}, "
          f"{float(first.max()):.3f}], every request equal to the first: "
          f"{all(np.array_equal(first, o) for o in outs)}")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    dyn32 = make_fc(cfg32)
    spec32 = frozen_spec(engine_mod, dyn32.engine, batch, cfg.n_layers)
    raw = {"dynamic": request(dyn32, raw=True)}
    for device in ("cuda", "cpu"):
        f32 = make_fc(dataclasses.replace(cfg32, frozen_periods=spec32), device)
        clear_counts(cuda_fold)  # the float32 frozen request's launches, from here ...
        raw[device] = request(f32, raw=True)
        if device == "cuda":
            got32 = launch_counts(cuda_fold)  # ... to here
            print(f"[serve-frozen] float32 request launches {got32}")
            check_launches(got32, ("tap_conv_fwd",), 2 * unique_periods(spec32), False,
                           "float32 frozen request")
    for name, i in (("rate", 0), ("dispersion", 1)):
        cpu = float(np.abs(raw["cuda"][i] - raw["cpu"][i]).max())
        dyn = float(np.abs(raw["cuda"][i] - raw["dynamic"][i]).max())
        print(f"[serve-frozen] float32 {name}: card vs CPU {cpu:.3e}, frozen vs dynamic on the "
              f"card {dyn:.3e} (spec {spec32})")
        check(np.allclose(raw["cuda"][i], raw["cpu"][i], rtol=TOL, atol=TOL),
              f"float32 frozen {name} card vs CPU {cpu:.3e}")
        check(np.allclose(raw["cuda"][i], raw["dynamic"][i], rtol=1e-5, atol=1e-6),
              f"float32 frozen {name} vs dynamic {dyn:.3e}")
    return dict(request=lambda: request(fc), p50=p50, spec=spec, counts=got, counts32=got32,
                first=first)


def train_frozen(torch, np, engine_mod, cuda_fold, cfg, params, engine_kw, trained, dev):
    """Phase 7, frozen: the spec from telemetry on a training batch (the
    dynamic engine's trained state); an engine on it continues that state
    (the trainer's engine swap) for 5 + ``FROZEN_STEPS`` timed steps at
    B=256, each launching the forward, dh and dW 2 × 3 × Σ U times, on the
    tensor-core routes. Returns (a step function, its p50, the spec, the
    launches of the timed steps)."""

    eng, state, lr, gen = trained["engine"], trained["state"], trained["lr"], trained["gen"]
    spec = frozen_spec(engine_mod, eng, trained["fixed"], cfg.n_layers)
    per = 2 * unique_periods(spec)
    print(f"[train-frozen] spec {spec} (from the telemetry of a training batch, read back "
          f"from JSON), {per} launches of each kernel size a step")
    feng = eager(engine_mod.Engine(dataclasses.replace(cfg, frozen_periods=spec), params,
                                   **engine_kw))
    batches = trained["batches"][: WARMUP_STEPS + FROZEN_STEPS]
    losses = []
    for batch in batches[:WARMUP_STEPS]:
        state, loss, _ = feng.train_step(state, lr, gen, trained["to_device"](batch))
        losses.append(loss)
    torch.cuda.synchronize()
    clear_counts(cuda_fold)  # the frozen step's launches, from here ...
    step_ms = []
    for batch in batches[WARMUP_STEPS:]:
        t0 = time.perf_counter()
        state, loss, _ = feng.train_step(state, lr, gen, trained["to_device"](batch))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
    got = launch_counts(cuda_fold)  # ... to here
    check_launches(got, ("tap_conv_fwd", "tap_conv_dh", "tap_conv_dw"), FROZEN_STEPS * per, True,
                   "frozen steps")
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), "non-finite frozen training loss")
    p50 = float(np.median(step_ms))
    print(f"[train-frozen] {FROZEN_STEPS} steps of {B_TRAIN} windows (after {WARMUP_STEPS} "
          f"warm-up, continuing the dynamic run's state): step ms {spread(np, step_ms)}, "
          f"windows/s at the p50 {B_TRAIN / p50 * 1e3:.1f} (dynamic p50 {trained['p50']:.3f} ms), "
          f"launches {got}, loss first {losses[0]:.4f} last {losses[-1]:.4f}")

    def step(batch=trained["fixed"]):
        feng.train_step(state, lr, gen, batch)

    return step, p50, spec, got


def same_or_diff(torch, got, want) -> str:
    """``bitwise`` where two results agree bit for bit, else their max |diff|."""

    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return "bitwise equal"
    return f"max |diff| {max(float((a - b).abs().max()) for a, b in zip(got, want)):.3e}"


def serve_graph(torch, np, cuda_fold, make_fc, request, cfg, spec, eager_runs: dict) -> dict:
    """Phase 9: ``GRAPH_REQUESTS`` requests replayed from the forward's CUDA
    graph (the ``Forecaster`` default), on the dynamic path and on the
    frozen spec of ``[serve-frozen]``. The first request warms up,
    captures and replays (:func:`check_first_call`). Over the replayed
    requests no wrapper may count a launch, and the kernels' own counts must
    show the card running the forward 12 times a request (2 x 3 x U frozen)
    at every size, on the tensor-core route. Each replayed forecast must
    equal the eager request's of phases 4 and 5 within rtol/atol 1e-5 (they
    are expected bit for bit). Then 50 replayed requests under the
    profiler. ``eager_runs`` maps each path to its eager first forecast and
    p50. Returns each path's launches as the card counted them, p50 and
    profile."""

    out = {}
    for path, cfg_ in (("dynamic", cfg), ("frozen", dataclasses.replace(cfg, frozen_periods=spec))):
        fc = make_fc(cfg_, graphed=True)
        per = (LAUNCHES_PER_PASS // len(KERNEL_SIZES) if path == "dynamic"
               else 2 * unique_periods(spec))
        clear_counts(cuda_fold)  # the first request's launches, from here ...
        t0 = time.perf_counter()
        first = request(fc)  # warm-up calls, then the capture, then the first replay
        capture_ms = 1e3 * (time.perf_counter() - t0)
        check_first_call(cuda_fold, ("tap_conv_fwd",), per, f"first {path} request")  # ... to here
        check(len(fc.engine._graphs) == 1, f"{path}: {len(fc.engine._graphs)} graphs for one request")
        clear_counts(cuda_fold)  # the replayed requests' launches, from here ...
        latencies, outs = [], []
        for _ in range(GRAPH_REQUESTS):
            t0 = time.perf_counter()
            outs.append(request(fc))
            latencies.append(1e3 * (time.perf_counter() - t0))
        wrapped, got = launch_counts(cuda_fold), run_counts(cuda_fold)  # ... to here
        check(not any(wrapped.values()), f"replayed {path} requests ran a wrapper: {wrapped}")
        check_launches(got, ("tap_conv_fwd",), GRAPH_REQUESTS * per, True,
                       f"replayed {path} requests (the card's count)")
        check(not any(got[k] for k in ("tap_conv_dh", "tap_conv_dw")), f"{path} requests {got}")
        want = eager_runs[path]["forecast"]
        diff = max(float(np.abs(o - want).max()) for o in [first] + outs)
        bitwise = all(np.array_equal(o, want) for o in [first] + outs)
        check(all(np.allclose(o, want, rtol=1e-5, atol=1e-5) for o in [first] + outs),
              f"replayed {path} forecast against the eager one: {diff:.3e}")
        p50 = float(np.median(latencies))
        print(f"[serve-graph] {path}: first request (warm-up, capture, replay) {capture_ms:.1f} ms; "
              f"{GRAPH_REQUESTS} replayed requests: latency ms {spread(np, latencies)} against the "
              f"eager p50 {eager_runs[path]['p50']:.3f} ({eager_runs[path]['p50'] / p50:.2f}x); forecasts "
              f"against the eager request: max |diff| {diff:.3e} (bitwise: {bitwise}); launches "
              f"the card counted {got['tap_conv_fwd']} (tensor-core route "
              f"{got['tap_conv_fwd_mma']}), the wrappers none")
        prof = profile(torch, lambda: request(fc), PROFILED, f"replayed {path} request", p50)
        out[path] = dict(counts=got, p50=p50, profile=prof)
    return out


def train_graph(torch, np, engine_mod, cuda_fold, cfg, params, engine_kw, trained, spec,
                eager_p50: dict) -> dict:
    """Phase 10: training steps replayed from the step's CUDA graph (the
    ``Engine.train_step`` default), against eager steps from the same
    initial state and generator seed on the same batches: ``WARMUP_STEPS +
    GRAPH_STEPS`` dynamic steps, then as many frozen ones on
    ``[train-frozen]``'s spec continuing the same state (the trainer's
    swap). Losses must agree within 1e-5 relative, and the parameters and
    EMA afterwards within 1e-4 of the largest (expected bit for bit). The
    replayed steps are timed as ``[train]`` times the eager ones (host clock
    over ``batch_to_device`` + ``train_step``, synchronised per step). At
    every step the launches are counted twice, by the wrappers and by the
    kernels on the card: an eager step launches and runs the forward, dh and
    dW 12 times each (2 x 3 x U frozen) at every size, on the tensor-core
    routes; the first replayed step is :func:`check_first_call`'s; a later
    one runs no wrapper and runs each kernel on the card as an eager step
    does. Then 20 replayed steps of each path under the profiler. Returns
    each path's launches over the timed replayed steps as the card counted
    them, p50 and profile."""

    lr, to_device = trained["lr"], trained["to_device"]
    batches = trained["batches"][: WARMUP_STEPS + GRAPH_STEPS]
    cfgs = {"dynamic": cfg, "frozen": dataclasses.replace(cfg, frozen_periods=spec)}
    kinds = ("tap_conv_fwd", "tap_conv_dh", "tap_conv_dw")
    runs = {}
    for graphed in (False, True):
        engines = {path: engine_mod.Engine(c, params, **engine_kw) for path, c in cfgs.items()}
        if not graphed:
            for eng in engines.values():
                eager(eng)
        state = engines["dynamic"].init_state()
        gen = torch.Generator(device=DEVICE).manual_seed(11)
        rec = {}
        for path, eng in engines.items():
            per = (LAUNCHES_PER_PASS // len(KERNEL_SIZES) if path == "dynamic"
                   else 2 * unique_periods(spec))
            losses, ms, timed = [], [], {k: {} for k in path_counters(cuda_fold)}
            for i, batch in enumerate(batches):
                clear_counts(cuda_fold)  # this step's launches, from here ...
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss, _ = eng.train_step(state, lr, gen, to_device(batch))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(loss)
                what = f"{'replayed' if graphed else 'eager'} {path} step {i}"
                if graphed and i == 0:
                    check_first_call(cuda_fold, kinds, per, what)
                    continue
                wrapped, ran = launch_counts(cuda_fold), run_counts(cuda_fold)  # ... to here
                if graphed:
                    check(not any(wrapped.values()), f"{what} ran a wrapper: {wrapped}")
                else:
                    check_launches(wrapped, kinds, per, True, f"{what} (wrappers)")
                check_launches(ran, kinds, per, True, f"{what} (card)")
                if i >= WARMUP_STEPS:
                    for k, by_size in ran.items():
                        for size, n in by_size.items():
                            timed[k][size] = timed[k].get(size, 0) + n
            rec[path] = dict(losses=torch.stack(losses), ms=ms[WARMUP_STEPS:], engine=eng,
                             counts=timed)
        runs[graphed] = dict(rec=rec, state=state, gen=gen)
    g, e = runs[True], runs[False]
    got_t, want_t = ([t.detach() for t in r["state"].tensors()] for r in (g, e))
    scale = max(1.0, max(float(t.abs().max()) for t in want_t))
    state_diff = max(float((a - b).abs().max()) for a, b in zip(got_t, want_t))
    print(f"[train-graph] after {len(batches)} dynamic and {len(batches)} frozen steps: "
          f"parameters, Adam moments and EMA replayed against eager "
          f"{same_or_diff(torch, got_t, want_t)}")
    check(state_diff <= 1e-4 * scale, f"replayed state against eager: {state_diff:.3e}")
    out = {}
    for path in cfgs:
        got, want = g["rec"][path], e["rec"][path]
        rel = float(((got["losses"] - want["losses"]).abs() / want["losses"].abs()).max())
        check(rel <= 1e-5, f"replayed {path} losses against eager: {rel:.3e} relative")
        per = (LAUNCHES_PER_PASS // len(KERNEL_SIZES) if path == "dynamic"
               else 2 * unique_periods(spec))
        eng, state, gen, counts = got["engine"], g["state"], g["gen"], got["counts"]
        check_launches(counts, kinds, GRAPH_STEPS * per, True, f"replayed {path} steps (card)")
        p50, p50_here = float(np.median(got["ms"])), float(np.median(want["ms"]))
        print(f"[train-graph] {path}: {GRAPH_STEPS} replayed steps of {B_TRAIN} windows (after "
              f"{WARMUP_STEPS}, the first of which captured): step ms {spread(np, got['ms'])}, "
              f"windows/s at the p50 {B_TRAIN / p50 * 1e3:.1f}; eager in this phase p50 "
              f"{p50_here:.3f} ({B_TRAIN / p50_here * 1e3:.1f} windows/s, {p50_here / p50:.2f}x), "
              f"[train{'-frozen' if path == 'frozen' else ''}] p50 {eager_p50[path]:.3f}; losses "
              f"against eager: {same_or_diff(torch, got['losses'], want['losses'])} (max relative "
              f"{rel:.3e}), first {float(got['losses'][0]):.4f} last "
              f"{float(got['losses'][-1]):.4f}; launches the card counted in the {GRAPH_STEPS} "
              f"replayed steps: forward {counts['tap_conv_fwd']}, dh {counts['tap_conv_dh']}, "
              f"dW {counts['tap_conv_dw']} (tensor-core dW {counts['tap_conv_dw_mma']}), the "
              f"wrappers none")
        prof = profile(torch, lambda: eng.train_step(state, lr, gen, trained["fixed"]),
                       PROFILED_STEPS, f"replayed {path} step", p50)
        out[path] = dict(counts=counts, p50=p50, profile=prof)
    return out


def clone_state(torch, src, dst) -> None:
    """Copy a ``TrainState``'s tensors into another engine's state of the
    same model: the eager reference starts where the resident run starts."""

    with torch.no_grad():
        for d, s_ in zip(dst.tensors(), src.tensors()):
            d.copy_(s_)


def train_resident(torch, np, windows, dw, engine_mod, cuda_fold, cfg, params, engine_kw,
                   lr) -> dict:
    """Phase 11: the device-resident epoch, driven as the JAX package's
    trainer drives it (``train.py:923-1071``). The 192-series data of phase
    7 are staged on the card once (the batchers' own sources, as
    ``_stage_from_batcher`` stages them); each epoch takes a shuffled plan
    (``epoch_index_plan``, the batcher's permutation), the staged probe on
    the dynamic engine (held against ``collect_period_telemetry`` of the
    host batch of the same windows: the same periods), then
    ``train_epoch_resident``: 215 replays of one graph, a step each.
    Epochs 1-2 run the dynamic engine, epochs 3-4 a frozen engine on epoch
    3's probe (the trainer's ``maybe_freeze``), continuing the state. The
    launches of each epoch are counted twice, by the wrappers and by the
    kernels on the card. The first epoch of each path captures: the
    wrappers must count (3 + 1) x a step's launches of the forward, dh and
    dW (12 each, 2 x 3 x U frozen; warm-up and capture), the card (3 + S) x
    (warm-up and replays). The second runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (nothing may wait for the
    card): no wrapper may count a launch, and the card must count S x a
    step's, at every size, on the tensor-core routes. Epochs 1 and 3 are also run on the host
    pipeline (``WindowBatcher`` -> ``batch_to_device`` -> eager
    ``train_step``, timed) from a copy of the same state and generator: its
    losses (the same windows in the same order) must equal the resident
    ones within 1e-5 relative. ``evaluate_resident`` (EMA) over the 8
    held-out batches must equal ``evaluate`` over the host batches within
    1e-5 relative, after epochs 2 and 4, each followed by a 20-step chunk
    of its path under the profiler. Returns each path's launches in its
    second epoch as the card counted them, epoch seconds, the host
    pipeline's epoch seconds, peak memory and profile."""

    from flow_timesnet_tpu_torch import graphs

    train, held_out, sigma = train_data(np, windows, cfg.input_len, cfg.pred_len)

    def stage(batcher):
        src = batcher.sources
        s0 = src[0]
        return dw.stage_windows([s.X for s in src], [s.M for s in src], s0.L, s0.H, s0.stride,
                                "direct", marks=[s.marks for s in src], static=s0.static,
                                sigma_vector=sigma, device=DEVICE)

    def to_device(batch):
        floor = sigma[batch.series_ids.reshape(-1)].reshape(-1, 1, 1)
        return engine_mod.batch_to_device(batch, floor=floor, device=DEVICE)

    staged, staged_val = stage(train), stage(held_out)
    check(staged.total == train.total and staged_val.total == held_out.total,
          f"staged {staged.total} / {staged_val.total} windows, batched {train.total} / "
          f"{held_out.total}")
    val_idx, val_rv = dw.epoch_index_plan(staged_val.total, B_TRAIN, shuffle=False,
                                          drop_last=False)
    probe_idx, probe_rv = dw.epoch_index_plan(staged.total, B_TRAIN, shuffle=False,
                                              drop_last=True)
    check(len(val_idx) == 8 and val_rv[-1].min() == 0.0, f"{len(val_idx)} held-out batches")
    staged_mib = sum(t.numel() * t.element_size() for t in (
        staged.X, staged.M, staged.marks, staged_val.X, staged_val.M, staged_val.marks)) / 2**20
    probe_batch = to_device(train._gather_global(probe_idx[0].astype(np.int64)))

    dyn = engine_mod.Engine(cfg, params, **engine_kw)
    state, gen = dyn.init_state(), torch.Generator(device=DEVICE).manual_seed(21)
    eng, path, spec = dyn, "dynamic", None
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for ep in (1, 2, 3, 4):
        tele = dyn.collect_period_telemetry_staged(None, staged, probe_idx[0], probe_rv[0])
        want = dyn.collect_period_telemetry(None, probe_batch)
        check(all(np.array_equal(tele[b][k], want[b][k]) for b in want for k in want[b]),
              f"epoch {ep}: the staged probe {tele} against the eager one {want}")
        if ep == 3:  # maybe_freeze: the spec of this epoch's probe
            spec = engine_mod.Engine.frozen_spec_from_telemetry(tele, cfg.n_layers)
            check(spec is not None and unique_periods(spec) >= 1, f"probe spec {spec}")
            eng = engine_mod.Engine(dataclasses.replace(cfg, frozen_periods=spec), params,
                                    **engine_kw)
            path = "frozen"
        idx, rv = dw.epoch_index_plan(staged.total, B_TRAIN, shuffle=True, drop_last=True,
                                      rng=np.random.default_rng([0, ep]))
        S = len(idx)
        first = ep in (1, 3)
        if first:  # the eager reference: the same state, generator and windows
            ref = eager(engine_mod.Engine(eng.cfg, params, **engine_kw))
            ref_state = ref.init_state()
            clone_state(torch, state, ref_state)
            ref_gen = torch.Generator(device=DEVICE)
            ref_gen.set_state(gen.get_state())
        clear_counts(cuda_fold)  # this epoch's launches, from here ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_d, rv_d = torch.from_numpy(idx).to(DEVICE), torch.from_numpy(rv).to(DEVICE)
        if not first:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, losses, mask_true = eng.train_epoch_resident(state, lr, gen, staged, idx_d,
                                                                rv_d)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses, mask_true = losses.cpu().numpy(), mask_true.cpu().numpy()  # one fetch
        seconds = time.perf_counter() - t0
        wrapped, ran = launch_counts(cuda_fold), run_counts(cuda_fold)  # ... to here
        per = (LAUNCHES_PER_PASS // len(KERNEL_SIZES) if path == "dynamic"
               else 2 * unique_periods(spec))
        kinds = ("tap_conv_fwd", "tap_conv_dh", "tap_conv_dw")
        check(bool(np.isfinite(losses).all()) and len(losses) == S, f"epoch {ep} losses")
        line = (f"[train-resident] epoch {ep} ({path}{', capture included' if first else ''}): "
                f"{S} steps of {B_TRAIN} in {seconds:.3f} s, {S * B_TRAIN / seconds:.1f} windows/s, "
                f"loss mean {losses.mean():.4f}, mask_true {mask_true.sum():.0f}")
        if first:  # the same epoch on the host pipeline: batcher, copies, eager steps
            train.set_epoch(ep)  # the plan's permutation: the same windows in the same order
            t0 = time.perf_counter()
            want_l = []
            for batch in train:
                ref_state, loss, _ = ref.train_step(ref_state, lr, ref_gen, to_device(batch))
                want_l.append(loss)
            want_l = torch.stack(want_l).cpu().numpy()
            eager_s = time.perf_counter() - t0
            rel = float(np.max(np.abs(losses - want_l) / np.abs(want_l)))
            line += (f"; the host pipeline's eager epoch from the same state {eager_s:.3f} s "
                     f"({S * B_TRAIN / eager_s:.1f} windows/s, {eager_s / seconds:.2f}x), its "
                     f"{len(want_l)} losses against these: max relative {rel:.3e} (bitwise: "
                     f"{bool(np.array_equal(losses, want_l))})")
            check(len(want_l) == S and rel <= 1e-5,
                  f"epoch {ep}: resident losses against eager {rel:.3e}")
            warm = graphs.WARMUP_CALLS
            check_launches(wrapped, kinds, (warm + 1) * per, True,
                           f"resident epoch {ep} (wrappers: warm-up and capture)")
            check_launches(ran, kinds, (warm + S) * per, True,
                           f"resident epoch {ep} (card: warm-up and {S} replays)")
            out[path] = {"eager_seconds": eager_s}
        else:
            check(not any(wrapped.values()), f"resident epoch {ep} ran a wrapper: {wrapped}")
            check_launches(ran, kinds, S * per, True, f"resident epoch {ep} (card)")
            line += (f"; no synchronising call, no wrapper launch; launches the card counted: "
                     f"forward {ran['tap_conv_fwd']}, dh {ran['tap_conv_dh']}, dW "
                     f"{ran['tap_conv_dw']} (tensor-core dW {ran['tap_conv_dw_mma']})")
            res = eng.evaluate_resident(state.ema, staged_val, val_idx, val_rv)
            host = eng.evaluate(state.ema, [to_device(b) for b in held_out])
            ok = all(abs(res[k] - host[k]) <= 1e-5 * abs(host[k]) for k in ("nll", "smape"))
            line += (f"; evaluate_resident (EMA, {len(val_idx)} batches) nll {res['nll']:.6f} "
                     f"smape {res['smape']:.6f}, host evaluate nll {host['nll']:.6f} smape "
                     f"{host['smape']:.6f}")
            check(ok and np.isfinite(res["nll"]), f"epoch {ep}: evaluate_resident {res} / {host}")
            out[path].update(counts=ran, seconds=seconds, steps=S,
                             peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        print(line)
        if not first:  # a chunk of this path's resident steps under the profiler
            chunk = [torch.from_numpy(a[:RESIDENT_CHUNK]).to(DEVICE) for a in (idx, rv)]
            out[path]["profile"] = profile(
                torch, lambda: eng.train_epoch_resident(state, lr, gen, staged, *chunk), 1,
                f"{RESIDENT_CHUNK}-step {path} resident chunk", 1e3 * seconds / S * RESIDENT_CHUNK)
    print(f"[train-resident] spec {spec}; staged arrays {staged_mib:.2f} MiB; peak device memory "
          f"{out['dynamic']['peak_mib']:.1f} MiB after the dynamic epochs, "
          f"{out['frozen']['peak_mib']:.1f} MiB after the frozen ones (the profiled chunks add "
          f"{RESIDENT_CHUNK} steps to the run after epochs 2 and 4)")
    return out


# -- the long-context recipe (configs/long_context.yaml) ---------------------------

def long_config(rec: Recipe):
    """The ``model:`` block of configs/long_context.yaml, with ``use_checkpoint``
    from its ``train:`` block and the data dimensions of its hourly benchmark
    (48 series, the cyclical ``[day_of_week, hour]`` features, no static
    features)."""

    return recipe_config(rec, 0, LONG_SERIES)


def long_data(np):
    """The hourly benchmark of ``tools/make_long_context_benchmark.py`` at
    48 series x 2,400 hours in all (:func:`simulate_long`): negative-binomial
    counts with a daily profile, a weekend effect, a slow drift and 6-36 hour
    bursts, 1 % of the hours missing (0, masked), and per-series dispersion
    floors. Returns (stamps, counts [T, N], observed [T, N], floors [N])."""

    rng, stamps, counts, observed = simulate_long(np, 5, LONG_SERIES, LONG_HOURS)
    counts = counts.astype(np.float32)
    observed = observed.astype(np.float32)
    counts *= observed
    floors = rng.uniform(0.01, 0.1, LONG_SERIES).astype(np.float32)
    return stamps, counts, observed, floors


# -- the benchmarks' CSVs, written with numpy (the generators need pandas) ------

DEMAND_COLUMNS = ("영업일자", "영업장명_메뉴명", "매출수량")
DEMAND_TEST_FILES, DEMAND_TEST_HISTORY, DEMAND_HORIZON = 5, 28, 7
LONG_TEST_FILES, LONG_TEST_HISTORY, LONG_HORIZON = 2, 512, 24


def simulate_demand(np, seed: int = 7, n_stores: int = 8, n_menus: int = 24,
                    t_train: int = 560):
    """``tools/make_demand_benchmark.py::simulate`` with ``datetime64`` days in
    place of ``pd.date_range``: the same draws in the same order. Returns
    (days [T] datetime64[D], ids, demand [T, N] float64, observed [T, N])."""

    import math

    rng = np.random.default_rng(seed)

    def store_name(st: int) -> str:
        letter, block = chr(ord("A") + st % 26), st // 26
        return f"매장{letter}{block}" if block else f"매장{letter}"

    ids = [f"{store_name(st)}_메뉴{m + 1:02d}" for st in range(n_stores) for m in range(n_menus)]
    n = len(ids)
    total_days = t_train + DEMAND_TEST_FILES * DEMAND_HORIZON + DEMAND_TEST_HISTORY
    days = np.datetime64("2023-01-01") + np.arange(total_days)
    t = np.arange(total_days)
    dow = (days.astype(np.int64) + 3) % 7  # Monday 0: 1970-01-01 was a Thursday
    week_profiles = np.empty((n_stores, 7))
    for st in range(n_stores):
        if st % 2 == 0:
            prof = np.array([0.8, 0.8, 0.9, 1.0, 1.2, 1.6, 1.5])
        else:
            prof = np.array([1.3, 1.25, 1.2, 1.15, 1.1, 0.6, 0.5])
        week_profiles[st] = prof * rng.uniform(0.9, 1.1, 7)
    base = rng.lognormal(mean=2.0, sigma=0.9, size=n)
    store_scale = rng.lognormal(mean=0.0, sigma=0.4, size=n_stores)
    trend = rng.normal(0.0, 0.0004, size=n)
    annual_amp = rng.uniform(0.05, 0.3, size=n)
    annual_phase = rng.uniform(0, 2 * math.pi, size=n)
    alpha = rng.uniform(0.08, 0.5, size=n)
    intermittent = rng.random(n) < 0.15
    mu = np.empty((total_days, n))
    for j in range(n):
        st = j // n_menus
        annual = 1.0 + annual_amp[j] * np.sin(2 * math.pi * t / 365.25 + annual_phase[j])
        level = base[j] * store_scale[st] * np.exp(trend[j] * t)
        mu[:, j] = level * week_profiles[st][dow] * annual
    for st in range(n_stores):  # promotions
        starts = rng.integers(0, total_days - 3, rng.integers(8, 20))
        for start in starts:
            dur = int(rng.integers(1, 4))
            mu[start:start + dur, st * n_menus:(st + 1) * n_menus] *= rng.uniform(1.5, 3.0)
    lam = rng.gamma(1.0 / alpha[None, :], mu * alpha[None, :])
    demand = rng.poisson(lam).astype(np.float64)
    demand[:, intermittent] = np.where(
        rng.random((total_days, intermittent.sum())) < 0.55, 0.0, demand[:, intermittent])
    for st in range(n_stores):  # closures: whole store zero-days
        for c in rng.integers(0, total_days, rng.integers(5, 15)):
            demand[c, st * n_menus:(st + 1) * n_menus] = 0.0
    observed = rng.random((total_days, n)) >= 0.02  # rows missing from the CSV
    return days, ids, demand, observed


def simulate_long(np, seed: int, n_series: int, total: int):
    """``tools/make_long_context_benchmark.py::simulate`` over ``total`` hours
    with ``datetime64`` stamps: the same draws in the same order. Returns
    (the generator, stamps [T] datetime64[h], demand [T, N] float64,
    observed [T, N])."""

    import math

    rng = np.random.default_rng(seed)
    stamps = np.datetime64("2024-01-01T00", "h") + np.arange(total)
    days = stamps.astype("datetime64[D]")
    hour = (stamps - days).astype(np.int64)
    dow = (days.astype(np.int64) + 3) % 7
    t = np.arange(total)
    base = rng.lognormal(mean=1.6, sigma=0.7, size=n_series)
    daily_phase = rng.uniform(0, 2 * math.pi, n_series)
    daily_amp = rng.uniform(0.4, 0.9, n_series)
    weekly_amp = rng.uniform(0.1, 0.5, n_series)
    weekend_sign = np.where(rng.random(n_series) < 0.5, 1.0, -1.0)
    drift = rng.normal(0.0, 5e-5, n_series)
    alpha = rng.uniform(0.1, 0.45, n_series)
    mu = np.empty((total, n_series))
    weekend = (dow >= 5).astype(np.float64)
    for j in range(n_series):
        daily = 1.0 + daily_amp[j] * np.sin(2 * math.pi * hour / 24.0 + daily_phase[j])
        weekly = 1.0 + weekly_amp[j] * weekend_sign[j] * (weekend - 2.0 / 7.0)
        level = base[j] * np.exp(drift[j] * t)
        mu[:, j] = np.maximum(level * daily * weekly, 0.05)
    for _ in range(max(4, n_series // 2)):  # bursts
        j = rng.integers(0, n_series)
        start = rng.integers(0, total - 36)
        dur = int(rng.integers(6, 37))
        mu[start:start + dur, j] *= rng.uniform(1.8, 3.5)
    lam = rng.gamma(1.0 / alpha[None, :], mu * alpha[None, :])
    demand = rng.poisson(lam).astype(np.float64)
    observed = rng.random((total, n_series)) >= 0.01
    return rng, stamps, demand, observed


def _write_long_csv(np, path, header, stamps, ids, values, observed, encoding: str) -> int:
    """The generators' ``to_long(...).to_csv``: one row per observed (stamp,
    id), sorted by stamp text then id, the count as an integer. Returns the
    row count."""

    order = sorted(range(len(ids)), key=ids.__getitem__)
    lines = [",".join(header)]
    counts = values.astype(np.int64)
    for ti, stamp in enumerate(stamps):
        for j in order:
            if observed[ti, j]:
                lines.append(f"{stamp},{ids[j]},{counts[ti, j]}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding=encoding, newline="") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines) - 1


def _write_sample(path, key_column: str, row_keys, ids, encoding: str) -> None:
    """The generators' ``sample_submission.csv``: the row keys, then a column
    of integer zeros a series, in the generator's id order."""

    lines = [",".join([key_column, *ids])]
    zeros = ",0" * len(ids)
    lines.extend(f"{key}{zeros}" for key in row_keys)
    with open(path, "w", encoding=encoding, newline="") as f:
        f.write("\n".join(lines) + "\n")


def _write_benchmark(np, path, header, stamps, ids, values, observed, encoding: str,
                     t_train: int, test_files: int, history: int, horizon: int) -> int:
    """A benchmark's files as its generator lays them out beside ``path``
    (its ``train.csv``): the first ``t_train`` steps there, ``test/TEST_xx.csv``
    (``history`` steps each, ``horizon`` apart, after the training span) and
    ``sample_submission.csv`` (row keys ``TEST_xx+D<step>``). Returns the
    training CSV's row count."""

    rows = _write_long_csv(np, path, header, stamps[:t_train], ids, values[:t_train],
                           observed[:t_train], encoding)
    out = Path(path).parent
    keys = []
    for i in range(test_files):
        lo = t_train + i * horizon
        _write_long_csv(np, out / "test" / f"TEST_{i:02d}.csv", header, stamps[lo:lo + history],
                        ids, values[lo:lo + history], observed[lo:lo + history], encoding)
        keys.extend(f"TEST_{i:02d}+D{d}" for d in range(1, horizon + 1))
    _write_sample(out / "sample_submission.csv", header[0], keys, ids, encoding)
    return rows


def write_demand_csv(np, path, seed: int = 7, n_stores: int = 8, n_menus: int = 24,
                     t_train: int = 560) -> int:
    """The files of ``tools/make_demand_benchmark.py OUTDIR`` beside ``path``
    (OUTDIR's ``train.csv``), UTF-8 with a byte-order mark, byte for byte:
    ``train.csv`` (the first ``t_train`` days), five 28-day TEST files 7 days
    apart and ``sample_submission.csv``."""

    days, ids, demand, observed = simulate_demand(np, seed, n_stores, n_menus, t_train)
    return _write_benchmark(np, path, DEMAND_COLUMNS, [str(d) for d in days], ids, demand,
                            observed, "utf-8-sig", t_train, DEMAND_TEST_FILES,
                            DEMAND_TEST_HISTORY, DEMAND_HORIZON)


def write_long_context_csv(np, path, seed: int = 5, n_series: int = 48,
                           t_train: int = 2400) -> int:
    """The files of ``tools/make_long_context_benchmark.py OUTDIR`` beside
    ``path`` (OUTDIR's ``train.csv``), byte for byte: ``train.csv`` (the first
    ``t_train`` hours), two 512-hour TEST files 24 hours apart and
    ``sample_submission.csv``."""

    total = t_train + LONG_TEST_FILES * LONG_HORIZON + LONG_TEST_HISTORY
    _, stamps, demand, observed = simulate_long(np, seed, n_series, total)
    text = [str(s).replace("T", " ") + ":00:00" for s in stamps]
    ids = [f"S{j:03d}" for j in range(n_series)]
    return _write_benchmark(np, path, ("date", "id", "target"), text, ids, demand, observed,
                            "utf-8", t_train, LONG_TEST_FILES, LONG_TEST_HISTORY, LONG_HORIZON)


def long_per(cfg) -> int:
    """Launches of each kernel and size in one pass of the long model: 2
    inception blocks a layer on the dynamic path, 2 x U on the frozen one."""

    if cfg.frozen_periods is None:
        return 2 * cfg.n_layers
    return 2 * unique_periods(cfg.frozen_periods)


def long_step_counts(cfg) -> dict:
    """Launches of each kernel and size in one training step of the long
    model: the forward twice (the forward pass, then the recompute of every
    rematerialised region in the backward), dh and dW once."""

    per = long_per(cfg)
    return {"tap_conv_fwd": (2 if cfg.use_checkpoint else 1) * per, "tap_conv_dh": per,
            "tap_conv_dw": per}


KINDS = ("tap_conv_fwd", "tap_conv_dh", "tap_conv_dw")


def long_geometries(torch, fold, dev):
    """The long recipe's fold geometries: the dynamic one (K=4 at periods the
    hourly data select, L=512, p_cap 511, Lp 1023) and the exact extents of
    p=25 and p=171 (Lp 525 and 513)."""

    periods = torch.tensor(LONG_PERIODS, dtype=torch.int32, device=dev)
    out = {"dynamic": (LONG_PERIODS, fold.make_geometry(periods, LONG_L, LONG_L - 1))}
    for p in LONG_DENSE:
        out[f"p{p}"] = ((p,), fold.make_dense_geometry(p, LONG_L, dev))
    return out


def scratch_bytes(torch, fn) -> int:
    """Bytes ``fn`` asks the card's caching allocator for beyond the tensor
    it returns: the peak of the requested bytes over one call, less what
    was allocated before it and the result."""

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out = fn()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    return peak - base - out.numel() * out.element_size()


def long_kernels(torch, F, fold, cuda_fold, gen, dev) -> dict:
    """``[kernel]`` at the long recipe's shapes: every route of the three
    kernels (B=64, 32 channels, 3x3 and 5x5) on the dynamic geometry and the
    two exact extents. Each plan must equal its mirror (the bf16 dW takes
    ``band`` 1, ``tap_conv_dw_wgmma_kernel``); each kernel its plain version
    within 1e-4 over every row (dW: rtol 1e-4 and 1e-4 of its largest
    value) with the same bits twice. Then each is timed as ``[time]`` times
    the flagship's (device and call time over 20 calls), beside its bound
    and cuDNN over the exact grids; the bf16 dW also beside its previous
    design's time (``BEFORE_LONG_DW_US``, printed only), with the scratch
    bytes the wrapper allocated (:func:`scratch_bytes`). Returns
    ``{name: {"dynamic" | "p25" | "p171": times, "max_abs_err": e}}``."""

    out = {}
    for kh, kw in LONG_SIZES:
        key = f"{kh}x{kw}"
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        for label, (periods, geom) in long_geometries(torch, fold, dev).items():
            shape = (len(periods), LONG_B, geom.Lp, C, C, kh, kw, geom.p_max)
            for name, plan, own in (
                    ("tap_conv_fwd_mma", cuda_fold.fold_mma_plan(1, *shape),
                     cuda_fold.fold_mma_plan_of_kernel(1, *shape)),
                    ("tap_conv_dh_mma", cuda_fold.fold_mma_plan(-1, *shape),
                     cuda_fold.fold_mma_plan_of_kernel(-1, *shape)),
                    ("tap_conv_dw_mma", cuda_fold.dw_mma_plan(*shape),
                     cuda_fold.dw_mma_plan_of_kernel(*shape)),
                    ("tap_conv_fwd", cuda_fold.fwd_f32_plan(*shape),
                     cuda_fold.fwd_f32_plan_of_kernel(*shape)),
                    ("tap_conv_dh", cuda_fold.dh_f32_plan(*shape),
                     cuda_fold.dh_f32_plan_of_kernel(*shape)),
                    ("tap_conv_dw", cuda_fold.dw_f32_plan(*shape[:-1]),
                     cuda_fold.dw_f32_plan_of_kernel(*shape[:-1]))):
                check(plan == own, f"{name} {key} {label}: the wrapper's plan differs from the "
                                   f"kernel's")
                print(f"[kernel] long context {name} {key} {label} Lp={geom.Lp} plan (the "
                      f"kernel's own): {plan._asdict()}")
            h32, ct32 = (torch.randn((len(periods), LONG_B, geom.Lp, C), generator=gen,
                                     device=dev) for _ in range(2))
            for dtype in (torch.bfloat16, torch.float32):
                route = "mma" if dtype == torch.bfloat16 else "f32"
                h, ct = h32.to(dtype), ct32.to(dtype)
                runs = [(cuda_fold.tap_conv_cuda(h, geom, weight, bias, kh, kw),
                         cuda_fold.tap_conv_dh_cuda(ct, geom, weight, kh, kw),
                         cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)) for _ in range(2)]
                wants = (fold.tap_conv(h, geom, weight, bias, kh, kw),
                         fold.tap_conv_dh(ct, geom, weight, kh, kw),
                         fold.tap_weight_grad(h, geom, ct, kh, kw))
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(*runs))
                line = []
                for kind, got, want in zip(("fwd", "dh", "dw"), runs[0], wants):
                    err = float((got - want).abs().max())
                    atol = TOL * float(want.abs().max()) if kind == "dw" else TOL
                    ok = bool(torch.allclose(got, want, rtol=TOL, atol=atol))
                    entry = out.setdefault(f"{kind}_{route}_{key}", {"max_abs_err": 0.0})
                    entry["max_abs_err"] = max(entry["max_abs_err"], err)
                    line.append(f"{kind} {err:.3e} {'ok' if ok else 'FAIL'}")
                    check(ok, f"long context {kind}_{route} {key} {label}: {err:.3e} against "
                              f"the plain version")
                print(f"[kernel] long context {key} {label} Lp={geom.Lp} {str(dtype)[6:]}: max "
                      f"|kernel - plain| over every row: {', '.join(line)}; the same bits "
                      f"twice: {same}")
                check(same, f"long context {key} {label} {dtype}: the bits differ from run to run")
                del runs, wants
                times = {"fwd": time_forward(torch, F, fold, cuda_fold, h, geom, periods, weight,
                                             bias, kh, kw, plain=False, iters=LONG_ITERS),
                         **time_backward(torch, fold, cuda_fold, h, ct, geom, periods, weight,
                                         kh, kw, plain=False, iters=LONG_ITERS)}
                for kind, t in times.items():
                    out[f"{kind}_{route}_{key}"][label] = {**t, "lp": geom.Lp,
                                                           "periods": list(periods)}
                    print(f"[time] long context {kind}_{route} {key} {label} Lp={geom.Lp} "
                          f"B={LONG_B}: {described(t)}")
                if route == "mma":  # the bf16 dW beside its previous design, and its scratch
                    entry = out[f"dw_mma_{key}"][label]
                    entry["scratch_bytes"] = scratch_bytes(
                        torch, lambda: cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw))
                    plan_bytes = 4 * cuda_fold.dw_mma_plan(*shape).scratch_elems(kh, kw, C, C)
                    check(entry["scratch_bytes"] == plan_bytes,
                          f"long context dw_mma {key} {label}: {entry['scratch_bytes']} bytes "
                          f"of scratch allocated, the plan's {plan_bytes}")
                    print(f"[time] long context dw_mma {key} {label} Lp={geom.Lp}: kernel "
                          f"{entry['ms'] * 1e3:.2f} us against the previous design's (before) "
                          f"{BEFORE_LONG_DW_US[key][label]:.2f} us, cuDNN "
                          f"{entry['library_ms'] * 1e3:.2f} us, bound "
                          f"{entry['bound_ms'] * 1e3:.3f} us ({entry['bound_by']}), scratch "
                          f"{entry['scratch_bytes'] / 1e6:.2f} MB")
    return out


def long_forecasters(forecaster, rec, params, cfg, data, device="cuda"):
    """A ``Forecaster`` of the long recipe over the 48 series, and its request:
    the last 512 hours before the final 24 of the data, hourly stamps."""

    stamps, counts, observed, floors = data
    split = LONG_HOURS - LONG_HOLDOUT
    ids = [f"S{j:03d}" for j in range(LONG_SERIES)]
    scaler = {sid: (float(counts[:split, j].mean()), float(counts[:split, j].std() + 1.0))
              for j, sid in enumerate(ids)}
    fc = forecaster.Forecaster(params, cfg, ids, scaler, "zscore", None, floors, rec.time_features,
                               freq="h", device=device)
    end = LONG_HOURS - LONG_H
    return fc, counts[end - LONG_L:end], stamps[end - LONG_L:end]


def serve_long(torch, np, forecaster, cuda_fold, rec, cfg, params, data) -> dict:
    """``[serve-long]``: the long recipe served over its 48 series, one
    request of 512 hours with 24 ahead on the live selector. Eager
    (``cuda_graphs`` off) and replayed, ``LONG_REQUESTS`` timed requests each:
    forecasts finite and >= 0, every eager request launching the forward 2 x
    2 times a size on the tensor-core route (the card counting the same),
    every replay running it as many times on the card and no wrapper, replays
    equal to the eager forecast within rtol/atol 1e-5. A float32 request on
    the card equals the same request on the CPU within 1e-4. Then 20 requests
    of each under the profiler."""

    per = long_per(cfg)
    fc, history, dates = long_forecasters(forecaster, rec, params, cfg, data)
    eager(fc)
    first = fc.forecast(history, dates=dates)
    torch.cuda.synchronize()
    check(first.shape == (LONG_H, LONG_SERIES) and bool(np.isfinite(first).all())
          and bool((first >= 0).all()), f"long forecast {first.shape}, finite and >= 0")
    clear_counts(cuda_fold)  # the eager requests' launches, from here ...
    ms = []
    for _ in range(LONG_REQUESTS):
        t0 = time.perf_counter()
        out = fc.forecast(history, dates=dates)
        ms.append(1e3 * (time.perf_counter() - t0))
        check(np.array_equal(out, first), "an eager long request differs from the first")
    wrapped, ran = launch_counts(cuda_fold), run_counts(cuda_fold)  # ... to here
    eager_counts = wrapped
    check_launches(wrapped, ("tap_conv_fwd",), LONG_REQUESTS * per, True,
                   f"{LONG_REQUESTS} eager long requests (wrappers)", LONG_SIZES)
    check(ran == wrapped, f"long requests: the card counted {ran}, the wrappers {wrapped}")
    check(not any(wrapped[k] for k in ("tap_conv_dh", "tap_conv_dw")), f"{wrapped}")
    p50 = float(np.median(ms))
    print(f"[serve-long] {LONG_REQUESTS} eager requests of {LONG_SERIES} series x {LONG_L} hours "
          f"(+{LONG_H}): latency ms {spread(np, ms)}; launches {wrapped['tap_conv_fwd']} "
          f"(tensor-core {wrapped['tap_conv_fwd_mma']}), the card's the same; forecast range "
          f"[{float(first.min()):.3f}, {float(first.max()):.3f}]")
    prof_eager = profile(torch, lambda: fc.forecast(history, dates=dates), 20,
                         "eager long request", p50)

    graphed, _, _ = long_forecasters(forecaster, rec, params, cfg, data)
    clear_counts(cuda_fold)
    got = graphed.forecast(history, dates=dates)  # warm-up, capture, replay
    check_first_call(cuda_fold, ("tap_conv_fwd",), per, "first replayed long request",
                     LONG_SIZES)
    ms_g = []
    clear_counts(cuda_fold)  # the replays' launches, from here ...
    for _ in range(LONG_REQUESTS):
        t0 = time.perf_counter()
        out = graphed.forecast(history, dates=dates)
        ms_g.append(1e3 * (time.perf_counter() - t0))
        check(np.allclose(out, first, rtol=1e-5, atol=1e-5), "replayed long request vs eager")
    wrapped, ran = launch_counts(cuda_fold), run_counts(cuda_fold)  # ... to here
    check(not any(wrapped.values()), f"replayed long requests ran a wrapper: {wrapped}")
    check_launches(ran, ("tap_conv_fwd",), LONG_REQUESTS * per, True,
                   f"{LONG_REQUESTS} replayed long requests (card)", LONG_SIZES)
    p50_g = float(np.median(ms_g))
    print(f"[serve-long] {LONG_REQUESTS} replayed requests: latency ms {spread(np, ms_g)} "
          f"({p50 / p50_g:.2f}x the eager p50); forecasts against eager: "
          f"{'bit for bit' if np.array_equal(got, first) else 'within 1e-5'}; the card ran "
          f"{ran['tap_conv_fwd']}, the wrappers none")
    prof_graph = profile(torch, lambda: graphed.forecast(history, dates=dates), 20,
                         "replayed long request", p50_g)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    raw = {}
    for device in ("cuda", "cpu"):
        f32, hist, st = long_forecasters(forecaster, rec, params, cfg32, data, device)
        raw[device] = eager(f32)._forecast_raw(hist, dates=st)[:2]
    for name, a, b in zip(("rate", "dispersion"), raw["cuda"], raw["cpu"]):
        err = float(np.abs(a - b).max())
        print(f"[serve-long] float32 card vs CPU {name}: max abs diff {err:.3e}")
        check(np.allclose(a, b, rtol=TOL, atol=TOL), f"long float32 {name} card vs CPU {err:.3e}")
    return {"counts": eager_counts, "counts_graph": ran, "p50": p50, "p50_graph": p50_g,
            "profile": prof_eager, "profile_graph": prof_graph}


def long_batches(np, windows, engine_mod, rec, data, n: int):
    """The training windows of the long recipe: 512 + 24 hours of the first
    1,328 (the holdout keeps 1,072), shuffled at B=64 (594 batches an
    epoch), the first ``n`` gathered; the batcher and a copy function."""

    stamps, counts, observed, floors = data
    split = LONG_HOURS - LONG_HOLDOUT
    src = windows.SlidingWindowSource(
        counts[:split], LONG_L, LONG_H, "direct", valid_mask=observed[:split],
        series_ids=np.arange(LONG_SERIES), time_index=stamps[:split],
        time_feature_config=rec.time_features)
    train = windows.WindowBatcher([src], LONG_B, shuffle=True, drop_last=True, seed=0)

    def to_device(batch, device=DEVICE):
        floor = floors[batch.series_ids.reshape(-1)].reshape(-1, 1, 1)
        return engine_mod.batch_to_device(batch, floor=floor, device=device)

    return train, [b for _, b in zip(range(n), train)], to_device


def long_steps(torch, np, cuda_fold, eng, state, gen, lr, batches, to_device, what,
               graphed: bool, counts_per_step: dict):
    """Steps of ``eng`` on ``batches`` (host clock over ``batch_to_device`` +
    ``train_step``, synchronised per step), each step's launches counted by
    the wrappers and by the card: an eager step launches and runs
    ``counts_per_step`` of each kind at every size; a replayed graph's first
    step is :func:`check_first_call`'s, a later one runs no wrapper and the
    same counts on the card. Returns (state, losses, ms, counts over the
    steps after the warm-up ones)."""

    losses, ms, timed = [], [], {k: {} for k in path_counters(cuda_fold)}
    for i, batch in enumerate(batches):
        clear_counts(cuda_fold)  # this step's launches, from here ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss, _ = eng.train_step(state, lr, gen, to_device(batch))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        if graphed and i == 0:
            check_first_call(cuda_fold, KINDS, counts_per_step, f"{what} step 0", LONG_SIZES)
            continue
        wrapped, ran = launch_counts(cuda_fold), run_counts(cuda_fold)  # ... to here
        if graphed:
            check(not any(wrapped.values()), f"{what} step {i} ran a wrapper: {wrapped}")
        else:
            check_launches(wrapped, KINDS, counts_per_step, True, f"{what} step {i} (wrappers)",
                           LONG_SIZES)
        check_launches(ran, KINDS, counts_per_step, True, f"{what} step {i} (card)", LONG_SIZES)
        if i >= LONG_WARMUP:
            for k, by_size in ran.items():
                for size, n in by_size.items():
                    timed[k][size] = timed[k].get(size, 0) + n
    losses = torch.stack(losses)
    check(bool(torch.isfinite(losses).all()), f"{what}: a non-finite loss")
    return state, losses, ms[LONG_WARMUP:], timed


def train_long(torch, np, windows, engine_mod, losses_mod, optim, cuda_fold, rec, cfg, params,
               data) -> dict:
    """``[train-long]``: the long recipe's training steps at B=64 and the
    recipe's rate, remat on. Eager then replayed from one initial state,
    generator seed and batches: ``LONG_WARMUP + LONG_STEPS`` dynamic steps,
    then as many frozen ones on the spec of a training batch's telemetry,
    continuing the state; replayed losses within 1e-5 relative of eager and
    the state within 1e-4 of its largest value (bit for bit stated). Each
    step launches the forward 2 x 4 times a size (the recompute doubles it)
    and dh and dW 4 (2 x 2 x U frozen). Peak device memory and the step p50
    with ``use_checkpoint`` on and off (eager, before any graph holds a
    pool); 30 replayed steps on one batch lower its loss; a float32 step
    with dropout 0 at B=16 equals the CPU's (loss within 1e-5 relative,
    gradients within 1e-4 of the largest); 10 replayed steps of each path
    under the profiler."""

    train, batches, to_device = long_batches(np, windows, engine_mod, rec, data,
                                             LONG_WARMUP + LONG_STEPS)
    warmup = optim.resolve_warmup(rec.schedule["warmup_steps"], None, len(train))
    lr = optim.LRController(rec.schedule["lr"], rec.schedule["epochs"],
                            {"type": "cosine", "eta_min": rec.schedule["eta_min"]},
                            warmup).lr_for_epoch(1)
    print(f"[train-long] {train.total} windows, {len(train)} batches of {LONG_B} an epoch; lr "
          f"{lr:.4e} (epoch 1 of the recipe's cosine schedule, {rec.schedule['warmup_steps']} "
          f"warm-up steps)")

    # peak memory and p50, remat on and off: eager, before any graph
    mem = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, use_checkpoint=remat)
        eng = eager(engine_mod.Engine(c, params, **rec.engine))
        state, gen = eng.init_state(), torch.Generator(device=DEVICE).manual_seed(3)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, _, ms, _ = long_steps(torch, np, cuda_fold, eng, state, gen, lr,
                                 batches[:LONG_WARMUP + LONG_MEM_STEPS], to_device,
                                 f"eager long step (remat {'on' if remat else 'off'})", False,
                                 long_step_counts(c))
        peak = torch.cuda.max_memory_allocated()
        mem[remat] = dict(peak_mib=peak / 2**20, step_mib=(peak - base) / 2**20,
                          p50=float(np.median(ms)))
        print(f"[train-long] use_checkpoint {'on' if remat else 'off'}: {LONG_MEM_STEPS} eager "
              f"steps, step ms {spread(np, ms)}; peak device memory {peak / 2**20:.1f} MiB, "
              f"{(peak - base) / 2**20:.1f} MiB above what was allocated before the steps")
        del eng, state
    print(f"[train-long] remat: peak step memory {mem[True]['step_mib']:.1f} MiB against "
          f"{mem[False]['step_mib']:.1f} MiB without ({mem[False]['step_mib'] / max(mem[True]['step_mib'], 1e-9):.2f}x); "
          f"eager step p50 {mem[True]['p50']:.3f} against {mem[False]['p50']:.3f} ms "
          f"({mem[True]['p50'] / mem[False]['p50']:.2f}x)")

    probe = eager(engine_mod.Engine(cfg, params, **rec.engine))
    spec = engine_mod.Engine.frozen_spec_from_telemetry(
        probe.collect_period_telemetry(None, to_device(batches[0])), cfg.n_layers)
    check(spec is not None and unique_periods(spec) >= 1, f"long spec {spec}")
    valid = [sorted({p for p, _, v in layer if v}) for layer in spec]
    print(f"[train-long] spec {spec} (the telemetry of a training batch): valid periods by "
          f"layer {valid}")
    cfgs = {"dynamic": cfg, "frozen": dataclasses.replace(cfg, frozen_periods=spec)}
    runs = {}
    for graphed in (False, True):
        engines = {path: engine_mod.Engine(c, params, **rec.engine) for path, c in cfgs.items()}
        if not graphed:
            for eng in engines.values():
                eager(eng)
        state = engines["dynamic"].init_state()
        gen = torch.Generator(device=DEVICE).manual_seed(11)
        by_path = {}
        for path, eng in engines.items():
            what = f"{'replayed' if graphed else 'eager'} long {path}"
            state, losses, ms, counts = long_steps(torch, np, cuda_fold, eng, state, gen, lr,
                                                   batches, to_device, what, graphed,
                                                   long_step_counts(eng.cfg))
            by_path[path] = dict(losses=losses, ms=ms, counts=counts, engine=eng)
        runs[graphed] = dict(rec=by_path, state=state, gen=gen)
    g, e = runs[True], runs[False]
    got_t, want_t = ([t.detach() for t in r["state"].tensors()] for r in (g, e))
    scale = max(1.0, max(float(t.abs().max()) for t in want_t))
    diff = max(float((a - b).abs().max()) for a, b in zip(got_t, want_t))
    print(f"[train-long] after {len(batches)} dynamic and {len(batches)} frozen steps: "
          f"parameters and Adam moments replayed against eager {same_or_diff(torch, got_t, want_t)}")
    check(diff <= 1e-4 * scale, f"replayed long state against eager: {diff:.3e}")
    out = {"spec": spec, "mem": mem, "lr": lr}
    for path in cfgs:
        got, want = g["rec"][path], e["rec"][path]
        rel = float(((got["losses"] - want["losses"]).abs() / want["losses"].abs()).max())
        check(rel <= 1e-5, f"replayed long {path} losses against eager: {rel:.3e} relative")
        p50, p50_e = float(np.median(got["ms"])), float(np.median(want["ms"]))
        print(f"[train-long] {path}: {LONG_STEPS} steps of {LONG_B} windows (after "
              f"{LONG_WARMUP}): eager step ms {spread(np, want['ms'])}, {LONG_B / p50_e * 1e3:.1f} "
              f"windows/s; replayed step ms {spread(np, got['ms'])}, {LONG_B / p50 * 1e3:.1f} "
              f"windows/s ({p50_e / p50:.2f}x); losses against eager "
              f"{same_or_diff(torch, got['losses'], want['losses'])} (max relative {rel:.3e}), "
              f"first {float(got['losses'][0]):.4f} last {float(got['losses'][-1]):.4f}; launches "
              f"the card counted in the replayed steps: forward {got['counts']['tap_conv_fwd']}, "
              f"dh {got['counts']['tap_conv_dh']}, dW {got['counts']['tap_conv_dw']} "
              f"(tensor-core dW {got['counts']['tap_conv_dw_mma']})")
        eng, state, gen = got["engine"], g["state"], g["gen"]
        fixed = to_device(batches[0])
        prof = profile(torch, lambda: eng.train_step(state, lr, gen, fixed), 10,
                       f"replayed long {path} step", p50)
        out[path] = dict(p50=p50, p50_eager=p50_e, counts=want["counts"], profile=prof)

    # 30 replayed steps on one batch at the recipe's base rate lower its loss
    fit = engine_mod.Engine(cfg, params, **rec.engine)
    fit_state, fit_gen = fit.init_state(), torch.Generator(device=DEVICE).manual_seed(4)
    fixed = to_device(batches[0])
    fit_losses = torch.stack([fit.train_step(fit_state, rec.schedule["lr"], fit_gen, fixed)[1]
                              for _ in range(OVERFIT_STEPS)]).cpu().numpy()
    last = float(np.mean(fit_losses[-5:]))
    print(f"[train-long] {OVERFIT_STEPS} replayed steps on one batch at lr {rec.schedule['lr']}: "
          f"loss {fit_losses[0]:.4f} -> {last:.4f} (mean of the last 5)")
    check(bool(np.isfinite(fit_losses).all()) and last < float(fit_losses[0]),
          "the long fixed-batch loss did not fall")

    # float32, dropout 0, card against CPU, at B=16 (the CPU's share of the run)
    parity = {k: None if v is None else v[:LONG_PARITY_B]
              for k, v in to_device(batches[0], "cpu").items()}
    for path, c in cfgs.items():
        out[path]["f32"] = train_parity(
            torch, np, engine_mod, losses_mod, cuda_fold, c, params, rec.engine, parity,
            per=long_per(c), what=f"long float32 {path} step (B={LONG_PARITY_B}, remat on)",
            nll=False)
    return out


def train_long_resident(torch, np, windows, dw, engine_mod, cuda_fold, rec, cfg, params, data,
                        lr: float) -> dict:
    """``[train-long-resident]``: the long recipe's training windows staged
    on the card, then two dynamic resident epochs of 594 steps of 64 (a plan
    longer than ``RESIDENT_PLAN_ROWS``): the first with its capture, the
    second steady under ``set_sync_debug_mode("error")``. The first's
    first 20 losses must equal those of the host pipeline's eager steps from
    the same state, generator and windows within 1e-5 relative; launches as
    ``[train-resident]`` counts them (remat: the forward twice a step)."""

    from flow_timesnet_tpu_torch import graphs

    train, _, to_device = long_batches(np, windows, engine_mod, rec, data, 0)
    src = train.sources[0]
    floors = data[3]
    staged = dw.stage_windows([src.X], [src.M], src.L, src.H, src.stride, "direct",
                              marks=[src.marks], static=None, sigma_vector=floors, device=DEVICE)
    check(staged.total == train.total, f"staged {staged.total} windows, batched {train.total}")
    eng = engine_mod.Engine(cfg, params, **rec.engine)
    state, gen = eng.init_state(), torch.Generator(device=DEVICE).manual_seed(21)
    ref = eager(engine_mod.Engine(cfg, params, **rec.engine))
    ref_state = ref.init_state()
    clone_state(torch, state, ref_state)
    ref_gen = torch.Generator(device=DEVICE)
    ref_gen.set_state(gen.get_state())
    per = long_step_counts(cfg)
    out = {}
    for ep in (1, 2):
        idx, rv = dw.epoch_index_plan(staged.total, LONG_B, shuffle=True, drop_last=True,
                                      rng=np.random.default_rng([0, ep]))
        S = len(idx)
        check(S > engine_mod.RESIDENT_PLAN_ROWS, f"{S} steps, the plan buffer holds "
                                                 f"{engine_mod.RESIDENT_PLAN_ROWS}")
        clear_counts(cuda_fold)  # this epoch's launches, from here ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_d, rv_d = torch.from_numpy(idx).to(DEVICE), torch.from_numpy(rv).to(DEVICE)
        if ep == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, losses, mask_true = eng.train_epoch_resident(state, lr, gen, staged, idx_d,
                                                                rv_d)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses = losses.cpu().numpy()  # one fetch
        seconds = time.perf_counter() - t0
        wrapped, ran = launch_counts(cuda_fold), run_counts(cuda_fold)  # ... to here
        check(bool(np.isfinite(losses).all()) and len(losses) == S, f"long epoch {ep} losses")
        line = (f"[train-long-resident] epoch {ep} (dynamic"
                f"{', capture included' if ep == 1 else ', steady'}): {S} steps of {LONG_B} in "
                f"{seconds:.3f} s, {S * LONG_B / seconds:.1f} windows/s, "
                f"{1e3 * seconds / S:.3f} ms a step, loss mean {losses.mean():.4f}")
        if ep == 1:
            warm = graphs.WARMUP_CALLS
            check_launches(wrapped, KINDS, {k: (warm + 1) * n for k, n in per.items()}, True,
                           "long resident epoch 1 (wrappers: warm-up and capture)", LONG_SIZES)
            check_launches(ran, KINDS, {k: (warm + S) * n for k, n in per.items()}, True,
                           f"long resident epoch 1 (card: warm-up and {S} replays)", LONG_SIZES)
            train.set_epoch(ep)  # the plan's permutation: the same windows in the same order
            want = []
            for _, batch in zip(range(LONG_HOST_STEPS), train):
                ref_state, loss, _ = ref.train_step(ref_state, lr, ref_gen, to_device(batch))
                want.append(loss)
            want = torch.stack(want).cpu().numpy()
            got = losses[:LONG_HOST_STEPS]
            rel = float(np.max(np.abs(got - want) / np.abs(want)))
            line += (f"; its first {LONG_HOST_STEPS} losses against the host pipeline's eager "
                     f"steps from the same state: max relative {rel:.3e} (bitwise: "
                     f"{bool(np.array_equal(got, want))})")
            check(rel <= 1e-5, f"long resident losses against eager {rel:.3e}")
            out["capture_seconds"] = seconds
        else:
            check(not any(wrapped.values()), f"long resident epoch 2 ran a wrapper: {wrapped}")
            check_launches(ran, KINDS, {k: S * n for k, n in per.items()}, True,
                           "long resident epoch 2 (card)", LONG_SIZES)
            line += (f"; no synchronising call, no wrapper launch; the card ran forward "
                     f"{ran['tap_conv_fwd']}, dh {ran['tap_conv_dh']}, dW {ran['tap_conv_dw']}")
            out.update(seconds=seconds, steps=S, counts=ran,
                       peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        print(line)
    return out


def route_count(counts: dict, kind: str, route: str, key: str) -> int:
    """Launches of ``kind`` at ``key`` on one route in :func:`launch_counts`'
    form: the tensor-core route's own count, or every launch less those."""

    n_mma = counts[f"tap_conv_{kind}_mma"].get(key, 0)
    return n_mma if route == "mma" else counts[f"tap_conv_{kind}"].get(key, 0) - n_mma


def path_counters(cuda_fold) -> dict:
    """The launch counters of the fold-conv kernels: every route of each
    kernel, and the tensor-core one."""

    return {"tap_conv_fwd": cuda_fold.launches, "tap_conv_fwd_mma": cuda_fold.launches_mma,
            "tap_conv_dh": cuda_fold.launches_dh, "tap_conv_dh_mma": cuda_fold.launches_dh_mma,
            "tap_conv_dw": cuda_fold.launches_dw, "tap_conv_dw_mma": cuda_fold.launches_dw_mma}


T0 = time.perf_counter()


# -- train_once from a config and a CSV ---------------------------------------

def train_once_phase(torch, np, cuda_fold, label: str, recipe: str, write_csv, epochs: int,
                     sizes, must_freeze: bool, serve=None):
    """``[train-once]`` / ``[train-once-long]``: the recipe's benchmark CSV
    written with numpy into a temporary directory, then the port's
    ``train_once`` on the recipe as the port's config layer reads it, with
    overrides for the data paths, ``artifacts.dir`` and ``train.epochs`` only:
    full width and depth, on the resident pipeline (and, with ``must_freeze``,
    on the frozen-period path by the last epoch). Each epoch's seconds and
    windows/s, the graphs' warm-up and capture time, the host time around
    the epochs and each hand kernel's runs on the card (every bf16 kernel
    must have run at each size, no float32 one). Then ``Forecaster.from_artifacts``
    loads the artifact directory and forecasts the last window of the CSV:
    finite and >= 0. ``serve(tmp, spec)``, where given, then runs on the
    temporary directory (``data/`` and ``artifacts/``) and the spec the run
    froze on (else the last telemetry spec of its probe). Returns the card's
    kernel runs and what ``serve`` returned."""

    import tempfile

    from flow_timesnet_tpu_torch import forecaster, graphs
    from flow_timesnet_tpu_torch.config import PipelineConfig, load_yaml
    from flow_timesnet_tpu_torch.data.pivot import read_long_pivot
    from flow_timesnet_tpu_torch.engine import Engine
    from flow_timesnet_tpu_torch.train import train_once

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data = Path(tmp) / "data"
        t0 = time.perf_counter()
        rows = write_csv(np, data / "train.csv")
        print(f"[{label}] wrote {rows} rows of {recipe}'s benchmark in "
              f"{time.perf_counter() - t0:.2f} s")
        cfg = PipelineConfig.from_files(str(REPO / "configs" / recipe), overrides=[
            f"data.train_csv={data / 'train.csv'}", f"data.test_dir={data / 'test'}",
            f"data.sample_submission={data / 'sample_submission.csv'}",
            f"artifacts.dir={Path(tmp) / 'artifacts'}", f"train.epochs={epochs}"])
        captures = []
        real_capture = graphs.capture

        def timed_capture(*args, **kwargs):  # warm-up and capture of each graph
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_capture(*args, **kwargs)
            torch.cuda.synchronize()
            captures.append(time.perf_counter() - t)
            return out

        # the specs the run saw: its probe's at each epoch, and those it froze on
        probed, frozen = [], []
        real_probe, real_init = Engine.frozen_spec_from_telemetry, Engine.__init__

        def probe(telemetry, n_layers):
            spec = real_probe(telemetry, n_layers)
            probed.append(spec)
            return spec

        def init(self, model_cfg, *args, **kwargs):
            if model_cfg.frozen_periods is not None:
                frozen.append(model_cfg.frozen_periods)
            real_init(self, model_cfg, *args, **kwargs)

        clear_counts(cuda_fold)
        graphs.capture = timed_capture
        Engine.frozen_spec_from_telemetry, Engine.__init__ = staticmethod(probe), init
        try:
            t0 = time.perf_counter()
            best_nll, paths = train_once(cfg)
            seconds = time.perf_counter() - t0
        finally:
            graphs.capture = real_capture
            Engine.frozen_spec_from_telemetry, Engine.__init__ = staticmethod(real_probe), real_init
        ran = run_counts(cuda_fold)
        m = paths["metrics"]
        check(m["input_pipeline"] == "device", f"{label}: the {m['input_pipeline']} pipeline ran")
        check(len(m["epoch_seconds"]) == epochs, f"{label}: {len(m['epoch_seconds'])} epochs")
        check(any(m["epoch_frozen"]) or not must_freeze, f"{label}: no epoch froze")
        check(bool(np.isfinite(m["epoch_loss"]).all()) and bool(np.isfinite(best_nll)),
              f"{label}: losses {m['epoch_loss']}, best NLL {best_nll}")
        for ep in range(epochs):
            print(f"[{label}] epoch {ep + 1}: {m['epoch_seconds'][ep]:.3f} s "
                  f"({m['epoch_windows_per_s'][ep]:.1f} windows/s; the probe "
                  f"{m['epoch_probe_seconds'][ep]:.3f} s), "
                  f"{'frozen' if m['epoch_frozen'][ep] else 'dynamic'}, loss "
                  f"{m['epoch_loss'][ep]:.6f}, val NLL {m['epoch_val_nll'][ep]:.6f}, val sMAPE "
                  f"{m['epoch_val_smape'][ep]:.6f}, evaluation {m['epoch_eval_seconds'][ep]:.3f} s")
        print(f"[{label}] train_once {seconds:.3f} s: setup {m['setup_seconds']:.3f} s, epochs "
              f"{sum(m['epoch_seconds']):.3f} s, evaluations {sum(m['epoch_eval_seconds']):.3f} s, "
              f"between epochs {m['between_epochs_seconds']:.3f} s, artifacts "
              f"{m['artifact_seconds']:.3f} s; {len(captures)} graphs warmed up and captured in "
              f"{sum(captures):.3f} s (inside the epochs and evaluations); best epoch "
              f"{m['best_epoch']}, val NLL {best_nll:.6f}, sMAPE {m['smape']:.6f}")
        for kind in KINDS:
            for kh, kw in sizes:
                size = f"{kh}x{kw}"
                check(ran[f"{kind}_mma"].get(size, 0) > 0 and ran[kind] == ran[f"{kind}_mma"],
                      f"{label}: {kind} {size} ran {ran[kind]}, tensor-core {ran[kind + '_mma']}")
        print(f"[{label}] the card ran {ran}")
        art = {k: Path(paths[k]) for k in ("model", "scaler", "schema", "config", "signature",
                                           "metadata")}
        check(all(p.is_file() for p in art.values()), f"{label}: artifacts {art}")
        print(f"[{label}] artifacts: {', '.join(sorted(p.name for p in art.values()))}")

        used = load_yaml(str(art["config"]))
        fc = forecaster.Forecaster.from_artifacts(str(art["config"].parent))
        check(fc.device.type == "cuda", f"{label}: from_artifacts on {fc.device}")
        d = used["data"]
        wide = read_long_pivot(d["train_csv"], d["date_col"], d["id_col"], d["target_col"],
                               encoding=d["encoding"])
        check(wide.columns == fc.ids, f"{label}: ids of the CSV and the scaler")
        L = fc.input_len
        out = fc.forecast(wide.values[-L:], dates=wide.index[-L:])
        check(out.shape == (fc.pred_len, len(fc.ids)) and bool(np.isfinite(out).all())
              and bool((out >= 0).all()), f"{label}: forecast {out.shape}, finite and >= 0")
        stored = used["train"].get("frozen_periods_spec")
        print(f"[{label}] Forecaster.from_artifacts served {len(fc.ids)} series x {L} steps "
              f"(freq {fc.freq}, spec {'frozen' if stored else 'none'} stored): forecast "
              f"[{float(out.min()):.3f}, {float(out.max()):.3f}]")
        check(bool(frozen or probed), f"{label}: the run probed no period selection")
        spec = frozen[-1] if frozen else probed[-1]
        print(f"[{label}] spec for the serving phases: {[list(map(list, l)) for l in spec]} "
              f"({'the one the run froze on' if frozen else 'the last probe: the run never froze'})")
        served = serve(Path(tmp), spec) if serve is not None else None
    return ran, served


# -- predict and evaluate from the artifacts ----------------------------------

# bf16 card vs bf16 CPU submissions, relative and in counts. Both round the
# fold conv's float32 inputs to bf16 (8 significant bits) at the same points,
# but accumulate in float32 in other orders, so an element within a float32
# ulp of a bf16 boundary rounds one way on each: a 2^-8 (3.9e-3) relative
# step there, which the later layers carry. 2e-2 allows a few such steps on
# the path to one forecast; the run prints the bf16-against-float32 gap
# beside it, the whole of bf16's rounding.
BF16_CPU_TOL = 2e-2
FLOAT32_TOL = 1e-4  # float32 card vs CPU submissions and metrics, relative


class Instrumented:
    """Times the serving path's layers while it is active: reading and
    pivoting the TEST files (``predict._prepare_test_batches``) or the
    evaluation CSV (``evaluate.read_long_pivot``), each forward
    (``Engine.forward``, the card synchronised around it), each resident
    evaluation pass and each submission's render and write; counts the
    graphs captured."""

    def __init__(self, torch):
        from flow_timesnet_tpu_torch import engine, evaluate, graphs, predict

        self.torch = torch
        self.seconds = {"read": 0.0, "render_write": 0.0, "evaluate_resident": 0.0}
        self.forward_ms, self.captures = [], 0
        self._patches = [(predict, "_prepare_test_batches", "read"),
                         (evaluate, "read_long_pivot", "read"),
                         (predict, "render_and_write", "render_write"),
                         (engine.Engine, "evaluate_resident", "evaluate_resident"),
                         (engine.Engine, "forward", None), (graphs, "capture", None)]
        self._saved = []

    def _timed(self, fn, key):
        def wrapper(*args, **kwargs):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            if key is None:
                self.forward_ms.append(1e3 * (time.perf_counter() - t))
            else:
                self.seconds[key] += time.perf_counter() - t
            return out
        return wrapper

    def __enter__(self):
        for owner, name, key in self._patches:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            if name == "capture":
                def counted(*args, _fn=fn, **kwargs):
                    self.captures += 1
                    return _fn(*args, **kwargs)
                setattr(owner, name, counted)
            else:
                setattr(owner, name, self._timed(fn, key))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        return False


def serving_cli(torch, command: str, recipe: str, tmp: Path, *overrides):
    """``cli.main([command, ...])`` on the recipe with overrides for the
    paths of ``tmp`` (its benchmark's files and artifacts) and ``overrides``:
    (wall seconds, the :class:`Instrumented` record)."""

    from flow_timesnet_tpu_torch import cli

    data = tmp / "data"
    argv = [command, "--config", str(REPO / "configs" / recipe), "--override",
            f"data.train_csv={data / 'train.csv'}", f"data.test_dir={data / 'test'}",
            f"data.sample_submission={data / 'sample_submission.csv'}",
            f"artifacts.dir={tmp / 'artifacts'}", *overrides]
    with Instrumented(torch) as rec:
        t = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return wall, rec


def max_rel(np, got, want) -> str:
    diff = np.abs(got - want)
    return (f"max abs diff {float(diff.max()):.3e}, max relative "
            f"{float((diff / np.maximum(np.abs(want), 1e-6)).max()):.3e}")


def predict_phase(torch, np, cuda_fold, label: str, recipe: str, tmp: Path, spec, *,
                  files: int, series: int, horizon: int, chunk: int, sizes,
                  ensemble: bool) -> dict:
    """``[predict]`` / ``[predict-long]``: ``predict`` through the CLI on the
    artifacts of the train-once phase, at full width and depth.

    - The recipe as shipped (bf16, the dynamic selector, the whole batch a
      file): the sample's header, ``files`` x ``horizon`` rows (the
      sample's keys in its order, or the forecast dates), finite and >= 0;
      every bf16 forward kernel ran on the card at each size, nothing else.
    - ``model.compute_dtype=float32`` on the card equals it on the CPU
      within 1e-4 relative; the bf16 card run equals the bf16 CPU run
      within ``BF16_CPU_TOL`` (see there).
    - ``predict.chunk_rows=chunk`` on ``spec`` (``predict.freeze_periods=on``,
      float32) equals the whole batch on it within 1e-5, one graph captured
      and replayed for every chunk, as the kernels' own run counts show.
    - ``predict.quantiles=[0.1, 0.5, 0.9]``: three more files, ordered in
      every cell.
    - With ``ensemble``: two members (the artifacts and a copy) equal the
      single model.

    Returns the card's kernel runs of the shipped recipe's run."""

    import shutil

    from flow_timesnet_tpu_torch.utils.quantiles import quantile_out_path
    from flow_timesnet_tpu_torch.utils.submission import read_submission

    out = tmp / label

    def predict(tag, *overrides):
        path = out / f"{tag}.csv"
        wall, rec = serving_cli(torch, "predict", recipe, tmp, f"submission.out_path={path}",
                                *overrides)
        return read_submission(str(path), "utf-8-sig"), wall, rec, str(path)

    data = tmp / "data"
    sample = read_submission(str(data / "sample_submission.csv"),
                             "utf-8-sig" if recipe == "demand_benchmark.yaml" else "utf-8")
    t_phase = time.perf_counter()
    clear_counts(cuda_fold)  # the shipped recipe's run, from here ...
    sub, wall, rec, path = predict("submission")
    ran, launched = run_counts(cuda_fold), launch_counts(cuda_fold)  # ... to here
    values = sub.values
    check([sub.key_column, *sub.columns] == [sample.key_column, *sample.columns],
          f"{label}: header {[sub.key_column, *sub.columns][:3]}...")
    check(len(sub.keys) == files * horizon, f"{label}: {len(sub.keys)} rows")
    if sub.keys[0].startswith("TEST_"):
        check(sub.keys == sample.keys, f"{label}: the rows are not the sample's, in its order")
    else:  # date_menu: each file's horizon, hour by hour
        stamps = np.asarray(sub.keys, dtype="datetime64[s]").reshape(files, horizon)
        check(bool((np.diff(stamps, axis=1) == np.timedelta64(1, "h")).all()),
              f"{label}: forecast dates {sub.keys[:3]}")
    check(values.shape == (files * horizon, series) and bool(np.isfinite(values).all())
          and bool((values >= 0).all()), f"{label}: submission {values.shape}, finite and >= 0")
    for kh, kw in sizes:
        size = f"{kh}x{kw}"
        check(ran["tap_conv_fwd_mma"].get(size, 0) > 0
              and ran["tap_conv_fwd"] == ran["tap_conv_fwd_mma"],
              f"{label}: forward {size} ran {ran['tap_conv_fwd']}, tensor-core "
              f"{ran['tap_conv_fwd_mma']}")
    check(not ran["tap_conv_dh"] and not ran["tap_conv_dw"], f"{label}: the card ran {ran}")
    fwd = rec.forward_ms
    print(f"[{label}] {files} TEST files x {series} series x {horizon} ahead (the recipe as "
          f"shipped, bf16, whole batch): wall {wall:.3f} s; read and pivot "
          f"{rec.seconds['read']:.3f} s; forward ms per TEST file: {fwd[0]:.3f} (warm-up and "
          f"capture) then {', '.join(f'{v:.3f}' for v in fwd[1:])} (replayed); render and "
          f"write {rec.seconds['render_write']:.3f} s; {rec.captures} graph(s) captured; "
          f"submission range [{float(values.min()):.3f}, {float(values.max()):.3f}]")
    print(f"[{label}] the card ran {ran}; the wrappers launched {launched}")

    # float32 card vs CPU, bf16 card vs CPU
    f32 = predict("float32", "model.compute_dtype=float32")[0].values
    f32_cpu, wall_cpu, _, _ = predict("float32_cpu", "model.compute_dtype=float32",
                                      "train.device=cpu")
    print(f"[{label}] float32 card vs CPU: {max_rel(np, f32, f32_cpu.values)} (CPU wall "
          f"{wall_cpu:.3f} s)")
    check(np.allclose(f32, f32_cpu.values, rtol=FLOAT32_TOL, atol=FLOAT32_TOL),
          f"{label}: float32 card vs CPU")
    bf16_cpu = predict("bf16_cpu", "train.device=cpu")[0].values
    print(f"[{label}] bf16 card vs CPU: {max_rel(np, values, bf16_cpu)}; float32 vs bf16 on the "
          f"card: {max_rel(np, values, f32)}")
    check(np.allclose(values, bf16_cpu, rtol=BF16_CPU_TOL, atol=BF16_CPU_TOL),
          f"{label}: bf16 card vs CPU beyond {BF16_CPU_TOL}")

    # chunked on the frozen spec: one graph, replayed for every chunk
    frozen = ["model.compute_dtype=float32", "predict.freeze_periods=on",
              f"train.frozen_periods_spec={json.dumps([[list(s) for s in l] for l in spec])}"]
    clear_counts(cuda_fold)
    chunked, wall_c, rec_c, _ = predict("frozen_chunked", *frozen, f"predict.chunk_rows={chunk}")
    ran_c, launched_c = run_counts(cuda_fold), launch_counts(cuda_fold)
    whole = predict("frozen_whole", *frozen, "predict.chunk_rows=off")[0].values
    n_calls = files * -(-series // chunk)
    print(f"[{label}] {chunk}-row chunks on the frozen spec (float32): {max_rel(np, chunked.values, whole)} "
          f"against the whole batch; {rec_c.captures} graph(s) captured, {len(rec_c.forward_ms)} "
          f"forwards (ms {', '.join(f'{v:.3f}' for v in rec_c.forward_ms)}), wall {wall_c:.3f} s; "
          f"the card ran {ran_c}, the wrappers launched {launched_c}")
    check(np.allclose(chunked.values, whole, rtol=1e-5, atol=1e-5),
          f"{label}: chunked frozen vs whole-batch frozen beyond 1e-5")
    check(rec_c.captures == 1 and len(rec_c.forward_ms) == n_calls,
          f"{label}: {rec_c.captures} captures, {len(rec_c.forward_ms)} forwards")
    from flow_timesnet_tpu_torch import graphs
    for kh, kw in sizes:  # wrappers: warm-up and capture; card: warm-up and every replay
        size = f"{kh}x{kw}"
        by_wrappers, by_card = launched_c["tap_conv_fwd"].get(size, 0), ran_c["tap_conv_fwd"].get(size, 0)
        per_pass = by_wrappers // (graphs.WARMUP_CALLS + 1)
        check(per_pass > 0 and by_wrappers == (graphs.WARMUP_CALLS + 1) * per_pass
              and by_card == (graphs.WARMUP_CALLS + n_calls) * per_pass,
              f"{label}: chunked forward {size}: wrappers {by_wrappers}, card {by_card}, "
              f"{n_calls} calls")

    # quantile files
    levels = (0.1, 0.5, 0.9)
    _, wall_q, _, q_path = predict("quantiles", f"predict.quantiles={list(levels)}")
    q = np.stack([read_submission(quantile_out_path(q_path, lv), "utf-8-sig").values
                  for lv in levels])
    check(bool((np.diff(q, axis=0) >= 0).all()) and bool(np.isfinite(q).all()),
          f"{label}: quantiles out of order")
    print(f"[{label}] quantiles {list(levels)}: three more files, ordered in every cell; q10 / "
          f"q50 / q90 means {', '.join(f'{float(v.mean()):.3f}' for v in q)} (mean forecast "
          f"{float(values.mean()):.3f}); wall {wall_q:.3f} s")

    if ensemble:
        member = tmp / "artifacts_copy"
        shutil.copytree(tmp / "artifacts", member)
        ens, wall_e, _, _ = predict("ensemble", f"predict.ensemble_dirs=[{member}]")
        print(f"[{label}] two-member ensemble (the artifacts and a copy): "
              f"{max_rel(np, ens.values, values)} against the single model; wall {wall_e:.3f} s")
        check(ens.keys == sub.keys and np.allclose(ens.values, values, rtol=1e-6, atol=1e-6),
              f"{label}: ensemble of copies differs from the single model")
    print(f"[{label}] phase {time.perf_counter() - t_phase:.1f} s")
    return ran


def evaluate_phase(torch, np, cuda_fold, label: str, recipe: str, tmp: Path) -> dict:
    """``[evaluate]``: ``evaluate`` through the CLI on the artifacts of the
    train-once phase: the recipe as shipped (bf16, the resident pass on the
    card) with ``evaluation.quantiles=[0.1, 0.5, 0.9]``: NLL, sMAPE and
    wsMAPE finite, coverage in [0, 1] and rising with q, every bf16 forward
    kernel run at each size and nothing else; then the artifacts copied with
    ``model.compute_dtype: float32`` in their ``config_used.yaml``, on the
    card and the CPU: each metric within 1e-4 relative. Returns the card's
    kernel runs of the shipped recipe's run."""

    import shutil

    from flow_timesnet_tpu_torch.config import load_yaml, save_yaml

    def evaluate(tag, *overrides):
        path = tmp / label / f"{tag}.json"
        wall, rec = serving_cli(torch, "evaluate", recipe, tmp, f"evaluation.out_path={path}",
                                *overrides)
        return json.loads(path.read_text("utf-8")), wall, rec

    t_phase = time.perf_counter()
    levels = [0.1, 0.5, 0.9]
    clear_counts(cuda_fold)  # the shipped recipe's run, from here ...
    res, wall, rec = evaluate("metrics", f"evaluation.quantiles={levels}")
    ran = run_counts(cuda_fold)  # ... to here
    check(all(np.isfinite(res[k]) for k in ("nll", "smape", "wsmape")), f"{label}: {res}")
    coverage = [res["quantiles"][str(q)]["coverage"] for q in levels]
    check(all(0.0 <= c <= 1.0 for c in coverage) and coverage == sorted(coverage),
          f"{label}: coverage {coverage}")
    for kh, kw in KERNEL_SIZES:
        size = f"{kh}x{kw}"
        check(ran["tap_conv_fwd_mma"].get(size, 0) > 0
              and ran["tap_conv_fwd"] == ran["tap_conv_fwd_mma"],
              f"{label}: forward {size} ran {ran['tap_conv_fwd']}")
    check(not ran["tap_conv_dh"] and not ran["tap_conv_dw"], f"{label}: the card ran {ran}")
    print(f"[{label}] {res['windows']} windows over the last {res['holdout_days']} days (bf16): "
          f"nll {res['nll']:.6f}, sMAPE {res['smape']:.6f}, wsMAPE {res['wsmape']:.6f}; "
          f"coverage {coverage}, pinball "
          f"{[res['quantiles'][str(q)]['pinball'] for q in levels]} ({res['quantile_method']}); "
          f"wall {wall:.3f} s: read and pivot {rec.seconds['read']:.3f} s, resident pass "
          f"{rec.seconds['evaluate_resident']:.3f} s, the quantiles' {len(rec.forward_ms)} "
          f"forwards {sum(rec.forward_ms) / 1e3:.3f} s; {rec.captures} graph(s) captured; the "
          f"card ran {ran}")

    art32 = tmp / "artifacts_float32"
    shutil.copytree(tmp / "artifacts", art32)
    used = load_yaml(str(art32 / "config_used.yaml"))
    used["model"]["compute_dtype"] = "float32"
    save_yaml(used, str(art32 / "config_used.yaml"))
    card, _, _ = evaluate("float32", f"artifacts.dir={art32}")
    cpu, wall_cpu, _ = evaluate("float32_cpu", f"artifacts.dir={art32}", "train.device=cpu")
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("nll", "smape", "wsmape")}
    print(f"[{label}] float32 card vs CPU: " + ", ".join(
        f"{k} {card[k]:.7f} vs {cpu[k]:.7f} (relative {rel[k]:.2e})" for k in rel)
        + f" (CPU wall {wall_cpu:.3f} s)")
    check(all(v <= FLOAT32_TOL for v in rel.values()), f"{label}: float32 card vs CPU {rel}")
    print(f"[{label}] phase {time.perf_counter() - t_phase:.1f} s")
    return ran


def stamp(phase: str) -> None:
    print(f"[clock] {phase} done at {time.perf_counter() - T0:.1f} s")


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
    from flow_timesnet_tpu_torch.data import device_windows, windows
    from flow_timesnet_tpu_torch.device import resolve_device
    from flow_timesnet_tpu_torch.ops import _build, cuda_fold, fold

    recipes = load_recipes()
    flag_rec, long_rec = recipes["flagship"], recipes["long"]

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
            elif any(w in line for w in ("registers", "spill", "wgmma", "warning")):
                print(f"[build]   {kernel}: {line.strip()}")

    # 3. each kernel against its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {}
    for kh, kw in KERNEL_SIZES:
        check_fold_plan(cuda_fold, 1, B, kh, kw)
        for batch in (B, B_TRAIN):  # served requests and float32 training steps
            check_fwd_f32_plan(cuda_fold, batch, kh, kw)
        weight = torch.randn((kh, kw, C, C), generator=gen, device=dev) * 0.3
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        for periods in PERIOD_SETS:
            geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=dev), L, P_MAX)
            check(geom.Lp == LP, f"Lp {geom.Lp} != {LP}")
            # every row holds data, the tail beyond L too: later convs read it
            h32 = torch.randn((K, B, LP, C), generator=gen, device=dev)
            for dtype in (torch.bfloat16, torch.float32):
                h = h32.to(dtype)
                name = f"fwd_{'mma' if dtype == torch.bfloat16 else 'f32'}_{kh}x{kw}"
                err = check_forward(torch, fold, cuda_fold, h, geom, weight, bias, kh, kw,
                                    f"{kh}x{kw} periods {list(periods)}")
                max_err[name] = max(max_err.get(name, 0.0), err)
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
            # the float32 step's batch has a plan of its own (every group of 4 takes an item)
            check_forward(torch, fold, cuda_fold,
                          torch.randn((K, B_TRAIN, LP, C), generator=gen, device=dev), geom,
                          weight, bias, kh, kw, f"{kh}x{kw} periods {list(periods)} B={B_TRAIN}")

    stamp("kernels")
    # the frozen-period path's exact extents, every route
    dense = check_dense_kernels(torch, F, fold, cuda_fold, gen, dev)
    stamp("kernels at the exact extent")
    # the long-context recipe's shapes, every route, timed here: late in the
    # process the profiler loses the records of some sessions
    long_k = long_kernels(torch, F, fold, cuda_fold, gen, dev)
    stamp("kernels at the long-context shapes")

    # 4. serve at the flagship width -------------------------------------------
    cfg = flagship_config(flag_rec)
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

    def make_fc(cfg_, device="cuda", graphed=False):
        fc_ = forecaster.Forecaster(params, cfg_, ids, scaler, "zscore", static, sigma, tf_cfg,
                                    device=device)
        return fc_ if graphed else eager(fc_)

    def request(fc_, raw=False):
        return fc_._forecast_raw(history, dates=dates)[:2] if raw else \
            fc_.forecast(history, dates=dates)

    fc = eager(forecaster.Forecaster(params, cfg, ids, scaler, "zscore", static, sigma, tf_cfg))
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

    clear_counts(cuda_fold)  # the main path's launches, from here ...
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
    ran = run_counts(cuda_fold)  # the kernels' own counts of the same requests
    check(ran["tap_conv_fwd"] == counts and ran["tap_conv_fwd_mma"] == counts_mma
          and not any(ran[k] for k in ("tap_conv_dh", "tap_conv_dw")),
          f"the card counted {ran}, the wrappers {counts} ({counts_mma} tensor-core)")
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

    # float32 on the card against float32 on the CPU, same request; on the
    # card its forward takes the CUDA-core kernel, 12 launches, none on the
    # tensor-core route
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    raw = {}
    for device in ("cuda", "cpu"):
        f32 = eager(forecaster.Forecaster(params, cfg32, ids, scaler, "zscore", static, sigma,
                                          tf_cfg, device=device))
        clear_counts(cuda_fold)  # the float32 request's launches, from here ...
        raw[device] = f32._forecast_raw(history, dates=dates)[:2]
        if device == "cuda":
            got = {name: dict(c) for name, c in path_counters(cuda_fold).items()}  # ... to here
            per = LAUNCHES_PER_PASS // len(KERNEL_SIZES)
            print(f"[serve] float32 request launches {got}")
            check(all(got["tap_conv_fwd"].get(f"{kh}x{kw}", 0) == per and
                      not got["tap_conv_fwd_mma"].get(f"{kh}x{kw}", 0) for kh, kw in KERNEL_SIZES)
                  and sum(got["tap_conv_fwd"].values()) == LAUNCHES_PER_PASS,
                  f"float32 request launches {got}: 12 of the CUDA-core forward, no tensor-core one")
    for name, a, b in zip(("rate", "dispersion"), raw["cuda"], raw["cpu"]):
        err = float(np.abs(a - b).max())
        print(f"[serve] float32 card vs CPU {name}: max abs diff {err:.3e}")
        check(np.allclose(a, b, rtol=TOL, atol=TOL), f"float32 {name} card vs CPU {err:.3e}")

    stamp("serve")

    # 5. where the request's device time goes ----------------------------------
    req_prof = profile(torch, lambda: fc.forecast(history, dates=dates), PROFILED, "request", p50)

    # 5, frozen: the same request on the frozen-period path ----------------------
    served_frozen = serve_frozen(torch, np, engine_mod, cuda_fold, make_fc, request, cfg,
                                 dict(zip(("x", "x_mark", "static", "ids", "floor"), args)), p50)
    stamp("serve-frozen")

    # 6. the backward kernels against their plain versions ------------------------
    bwd_err = check_backward_kernels(torch, fold, cuda_fold, gen, dev)

    # 7. train at the flagship width -----------------------------------------------
    trained = train_phase(torch, np, (windows, engine_mod, optim, cuda_fold), flag_rec, cfg,
                          params, dev)
    f32_counts = train_parity(torch, np, engine_mod, losses_mod, cuda_fold, cfg, params,
                              flag_rec.engine, trained["parity_batch"])
    step_prof = profile(torch, trained["step"], PROFILED_STEPS, "step", trained["p50"])
    stamp("train")

    # 7, frozen: the trainer's swap to the frozen-period path ------------------------
    frozen_step, frozen_p50, train_spec, frozen_counts = train_frozen(
        torch, np, engine_mod, cuda_fold, cfg, params, flag_rec.engine, trained, dev)
    f32_frozen = train_parity(torch, np, engine_mod, losses_mod, cuda_fold,
                              dataclasses.replace(cfg, frozen_periods=train_spec), params,
                              flag_rec.engine, trained["parity_batch"], per=2 * unique_periods(train_spec),
                              what="float32 frozen step")
    stamp("train-frozen")

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
        print(before_line(np, "fwd", key, rows["f32"], served, B))
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
            print(before_line(np, kind, key, [r[f"{kind}_f32"] for r in rows], trained["periods"],
                              B_TRAIN))
        # the float32 forward where a float32 step runs it: B=256, the training periods
        bias = torch.randn((C,), generator=gen, device=dev) * 0.1
        fwd_train = []
        for periods in trained["periods"]:
            geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=dev), L, P_MAX)
            check_forward(torch, fold, cuda_fold, h.float(), geom, weight, bias, kh, kw,
                          f"{kh}x{kw} training periods {list(periods)} B={B_TRAIN}")
            fwd_train.append(time_forward(torch, F, fold, cuda_fold, h.float(), geom, periods,
                                          weight, bias, kh, kw))
            print(f"[time] fwd_f32 {key} periods {list(periods)} float32 B={B_TRAIN}: "
                  f"{described(fwd_train[-1])}")
        mean = mean_of(np, fwd_train)
        print(f"[time] fwd_f32 {key} B={B_TRAIN} over the periods {trained['periods']}: kernel "
              f"{mean['ms'] * 1e3:.2f} us, cuDNN {mean['library_ms'] * 1e3:.2f} us, bound "
              f"{mean['bound_ms'] * 1e3:.3f} us ({mean['ms'] / mean['library_ms']:.2f}x cuDNN)")
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

    time_dense_kernels(torch, F, fold, cuda_fold, gen, dev, dense)
    stamp("time")

    # the float32 step's and the frozen paths' profiles, after the kernel
    # timings: a profiler session of a whole step, just before them, made
    # later sessions lose records
    float32_steps(torch, np, engine_mod, cfg, params, flag_rec.engine, trained["fixed"],
                  trained["lr"], dev)
    versus(profile(torch, served_frozen["request"], PROFILED, "frozen request",
                   served_frozen["p50"]), req_prof, "request")
    versus(profile(torch, frozen_step, PROFILED_STEPS, "frozen step", frozen_p50), step_prof,
           "step")
    stamp("profile")

    # 9-11. the CUDA graphs: the served request, the training step, the resident epoch
    eager_runs = {"dynamic": {"forecast": first, "p50": p50},
             "frozen": {"forecast": served_frozen["first"], "p50": served_frozen["p50"]}}
    graph_serve = serve_graph(torch, np, cuda_fold, make_fc, request, cfg, served_frozen["spec"],
                              eager_runs)
    stamp("serve-graph")
    graph_train = train_graph(torch, np, engine_mod, cuda_fold, cfg, params, flag_rec.engine,
                              trained, train_spec,
                              {"dynamic": trained["p50"], "frozen": frozen_p50})
    stamp("train-graph")
    resident = train_resident(torch, np, windows, device_windows, engine_mod, cuda_fold, cfg,
                              params, flag_rec.engine, trained["lr"])
    stamp("train-resident")
    graph_runs = {"serve_graph": graph_serve, "train_graph": graph_train, "resident": resident}

    # 12-14. the long-context recipe, served and trained
    long_cfg = long_config(long_rec)
    long_params = flagship_params(torch, convert, long_cfg)
    print(f"[serve-long] the long-context recipe at full width: "
          f"{sum(v.numel() for v in long_params.values()):,} parameters, use_checkpoint on")
    data = long_data(np)
    served_long = serve_long(torch, np, forecaster, cuda_fold, long_rec, long_cfg, long_params,
                             data)
    stamp("serve-long")
    trained_long = train_long(torch, np, windows, engine_mod, losses_mod, optim, cuda_fold,
                              long_rec, long_cfg, long_params, data)
    stamp("train-long")
    resident_long = train_long_resident(torch, np, windows, device_windows, engine_mod,
                                        cuda_fold, long_rec, long_cfg, long_params, data,
                                        trained_long["lr"])
    stamp("train-long-resident")

    # 15-16. train_once from a config and a CSV: the flagship and the long
    # recipe; 17-19. predict and evaluate from each run's artifacts
    def predict_flagship(tmp, spec):
        runs = {"predict": predict_phase(
            torch, np, cuda_fold, "predict", "demand_benchmark.yaml", tmp, spec,
            files=DEMAND_TEST_FILES, series=B, horizon=DEMAND_HORIZON, chunk=PREDICT_CHUNK,
            sizes=KERNEL_SIZES, ensemble=True)}
        stamp("predict")
        runs["evaluate"] = evaluate_phase(torch, np, cuda_fold, "evaluate",
                                          "demand_benchmark.yaml", tmp)
        stamp("evaluate")
        return runs

    def predict_long(tmp, spec):
        runs = {"predict_long": predict_phase(
            torch, np, cuda_fold, "predict-long", "long_context.yaml", tmp, spec,
            files=LONG_TEST_FILES, series=LONG_SERIES, horizon=LONG_HORIZON,
            chunk=PREDICT_CHUNK_LONG, sizes=LONG_SIZES, ensemble=False)}
        stamp("predict-long")
        return runs

    train_once_runs, serving_runs = {}, {}
    train_once_runs["train_once"], served = train_once_phase(
        torch, np, cuda_fold, "train-once", "demand_benchmark.yaml", write_demand_csv,
        TRAIN_ONCE_EPOCHS, KERNEL_SIZES, True, predict_flagship)
    serving_runs.update(served)
    stamp("train-once")
    train_once_runs["train_once_long"], served = train_once_phase(
        torch, np, cuda_fold, "train-once-long", "long_context.yaml", write_long_context_csv,
        TRAIN_ONCE_LONG_EPOCHS, LONG_SIZES, False, predict_long)
    serving_runs.update(served)
    stamp("train-once-long")

    # the exact-extent numbers, the frozen paths' and the graphs' launches of each kernel
    for row in kernels:
        name = row["name"][len("tap_conv_"):]
        kind, route, key = name.split("_")
        counter = f"tap_conv_{kind}{'_mma' if route == 'mma' else ''}"
        for run, paths in graph_runs.items():  # the replays run the bf16 (tensor-core) routes
            for path, res in paths.items():
                got = res["counts"]
                n = got[f"tap_conv_{kind}_mma"].get(key, 0)
                if route != "mma":  # the CUDA-core route: every launch less the tensor-core ones
                    n = got[f"tap_conv_{kind}"].get(key, 0) - n
                row[f"launches_{run}{'_frozen' if path == 'frozen' else ''}"] = n
        if name in long_k:  # the long recipe's shapes and paths (3x3 and 5x5)
            mma_route = route == "mma"
            row["long_context"] = {
                **long_k[name],
                "launches_serve_long": route_count(served_long["counts"], kind, route, key),
                "launches_train_long": route_count(
                    trained_long["dynamic"]["counts" if mma_route else "f32"], kind, route, key),
                "launches_train_long_frozen": route_count(
                    trained_long["frozen"]["counts" if mma_route else "f32"], kind, route, key),
                "launches_resident_long": route_count(resident_long["counts"], kind, route, key),
                "launches_from": "bf16 eager requests, steps and a steady resident epoch; "
                                 "float32: the long float32 parity steps"}
        # bf16 recipes: the float32 rows ran nothing
        for run, got in {**train_once_runs, **serving_runs}.items():
            row[f"launches_{run}"] = route_count(got, kind, route, key)
        row["exact_extent"] = {
            f"p{p}": {**dense[name][f"p{p}"], "lp": L + (-L) % p} for p in DENSE_PERIODS}
        row["exact_extent_max_abs_err"] = dense[name]["max_abs_err"]
        if route == "mma":
            row["launches_serve_frozen"] = served_frozen["counts"][counter].get(key, 0)
            row["launches_train_frozen"] = frozen_counts[counter].get(key, 0)
        else:  # the float32 frozen request and the float32 frozen parity step
            row["launches_serve_frozen"] = served_frozen["counts32"][counter].get(key, 0)
            row["launches_train_frozen"] = f32_frozen[counter].get(key, 0)

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
        return None
    fold_conv = [e for e in events if "tap_conv" in e.key]
    fold_us = sum(e.self_device_time_total for e in fold_conv) / n
    print(f"[profile] fold conv ({unit}): {fold_us:.2f} us per {unit} in "
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
    return {"busy_ms": busy_ms, "launches": launches, "fold_us": fold_us, "p50_ms": p50_ms}


def versus(frozen: dict, dynamic: dict, unit: str) -> None:
    """One line: a frozen-path profile beside the dynamic one of the same run."""

    if frozen is None or dynamic is None:
        print(f"[profile] frozen vs dynamic {unit}: device time not measured")
        return
    print(f"[profile] frozen vs dynamic {unit}: device busy {frozen['busy_ms']:.3f} vs "
          f"{dynamic['busy_ms']:.3f} ms in {frozen['launches']:.0f} vs {dynamic['launches']:.0f} "
          f"launches, fold conv {frozen['fold_us']:.2f} vs {dynamic['fold_us']:.2f} us, p50 "
          f"{frozen['p50_ms']:.3f} vs {dynamic['p50_ms']:.3f} ms")


if __name__ == "__main__":
    sys.exit(main())
