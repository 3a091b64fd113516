"""The program's own tracing on the benchmark's cells, on the card.

    python3 tools/trace_regions.py --workload flagship.train --seed 7 \\
        [--seconds 10] [--cost-seconds 8] [--cost-rounds 1]

Builds the cell as ``portbench/run.py`` does (set-up, a window of
``--seconds``, its trace), then ``portbench/harness/regions.py``'s phase
(tracing on: the marked graphs' capture, a timed span of the trace's units,
a profiled one) and prints the per-layer numbers the regions and spans give
beside what surrounds them in the same process: the step's regions against
the traced step time and the profiled span's device time, the pointwise
regions against the GEMM kernels (cuBLAS's ``*gemm*`` and ``nvjet*``), the
profiled span's costliest kernels, the ``Forecaster``'s own host time against
``host_ms.serve``, the captures against ``capture_s``, and the 1x1 convs'
routes as ``ops/fold.py::pointwise_runs`` counted them over the process.
Then the cost of tracing: the cell's timed entry with tracing off, on, on,
off, for ``--cost-seconds`` each, ``--cost-rounds`` times. Standard error gets the
regions a unit and the idle seconds by program span; standard output ends
in one JSON line. No check against the reference runs.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def cost(cell, seconds: float, rounds: int) -> dict:
    """The median seconds a unit (step or request) of the timed entry in
    ``rounds`` rounds of four phases, tracing off, on, on, off, each
    ``seconds`` long after one warm call (which captures the marked graphs
    again: turning tracing off drops them); and the cost of tracing, the
    mean of the on phases' medians less the mean of the off phases'. A
    serving phase also times 100 replays of the request's forward alone
    (``Engine.forward`` on its prepared inputs, ending in a synchronise)."""

    from flow_timesnet_tpu_torch import tracing

    from portbench.harness import program

    run = cell.run
    train = run.ctx["kind"] == "train"
    if not train:
        _, h, s = cell.request()
        args = program.request_batch(cell.fc, h, s)
    phases = {"off": [], "on": [], "replay_off": [], "replay_on": []}
    for _ in range(rounds):
        for on in (False, True, True, False):
            tracing.enable(on)
            per = []
            for timed in (False, True):
                t0 = time.perf_counter()
                while True:
                    if train:
                        t = time.perf_counter()
                        cell.call(cell.plan.take(cell.chunk))
                        run.sync()
                        per.append((time.perf_counter() - t) / cell.chunk)
                    else:
                        _, h, s = cell.request()
                        t = time.perf_counter()
                        cell.fc.forecast(h, dates=s)
                        per.append(time.perf_counter() - t)
                    if not timed or time.perf_counter() - t0 >= seconds:
                        break
                if not timed:
                    per = []
            phases["on" if on else "off"].append(statistics.median(per))
            if not train:
                per = []
                for _ in range(100):
                    t = time.perf_counter()
                    cell.fc.engine.forward(*args)
                    run.sync()
                    per.append(time.perf_counter() - t)
                phases["replay_on" if on else "replay_off"].append(statistics.median(per))
            tracing.enable(False)
    out = {k: v for k, v in phases.items() if v}
    out["cost"] = statistics.mean(phases["on"]) - statistics.mean(phases["off"])
    if not train:
        out["replay_cost"] = (statistics.mean(phases["replay_on"])
                              - statistics.mean(phases["replay_off"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost-seconds", type=float, default=8.0)
    ap.add_argument("--cost-rounds", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from flow_timesnet_tpu_torch.ops import fold
    from portbench import run as prun
    from portbench.harness import manifest, regions

    if not torch.cuda.is_available():
        print("trace_regions: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    fold.clear_pointwise_runs()
    found = manifest.cell(manifest.load(), args.workload)
    run = prun.Run(torch, found, args.seed, args.seconds, True)
    cell = importlib.import_module(f"portbench.harness.{found['traffic']['kind']}").Cell(run)
    cell.setup()
    gc.collect()
    gc.freeze()  # as portbench/run.py: what set-up made stays out of the collections
    cell.window(args.seconds)
    cell.traced()
    ctx = run.ctx
    ctx.update(regions.measure(cell))
    regions.report(ctx)
    n = ctx["region_units"]
    reg = {k: (c / n, 1e3 * s / n) for k, (c, s) in ctx["regions"].items()}
    tr = ctx["traced_trace"]
    ms = {k: v[1] for k, v in reg.items()}
    gemm_ms = 1e3 * (tr.matching("gemm")[1] + tr.matching("nvjet")[1]) / n
    top = sorted(tr.kernels.items(), key=lambda kv: -kv[1][1])[:10]
    out = {"workload": args.workload, "seed": args.seed,
           "regions_a_unit": reg, "traced_unit_ms": 1e3 * ctx["traced_unit_s"],
           "graph_captures": ctx["graph_captures"], "graph_capture_s": ctx["graph_capture_s"],
           "capture_s": ctx["capture_s"],
           "profiled_busy_ms_a_unit": 1e3 * tr.busy_s / n,
           "profiled_gemm_ms_a_unit": gemm_ms,
           "top_kernels_ms_a_unit": {k[:72]: 1e3 * v[1] / n for k, v in top},
           "pointwise_routes": fold.pointwise_runs(),
           "idle_by_span_ms": {k: 1e3 * v for k, v in ctx["idle_by_span"].items()}}
    pointwise = ms.get("pointwise.fwd", 0.0) + ms.get("pointwise.bwd", 0.0)
    if ctx["kind"] == "train":
        step = sum(ms.get(k, 0.0) for k in ("step.gather", "step.forward", "step.backward",
                                             "step.optimizer"))
        out.update(gather_ms=ms.get("step.gather"), optimizer_ms=ms.get("step.optimizer"),
                   pointwise_ms=pointwise, regions_sum_ms=step,
                   regions_over_step=step / (1e3 * ctx["traced_unit_s"]),
                   regions_over_busy=step / (1e3 * tr.busy_s / n),
                   pointwise_over_gemm=pointwise / gemm_ms,
                   pointwise_over_fwd_bwd=pointwise / (ms["step.forward"] + ms["step.backward"]),
                   window_step_ms=1e3 * ctx["step_s"])
    else:
        out.update(pointwise_ms=ms.get("pointwise.fwd"),
                   forecaster_host_ms=1e3 * ctx["forecaster_host_s"],
                   host_ms=1e3 * ctx["host_s"],
                   model_forward_ms=ms.get("model.forward"),
                   window_request_mean_ms=1e3 * ctx["request_mean_s"])
    cost_s = cost(cell, args.cost_seconds, args.cost_rounds)
    out["cost_ms_a_unit"] = {k: ([1e3 * x for x in v] if isinstance(v, list) else 1e3 * v)
                             for k, v in cost_s.items()}
    out["card"] = prun.card_line()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
