"""One run of one cell of the benchmark of ``flow_timesnet_tpu_torch``.

    python3 portbench/run.py --workload flagship.train --seed 7 --seconds 10 --trace 0

Set-up (from the start of the process to the first timed call) builds the
cell from the seed; the window measures for ``--seconds``; with
``--trace 1`` a short profiled span and the per-layer readings follow.
Then the reference checks what the timed path produced. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (end-to-end, or per-layer with ``--trace 1``),
``device``, with a trace ``breakdown``, then ``card`` and, last,
``checks`` (each compared number and its limit, also the last lines of
standard error). Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started, from ``/proc``."""

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = time.monotonic() - _process_age()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# every cache a run may write, at fixed paths inside the checkout
CACHE = ROOT / "build" / "portbench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "flow_timesnet_tpu")  # top-level module names, whole


class Run:
    """One run's inputs and what its phases leave for the readers and the check."""

    def __init__(self, torch, found: dict, seed: int, seconds: float, traced: bool,
                 device: str = "cuda") -> None:
        self.torch = torch
        self.config, self.traffic = found["config"], found["traffic"]
        self.limits = found["limits"]
        self.seed, self.seconds, self.traced, self.device = seed, seconds, traced, device
        self.ctx: dict = {"kind": self.traffic["kind"], "trace": None, "trace_ok": False}
        self.attempted = self.failed = 0
        self.checks: dict = {}
        self.correct = False
        self.marks: list = []

    def mark(self, label: str) -> None:
        """Note the seconds since the process started at the end of a phase."""

        self.marks.append((label, time.monotonic() - T_START))

    def sync(self) -> None:
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def release(self) -> None:
        """Hand back what the program held before the reference runs."""

        gc.collect()
        if self.device != "cpu":
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()

    def judge(self, readings: dict) -> None:
        for name, value in readings.items():
            if name not in self.limits:
                raise KeyError(f"no limit for {name!r}")
            self.checks[name] = {"value": value, "limit": self.limits[name]}
        self.correct = (bool(self.checks) and self.failed == 0 and self.attempted > 0
                        and all(c["value"] <= c["limit"] for c in self.checks.values()))


def card_line() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    name, _, limit = out.stdout.strip().splitlines()[0].rpartition(",")
    return {"name": name.strip(), "power_limit_w": float(limit)}


def execute(run: Run) -> None:
    """Set-up, window, trace and check of one cell (the ``Run`` collects)."""

    torch = run.torch
    run.mark("imports")
    module = importlib.import_module(f"portbench.harness.{run.traffic['kind']}")
    unread = sorted(set(run.traffic) - {"kind"} - set(module.TRAFFIC_KEYS))
    if unread:
        raise ValueError(f"the traffic mix sets {unread}, which a {run.traffic['kind']} cell "
                         f"does not read")
    cell = module.Cell(run)
    run.mark("cell built")
    cell.setup()
    run.mark("first calls")
    run.ctx["setup_s"] = run.marks[-1][1]
    gc.collect()
    gc.freeze()  # what set-up made stays out of the collections the window pays for
    if run.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    cell.window(run.seconds)
    if run.device != "cpu":
        run.ctx["peak_bytes"] = torch.cuda.max_memory_allocated()
    run.mark("window")
    if run.traced:
        cell.traced()
        run.mark("trace")
    gc.unfreeze()
    cell.check()
    run.mark("check")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import manifest

    bench = manifest.load()
    found = manifest.cell(bench, args.workload)
    import torch

    chips = int(found["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)  # one host thread: the card does the work
    # the reference's float32 stays float32 (the program sets the same on its own)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(torch, found, args.seed, args.seconds, bool(args.trace))
    execute(run)

    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad}, which the port must not import", file=sys.stderr)
        return 4
    metrics = {}
    for m in manifest.metrics(bench, args.workload, run.traced):
        value = manifest.reader(m["name"])(run.ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(run.ctx["peak_bytes"])}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    tr = run.ctx.get("trace")
    if run.traced and tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.span_s)
        result["breakdown"] = {"device_ops": [[k, v] for k, v in tr.device_ops],
                               "idle_gaps": [[k, v] for k, v in tr.idle_gaps]}
    result["card"] = card_line()
    result["checks"] = run.checks
    print(f"portbench: {result['card']['name']}, power limit {result['card']['power_limit_w']} W; "
          f"{args.workload} seed {args.seed}: correct {run.correct}", file=sys.stderr)
    print("portbench: seconds since the start at the end of each phase: "
          + ", ".join(f"{label} {t:.3f}" for label, t in run.marks), file=sys.stderr)
    if "quiet_leaves" in run.ctx:
        print(f"portbench: leaves left out of the changes (gradient under a thousandth of the "
              f"median leaf's): {run.ctx['quiet_leaves']}", file=sys.stderr)
    if "tie_branches" in run.ctx:
        print(f"portbench: the reference followed {run.ctx['tie_branches']} way(s) of resolving "
              f"the selector's near-ties", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']:.6e} limit {c['limit']:.6e}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
