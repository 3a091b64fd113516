"""Readings that set a cell's limits: the program's, the control's and the
faults', over many seeds in one process. The benchmark's own runs never
call this.

    python3 portbench/controls.py --workload flagship.train --mode program --seeds 1,2,3
    python3 portbench/controls.py --workload flagship.train --mode control --seeds 1,2,3

``program``: a run of the cell (``--seconds`` long, 1 by default) for each
seed, its readings. ``control``: the reference put in the program's place,
computed in float8 (e4m3) where the configuration computes in bfloat16,
against the reference; for a serving cell on the requests a run's sample
would hold. ``half``: the reference put in the program's place with half of
each batch left out and the mean taken over the rest (training cells).
Each line is JSON: the seed and the readings.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import run as prun  # noqa: E402  (sets the cache directories)
from portbench.harness import data as hdata  # noqa: E402
from portbench.harness import manifest  # noqa: E402


def params_of(run, found):
    from portbench.harness import program

    ds = hdata.dataset(found["config"])
    tn = program.model_config(found["config"], ds)
    return ds, program.weights(tn, found["config"]["model"], run.seed, run.device)


def control_train(run, found, mode: str) -> dict:
    from portbench.harness import train as htrain

    ds, params = params_of(run, found)
    B = int(found["config"]["train"]["batch_size"])
    plan = hdata.Plan(hdata.windows_total(ds, int(found["config"]["model"]["input_len"]),
                                          int(found["config"]["model"]["pred_len"])), B, run.seed)
    rows = plan.take(int(found["traffic"]["checked_steps"]))
    gen_seed = (int(run.seed) * 7919 + 1) % (2 ** 63)
    dtype = found["config"]["model"]["compute_dtype"]
    wants = htrain.reference_states(run, params, rows, gen_seed, dtype)
    if mode == "control":
        got = htrain.reference_states(run, params, rows, gen_seed, "float8", ties=False)[0]
    else:  # half: the first half of each batch, its mean
        got = htrain.reference_states(run, params, rows[:, : B // 2], gen_seed, dtype,
                                      ties=False)[0]
    want = htrain.closest(got, wants, found["limits"])
    out = htrain.readings_by_leaf(got, want)
    return {**htrain.readings(got, want),
            "at": {k: v[1] for k, v in out.items() if isinstance(v, tuple)}}


def control_serve(run, found) -> dict:
    from portbench.harness import serve as hserve

    ds, params = params_of(run, found)
    L = int(found["config"]["model"]["input_len"])
    cuts = hdata.cuts(ds, L, int(found["traffic"]["cuts"]), run.seed)
    n = int(found["traffic"]["checked_requests"])
    picked = [(int(c), hserve.reference_forecasts(run, ds, params, int(c), "float8",
                                                  ties=False)[0]) for c in cuts[:n]]
    return {"forecast_gap": hserve.forecast_gap(run, ds, params, picked,
                                                found["config"]["model"]["compute_dtype"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control", "half"), required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    found = manifest.cell(manifest.load(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = prun.Run(torch, found, seed, args.seconds, False, device=args.device)
        if args.mode == "program":
            prun.execute(run)
            out = {k: c["value"] for k, c in run.checks.items()}
            out["at"] = run.ctx.get("leaves")
            out["quiet"] = run.ctx.get("quiet_leaves")
        elif found["traffic"]["kind"] == "train":
            out = control_train(run, found, args.mode)
        else:
            out = control_serve(run, found)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed, **out}),
              flush=True)
        run.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
