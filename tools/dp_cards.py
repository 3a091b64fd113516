#!/usr/bin/env python3
"""Data parallelism of the PyTorch/CUDA port on every visible NVIDIA GPU.

    python3 tools/dp_cards.py

Needs two or more cards (``chip_smoke.py`` runs on one, where NCCL across
cards cannot run). Two checks:

1. ``chip_smoke.py``'s ``[dp]`` (d): configs/high_cardinality.yaml's model at
   full width (10,000 seeded series, the series table row-sharded), global
   batches of 512 replayed from CUDA graphs on NCCL ranks, one a card,
   against one card replaying them: losses within rtol 1e-5 / atol 1e-6,
   the step ms and windows/s of both.
2. The CLI's own launch: ``cli train`` of configs/demand_benchmark.yaml for
   one epoch on its benchmark CSV (written with numpy) spawns one rank per
   card; then ``cli predict`` of its artifacts on the cards, and on one card
   (``predict.data_parallel=off``), whose submissions must have the same
   keys and values within 1e-4 relative.
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(HERE))

    import numpy as np
    import torch

    import chip_smoke as cs
    from flow_timesnet_tpu_torch import cli, convert
    from flow_timesnet_tpu_torch.build import merged_config_from_yaml
    from flow_timesnet_tpu_torch.data import windows
    from flow_timesnet_tpu_torch.device import resolve_device
    from flow_timesnet_tpu_torch.ops import _build
    from flow_timesnet_tpu_torch.utils.submission import read_submission

    resolve_device("cuda")
    cards = torch.cuda.device_count()
    print(f"{cs.card_line()} x {cards}", flush=True)
    if cards < 2:
        cs.fail(f"{cards} card(s) visible: this check needs two or more")
    _build.build_all()

    hc = cs.Recipe(merged_config_from_yaml(str(HERE / "configs" / "high_cardinality.yaml")),
                   {}, {}, {})
    n_series = cs.DP_STORES * cs.DP_MENUS
    cfg = dataclasses.replace(cs.recipe_config(hc, 5, n_series), dropout=0.0)
    t = hc.merged["train"]
    engine_kw = dict(device="cuda", use_loss_masking=bool(t["use_loss_masking"]),
                     grad_clip_norm=float(t["grad_clip_norm"]),
                     weight_decay=float(t["weight_decay"]), num_series=n_series)
    params = {k: v.numpy() for k, v in cs.flagship_params(torch, convert, cfg).items()}
    batches, sigma = cs.dp_windows(np, windows, cfg)
    t0 = time.perf_counter()
    cs.dp_across_cards(torch, np, dict(
        model_kw={**dataclasses.asdict(cfg), "compute_dtype": "float32"}, params=params,
        batches=batches[:cs.DP_STEPS], sigma=sigma, engine_kw=engine_kw))
    print(f"[dp-cards] (d) {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="dp_cards_") as tmp:
        tmp = Path(tmp)
        data = tmp / "data"
        cs.write_demand_csv(np, data / "train.csv")
        base = ["--config", str(HERE / "configs" / "demand_benchmark.yaml"), "--override",
                f"data.train_csv={data / 'train.csv'}", f"data.test_dir={data / 'test'}",
                f"data.sample_submission={data / 'sample_submission.csv'}",
                f"artifacts.dir={tmp / 'artifacts'}"]
        t0 = time.perf_counter()
        cli.main(["train", *base, "train.epochs=1"])
        print(f"[dp-cards] cli train, one epoch on {cards} cards: {time.perf_counter() - t0:.1f} s",
              flush=True)
        subs = {}
        for name, extra in (("cards", []), ("one", ["predict.data_parallel=off"])):
            t0 = time.perf_counter()
            cli.main(["predict", *base, f"submission.out_path={tmp / name}.csv", *extra])
            subs[name] = read_submission(str(tmp / f"{name}.csv"), "utf-8-sig")
            print(f"[dp-cards] cli predict on {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        got, want = subs["cards"], subs["one"]
        diff = np.abs(got.values - want.values)
        print(f"[dp-cards] the cards' submission against one card's: "
              f"{int((diff > 0).sum())} of {diff.size} cells differ, "
              f"{cs.max_rel(np, got.values, want.values)}", flush=True)
        cs.check((got.keys, got.columns) == (want.keys, want.columns)
                 and bool(np.all(diff <= cs.DP_PREDICT_RTOL * np.abs(want.values))),
                 "the cards' submission is not one card's within 1e-4")
    print("[dp-cards] ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
