"""Command-line interface (counterpart of ``flow_timesnet_tpu/cli.py``):

    python -m flow_timesnet_tpu_torch.cli train    --config configs/demand_benchmark.yaml
    python -m flow_timesnet_tpu_torch.cli evaluate --config configs/demand_benchmark.yaml
    python -m flow_timesnet_tpu_torch.cli predict  --config configs/demand_benchmark.yaml
    python -m flow_timesnet_tpu_torch.cli tune     --config configs/demand_benchmark.yaml \
        --search-space configs/search_space_flagship.yaml --n-trials 3

Every subcommand takes a ``--config`` YAML plus dotted ``--override
key=value`` pairs. ``train`` runs ``train.py::train_once``, ``predict``
``predict.py::predict_once``, ``evaluate`` ``evaluate.py::evaluate_once``
and ``tune`` ``tune.py::tune``, each on the card (``--override
train.device=cpu`` runs it on the CPU).

``train``, ``predict`` and ``tune`` run data-parallel on every visible card
(``train.data_parallel`` / ``predict.data_parallel``, default ``auto``):
where more than one card is visible the command spawns one rank per card
(NCCL, a TCP store on localhost) and waits for them; under ``torchrun``
(``torchrun --nproc-per-node N -m flow_timesnet_tpu_torch.cli train ...``)
each process joins the group that its environment describes. A rank that
fails fails the command. ``evaluate`` runs on one card, as the JAX
package's has no mesh.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .config import PipelineConfig
from .parallel import mesh


def cmd_train(args: argparse.Namespace) -> None:
    from .train import train_once

    cfg = PipelineConfig.from_files(args.config, overrides=args.override)
    best_nll, _ = train_once(cfg)
    print(f"Final best NLL: {best_nll:.6f}", flush=True)


def cmd_predict(args: argparse.Namespace) -> None:
    from .predict import predict_once

    predict_once(PipelineConfig.from_files(args.config, overrides=args.override))


def cmd_evaluate(args: argparse.Namespace) -> None:
    from .evaluate import evaluate_once

    evaluate_once(PipelineConfig.from_files(args.config, overrides=args.override))


def cmd_tune(args: argparse.Namespace) -> None:
    from .tune import tune

    tune(PipelineConfig.from_files(args.config, overrides=args.override), args.search_space,
         n_trials=args.n_trials)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="flow-timesnet-torch",
        description="TimesNet demand forecasting pipeline on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def add_common(p: argparse.ArgumentParser) -> None:
        p.add_argument("--config", type=str, default="configs/default.yaml")
        p.add_argument(
            "--override",
            nargs="*",
            action="append",
            default=[],
            help=(
                "Dotted key=value overrides (e.g. window.input_len=64); "
                "repeatable and accepts multiple pairs per flag"
            ),
        )

    for name, what, func in (
            ("train", "Train and emit artifacts", cmd_train),
            ("predict", "Run inference from stored artifacts", cmd_predict),
            ("evaluate", "Score stored artifacts on a holdout CSV", cmd_evaluate),
            ("tune", "Hyper-parameter search around train_once", cmd_tune)):
        p = sub.add_parser(name, help=what)
        add_common(p)
        p.set_defaults(func=func)
        if name == "tune":
            p.add_argument("--search-space", type=str, default="configs/search_space.yaml")
            p.add_argument("--n-trials", type=int, default=None)
    return parser


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    # --override is repeatable (action=append) and multi-valued (nargs=*):
    # argparse yields a list of lists
    args.override = [o for group in args.override for o in group]
    return args


def _rank_command(argv: List[str]) -> None:
    """One rank of a spawned command (its group already set up)."""

    args = _parse(argv)
    args.func(args)


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse(argv)
    if args.command == "evaluate" or mesh.current() is not None:
        args.func(args)
        return
    raw = PipelineConfig.from_files(args.config, overrides=args.override).to_dict()
    train_cfg = raw.get("train") or {}
    section = (raw.get("predict") or {}) if args.command == "predict" else train_cfg
    on_card = str(train_cfg.get("device", "")).lower() != "cpu"
    dcn = int(train_cfg.get("dcn_slices", 1) or 1)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        mesh.setup_from_env(device="cuda" if on_card else "cpu", dcn_slices=dcn)
        try:
            args.func(args)
        finally:
            mesh.teardown()
        return
    import torch

    n_cards = torch.cuda.device_count() if on_card and torch.cuda.is_available() else 0
    if n_cards > 1 and mesh.dp_enabled(section):
        print(f"Launching {n_cards} ranks, one per card", flush=True)
        mesh.launch(_rank_command, n_cards, argv, device="cuda", dcn_slices=dcn)
        return
    args.func(args)


if __name__ == "__main__":
    main()
