"""Command-line interface (counterpart of ``flow_timesnet_tpu/cli.py``):

    python -m flow_timesnet_tpu_torch.cli train --config configs/demand_benchmark.yaml

Every subcommand takes a ``--config`` YAML plus dotted ``--override
key=value`` pairs. ``train`` runs ``train.py::train_once`` on the card
(``--override train.device=cpu`` runs it on the CPU); ``predict``,
``evaluate`` and ``tune`` are not ported yet and say which ROADMAP item
ports them.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .config import PipelineConfig

_NOT_PORTED = {
    "predict": "ROADMAP.md section 1 item 7 (predict.py)",
    "evaluate": "ROADMAP.md section 1 item 7 (evaluate.py)",
    "tune": "ROADMAP.md section 1 item 8 (tune.py)",
}


def cmd_train(args: argparse.Namespace) -> None:
    from .train import train_once

    cfg = PipelineConfig.from_files(args.config, overrides=args.override)
    best_nll, _ = train_once(cfg)
    print(f"Final best NLL: {best_nll:.6f}", flush=True)


def _not_ported(args: argparse.Namespace) -> None:
    raise NotImplementedError(
        f"'{args.command}' is not ported to the PyTorch package yet: {_NOT_PORTED[args.command]}"
    )


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

    p_train = sub.add_parser("train", help="Train and emit artifacts")
    add_common(p_train)
    p_train.set_defaults(func=cmd_train)
    for name, what in (("predict", "Run inference from stored artifacts"),
                       ("evaluate", "Score stored artifacts on a holdout CSV"),
                       ("tune", "Hyper-parameter search around train_once")):
        p = sub.add_parser(name, help=f"{what} (not ported yet)")
        add_common(p)
        p.set_defaults(func=_not_ported)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    # --override is repeatable (action=append) and multi-valued (nargs=*):
    # argparse yields a list of lists
    args.override = [o for group in args.override for o in group]
    args.func(args)


if __name__ == "__main__":
    main()
