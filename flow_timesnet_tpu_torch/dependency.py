"""Environment bootstrap (counterpart of ``flow_timesnet_tpu/dependency.py``):
``python -m flow_timesnet_tpu_torch.dependency`` seeds the generators and
lists the CUDA devices."""

from __future__ import annotations

from typing import List

import torch

from .utils.seed import seed_everything


def bootstrap(seed: int = 2025):
    """Seed the generators and return (seed, the CUDA device names)."""

    seed = seed_everything(seed)
    devices: List[str] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    return seed, devices


def main() -> None:
    seed, devices = bootstrap()
    print(f"devices: {devices or 'no CUDA device'}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"seed: {seed}")


if __name__ == "__main__":
    main()
