"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; a missing card raises.

    A request for ``cuda`` never drifts to the CPU: the CPU path is taken
    only when the caller names it. On a CUDA device, float32 matmuls and
    cuDNN convolutions are pinned to full float32 (TF32 keeps about three
    decimal digits, and the JAX reference accumulates bf16 and float32
    products in float32), and cuBLAS may not reduce a bf16 GEMM's split-K
    partial sums in bf16. That setting is process-wide: it holds for every
    torch computation in the process from then on. This function is the
    port's one owner of it.
    """

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
