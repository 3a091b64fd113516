#!/usr/bin/env python3
"""Device time of the bf16 weight-gradient kernels (dW) at the long-context
recipe's shapes on one NVIDIA GPU, for one checkout of the PyTorch/CUDA port.

    python3 tools/dw_band_profile.py [ROOT]

ROOT (default: this checkout) is the checkout whose ``flow_timesnet_tpu_torch``
runs, and whose kernels it builds. The shapes are ``chip_smoke.py``'s long
context ones: B=64, 32 channels, 3x3 and 5x5, on the dynamic fold (K=4 at
periods 511, 168, 24 and 7, Lp 1023) and the exact extents of p=25 and
p=171 (Lp 525 and 513). For each: the plan, the kernel against its plain
version on the card (rtol 1e-4 and 1e-4 of the largest value) and the same
bits twice, then device time (torch.profiler, ``chip_smoke.time_ms``, every
kernel of the call: pass 1 and pass 2) with each kernel's share, and the
time of a call back to back, beside the bound, the plain version's device
time (``ops/fold.py::tap_weight_grad`` on the card, 10 calls) and cuDNN's
``conv2d_weight`` over the exact grids. The compiler's report of the dW
kernels comes first, the card's name and power limit beside it, and one
JSON line last. Run it for two checkouts in turns (A, B, B, A) to compare
them on one card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ITERS = 100
PLAIN_ITERS = 10  # the plain version takes milliseconds a call


def kernel_shares(torch, fn, calls: int = 50) -> dict:
    """Device us a call of each kernel ``fn`` launches, from one profiler session."""

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.self_device_time_total / calls, 2)
            for e in prof.key_averages() if e.device_type.name == "CUDA" and e.count}


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path[:0] = [str(root), str(HERE)]  # the package under test, then chip_smoke.py

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this measurement needs an NVIDIA GPU")
    import flow_timesnet_tpu_torch as pkg
    from flow_timesnet_tpu_torch.device import resolve_device
    from flow_timesnet_tpu_torch.ops import _build, cuda_fold, fold

    cs.check(Path(pkg.__file__).resolve().is_relative_to(root), f"imported {pkg.__file__}")
    dev = resolve_device("cuda")
    print(f"[env] {cs.card_line()}; package {Path(pkg.__file__).parent}")
    lib = _build.build("tap_conv_bwd.cu")
    kernel = "?"
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = cs.kernel_label(line)
        elif "warning" in line or "dw_" in kernel and (
                "registers" in line or "spill" in line or "wgmma" in line):
            print(f"[build] {kernel}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for kh, kw in cs.LONG_SIZES:
        for label, (periods, geom) in cs.long_geometries(torch, fold, dev).items():
            shape = (len(periods), cs.LONG_B, geom.Lp, cs.C, cs.C, kh, kw, geom.p_max)
            plan = cuda_fold.dw_mma_plan(*shape)
            h, ct = (torch.randn((len(periods), cs.LONG_B, geom.Lp, cs.C), generator=gen,
                                 device=dev).to(torch.bfloat16) for _ in range(2))
            got = [cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw) for _ in range(2)]
            want = fold.tap_weight_grad(h, geom, ct, kh, kw)
            torch.cuda.synchronize()
            err = float((got[0] - want).abs().max())
            ok = bool(torch.allclose(got[0], want, rtol=cs.TOL,
                                     atol=cs.TOL * float(want.abs().max())))
            same = bool(torch.equal(got[0], got[1]))
            key = f"{kh}x{kw} {label} Lp={geom.Lp}"
            print(f"[dw] {key}: plan {plan._asdict()}")
            print(f"[dw] {key}: max |kernel - plain| {err:.3e} {'ok' if ok else 'FAIL'}; "
                  f"the same bits twice: {same}")
            cs.check(ok and same, f"{key}: the kernel disagrees with the plain version")
            run = lambda: cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)  # noqa: E731
            plain = lambda: fold.tap_weight_grad(h, geom, ct, kh, kw)  # noqa: E731
            _, run_lib, _ = cs.library_conv_bwd(torch, h, ct, periods, torch.zeros(
                (kh, kw, cs.C, cs.C), device=dev, dtype=h.dtype), kh, kw, cs.LONG_B, geom.L)
            b_ms, b_by, _ = cs.bound(periods, kh, kw, "bfloat16", cs.LONG_B, "dw", geom.Lp,
                                     geom.L)
            row = {"size": f"{kh}x{kw}", "geometry": label, "lp": geom.Lp,
                   "ms": cs.time_ms(torch, run, ITERS), "call_ms": cs.call_ms(torch, run, ITERS),
                   "plain_ms": cs.time_ms(torch, plain, PLAIN_ITERS),
                   "library_ms": cs.time_ms(torch, run_lib, ITERS), "bound_ms": b_ms,
                   "bound_by": b_by, "kernels_us": kernel_shares(torch, run),
                   "scratch_mb": cs.scratch_bytes(torch, run) / 1e6,
                   "max_abs_err": err}
            rows.append(row)
            print(f"[dw] {key}: {row['ms'] * 1e3:.2f} us (a call back to back "
                  f"{row['call_ms'] * 1e3:.2f} us; by kernel {row['kernels_us']}), plain "
                  f"{row['plain_ms'] * 1e3:.2f} us, cuDNN "
                  f"{row['library_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}), "
                  f"scratch {row['scratch_mb']:.2f} MB")
    print(json.dumps({"root": str(root), "card": cs.card_line(), "dw": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
