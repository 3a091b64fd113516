"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip. They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch. ``tests/conftest.py`` imports JAX, so on such a machine run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flow_timesnet_tpu_torch.device import resolve_device  # noqa: E402
from flow_timesnet_tpu_torch.ops import cuda_fold, fold  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")  # also pins float32 (TF32 off), as the port's path does


def _inputs(seed, K, B, L, Lp, C, kh, kw):
    rng = np.random.default_rng(seed)
    # non-zero values beyond L: a later conv of the stack reads them as grid cells
    h = rng.standard_normal((K, B, Lp, C)).astype(np.float32)
    kernel = (rng.standard_normal((kh, kw, C, C)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return h, kernel, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("periods", [[7, 14], [4, 27], [1, 27]])
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5), (7, 7), (1, 3)])
def test_tap_conv_kernel_matches_plain(cuda, kh, kw, periods, dtype):
    B, L, C = 16, 28, 32
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=cuda), L, L - 1)
    h, kernel, bias = _inputs(1, len(periods), B, L, geom.Lp, C, kh, kw)
    h_t = torch.from_numpy(h).to(cuda).to(dtype)
    k_t, b_t = torch.from_numpy(kernel).to(cuda), torch.from_numpy(bias).to(cuda)
    before = cuda_fold.launches[f"{kh}x{kw}"]
    got = cuda_fold.tap_conv(h_t, geom, k_t, b_t, kh, kw)
    torch.cuda.synchronize()
    assert cuda_fold.launches[f"{kh}x{kw}"] == before + 1
    want = fold.tap_conv(h_t, geom, k_t, b_t, kh, kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # bf16 x bf16 products are exact in float32: only the summation order differs
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_tap_conv_kernel_rejects_what_it_cannot_take(cuda):
    geom = fold.make_geometry(torch.tensor([4], dtype=torch.int32, device=cuda), 8, 7)
    h = torch.zeros((1, 2, geom.Lp, 4), device=cuda)
    with pytest.raises(TypeError):
        cuda_fold.tap_conv(h.half(), geom, torch.zeros(3, 3, 4, 4, device=cuda),
                           torch.zeros(4, device=cuda), 3, 3)
    with pytest.raises(ValueError, match="odd"):
        cuda_fold.tap_conv(h, geom, torch.zeros(2, 2, 4, 4, device=cuda),
                           torch.zeros(4, device=cuda), 2, 2)
    with pytest.raises(ValueError, match="device"):
        cuda_fold.tap_conv(h, geom, torch.zeros(3, 3, 4, 4), torch.zeros(4), 3, 3)
    # beyond the kernel's capacity (2048 output channels per block): the
    # kernel itself refuses with cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="cudaError_t 1 "):
        cuda_fold.tap_conv(h, geom, torch.zeros(3, 3, 4, 4096, device=cuda),
                           torch.zeros(4096, device=cuda), 3, 3)
