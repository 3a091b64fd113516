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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("periods", [[7, 14], [4, 27], [1, 27]])
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5), (7, 7), (1, 3)])
def test_backward_kernels_match_plain(cuda, kh, kw, periods, dtype):
    B, L, C = 16, 28, 32
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=cuda), L, L - 1)
    h, kernel, _ = _inputs(2, len(periods), B, L, geom.Lp, C, kh, kw)
    ct, _, _ = _inputs(3, len(periods), B, L, geom.Lp, C, kh, kw)  # over all Lp rows
    h_t, ct_t = (torch.from_numpy(a).to(cuda).to(dtype) for a in (h, ct))
    k_t = torch.from_numpy(kernel).to(cuda)
    key = f"{kh}x{kw}"
    before = (cuda_fold.launches_dh[key], cuda_fold.launches_dw[key],
              cuda_fold.launches_dw_mma[key])
    dh = cuda_fold.tap_conv_dh_cuda(ct_t, geom.periods, geom.cycles, k_t, kh, kw)
    dw = cuda_fold.tap_conv_dw_cuda(h_t, geom.periods, geom.cycles, ct_t, kh, kw, p_max=L - 1)
    torch.cuda.synchronize()
    # bf16 takes the tensor-core route, float32 the CUDA-core one
    mma = int(dtype == torch.bfloat16)
    assert (cuda_fold.launches_dh[key], cuda_fold.launches_dw[key],
            cuda_fold.launches_dw_mma[key]) == (before[0] + 1, before[1] + 1, before[2] + mma)
    want_dh = fold.tap_conv_dh(ct_t, geom, k_t, kh, kw)
    want_dw = fold.tap_weight_grad(h_t, geom, ct_t, kh, kw)
    assert dh.dtype == dw.dtype == torch.float32
    # exact float32 products, summed in another order; dW sums K*B*Lp of them
    torch.testing.assert_close(dh, want_dh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4, atol=1e-4 * float(want_dw.abs().max()))
    for k, total in enumerate(geom.total.tolist()):
        assert not dh[k, :, total:].any()
    # fixed-order reduction: the same bits from run to run
    again = cuda_fold.tap_conv_dw_cuda(h_t, geom.periods, geom.cycles, ct_t, kh, kw, p_max=L - 1)
    assert torch.equal(dw, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 8), (48, 40), (64, 24)])
@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7)])
def test_dw_tensor_core_route_matches_plain(cuda, kh, kw, cin, cout):
    """Channel counts that leave part of a warp's 32 x 32 tile outside dW, at
    B=16, with the same bits from run to run."""

    B, L, periods = 16, 28, [4, 27]
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=cuda), L, L - 1)
    rng = np.random.default_rng(6)
    h, ct = (torch.from_numpy(rng.standard_normal((2, B, geom.Lp, c)).astype(np.float32))
             .to(cuda).bfloat16() for c in (cin, cout))
    before = cuda_fold.launches_dw_mma[f"{kh}x{kw}"]
    dw = cuda_fold.tap_conv_dw_cuda(h, geom.periods, geom.cycles, ct, kh, kw, p_max=L - 1)
    again = cuda_fold.tap_conv_dw_cuda(h, geom.periods, geom.cycles, ct, kh, kw, p_max=L - 1)
    torch.cuda.synchronize()
    assert cuda_fold.launches_dw_mma[f"{kh}x{kw}"] == before + 2
    want = fold.tap_weight_grad(h, geom, ct, kh, kw)
    torch.testing.assert_close(dw, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert torch.equal(dw, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 256, 55, 32, 32, 3, 3, 27), (2, 256, 55, 32, 32, 5, 5, 27),
    (2, 256, 55, 32, 32, 7, 7, 27), (2, 256, 55, 32, 32, 7, 7, 54), (2, 16, 55, 48, 40, 1, 3, 27),
    (3, 7, 35, 128, 64, 5, 3, 17), (2, 4, 55, 24, 32, 3, 3, 27), (2, 4, 55, 32, 12, 3, 3, 27),
    (2, 4, 55, 32, 32, 1, 17, 27), (2, 4, 55, 32, 32, 3, 3, 56), (2, 4, 900, 128, 128, 7, 7, 899),
])
def test_dw_mma_plan_mirrors_the_kernel(cuda, shape):
    """ops/cuda_fold.py::dw_mma_plan gives the plan csrc/tap_conv_bwd.cu
    makes, and refuses what it refuses."""

    got = cuda_fold.dw_mma_plan_of_kernel(*shape)
    if got is None:
        with pytest.raises(RuntimeError, match="cudaError_t 1 "):
            cuda_fold.dw_mma_plan(*shape)
    else:
        assert cuda_fold.dw_mma_plan(*shape) == got


@pytest.mark.cuda
def test_dw_tensor_core_route_refuses_and_never_falls_back(cuda):
    """A bf16 shape the tensor-core kernel cannot take raises; neither the
    CUDA-core kernel nor the plain version stands in for it."""

    geom = fold.make_geometry(torch.tensor([4], dtype=torch.int32, device=cuda), 8, 7)
    h = torch.zeros((1, 2, geom.Lp, 24), device=cuda, dtype=torch.bfloat16)  # Cin % 16 != 0
    ct = torch.zeros((1, 2, geom.Lp, 32), device=cuda, dtype=torch.bfloat16)
    before = (sum(cuda_fold.launches_dw.values()), sum(cuda_fold.launches_dw_mma.values()))
    with pytest.raises(RuntimeError, match="cudaError_t 1 .*Cin must be a multiple of 16"):
        cuda_fold.tap_conv_dw_cuda(h, geom.periods, geom.cycles, ct, 3, 3)
    # the same shape in float32 takes the CUDA-core route
    dw = cuda_fold.tap_conv_dw_cuda(h.float(), geom.periods, geom.cycles, ct.float(), 3, 3)
    torch.cuda.synchronize()
    assert dw.shape == (3, 3, 24, 32)
    assert (sum(cuda_fold.launches_dw.values()),
            sum(cuda_fold.launches_dw_mma.values())) == (before[0] + 1, before[1])


@pytest.mark.cuda
def test_tap_conv_autograd_on_the_card_matches_the_cpu(cuda):
    B, L, C, kh, kw, periods = 8, 28, 32, 5, 5, [7, 27]
    geoms = {d: fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=d), L, L - 1)
             for d in ("cpu", cuda)}
    h, kernel, bias = _inputs(4, len(periods), B, L, geoms["cpu"].Lp, C, kh, kw)
    ct = np.random.default_rng(5).standard_normal((len(periods), B, geoms["cpu"].Lp, C))
    grads = {}
    for d, geom in geoms.items():
        args = [torch.from_numpy(a).to(d).requires_grad_() for a in (h, kernel, bias)]
        out = cuda_fold.tap_conv(args[0], geom, args[1], args[2], kh, kw)
        out.backward(torch.from_numpy(ct.astype(np.float32)).to(d))
        grads[d] = [a.grad.cpu() for a in args]
    for got, want in zip(grads[cuda], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
def test_backward_kernels_reject_what_they_cannot_take(cuda):
    geom = fold.make_geometry(torch.tensor([4], dtype=torch.int32, device=cuda), 8, 7)
    ct = torch.zeros((1, 2, geom.Lp, 4), device=cuda)
    w = torch.zeros(3, 3, 4, 4, device=cuda)
    with pytest.raises(TypeError):
        cuda_fold.tap_conv_dh_cuda(ct.half(), geom.periods, geom.cycles, w, 3, 3)
    with pytest.raises(ValueError, match="kernel"):
        cuda_fold.tap_conv_dh_cuda(ct, geom.periods, geom.cycles, w[..., :3], 3, 3)
    with pytest.raises(ValueError, match="ct must be"):
        cuda_fold.tap_conv_dw_cuda(ct, geom.periods, geom.cycles, ct.bfloat16(), 3, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fold.tap_conv_dw_cuda(ct.cpu(), geom.periods, geom.cycles, ct, 3, 3)
    # 48 output channels do not divide the dW kernel's 256 threads: the
    # kernel itself refuses with cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="cudaError_t 1 "):
        cuda_fold.tap_conv_dw_cuda(ct, geom.periods, geom.cycles,
                                   torch.zeros((1, 2, geom.Lp, 48), device=cuda), 3, 3)
