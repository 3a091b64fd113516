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
    key = f"{kh}x{kw}"
    before = (cuda_fold.launches[key], cuda_fold.launches_mma[key])
    got = cuda_fold.tap_conv(h_t, geom, k_t, b_t, kh, kw)
    torch.cuda.synchronize()
    # bf16 takes the tensor-core route, float32 the CUDA-core one
    mma = int(dtype == torch.bfloat16)
    assert (cuda_fold.launches[key], cuda_fold.launches_mma[key]) == (before[0] + 1,
                                                                      before[1] + mma)
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
    # the geometry sizes the kernels' zero rows: it must be that of the input
    with pytest.raises(ValueError, match="rows"):
        cuda_fold.tap_conv_cuda(h[:, :, 1:].contiguous(), geom,
                                torch.zeros(3, 3, 4, 4, device=cuda), torch.zeros(4, device=cuda),
                                3, 3)
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
    counters = (cuda_fold.launches_dh, cuda_fold.launches_dh_mma, cuda_fold.launches_dw,
                cuda_fold.launches_dw_mma)
    before = [c[key] for c in counters]
    dh = cuda_fold.tap_conv_dh_cuda(ct_t, geom, k_t, kh, kw)
    dw = cuda_fold.tap_conv_dw_cuda(h_t, geom, ct_t, kh, kw)
    torch.cuda.synchronize()
    # bf16 takes the tensor-core routes, float32 the CUDA-core ones
    mma = int(dtype == torch.bfloat16)
    assert [c[key] for c in counters] == [before[0] + 1, before[1] + mma, before[2] + 1,
                                          before[3] + mma]
    want_dh = fold.tap_conv_dh(ct_t, geom, k_t, kh, kw)
    want_dw = fold.tap_weight_grad(h_t, geom, ct_t, kh, kw)
    assert dh.dtype == dw.dtype == torch.float32
    # exact float32 products, summed in another order; dW sums K*B*Lp of them
    torch.testing.assert_close(dh, want_dh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4, atol=1e-4 * float(want_dw.abs().max()))
    for k, total in enumerate(geom.total.tolist()):
        assert not dh[k, :, total:].any()
    # fixed-order reduction: the same bits from run to run
    again = cuda_fold.tap_conv_dw_cuda(h_t, geom, ct_t, kh, kw)
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
    dw = cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
    again = cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
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
        cuda_fold.tap_conv_dw_cuda(h, geom, ct, 3, 3)
    # the same shape in float32 takes the CUDA-core route
    dw = cuda_fold.tap_conv_dw_cuda(h.float(), geom, ct.float(), 3, 3)
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
        cuda_fold.tap_conv_dh_cuda(ct.half(), geom, w, 3, 3)
    with pytest.raises(ValueError, match="kernel"):
        cuda_fold.tap_conv_dh_cuda(ct, geom, w[..., :3], 3, 3)
    with pytest.raises(ValueError, match="ct must be"):
        cuda_fold.tap_conv_dw_cuda(ct, geom, ct.bfloat16(), 3, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fold.tap_conv_dw_cuda(ct.cpu(), geom, ct, 3, 3)
    # float32 dh: W's 8-channel tile of 256 x 256 at 7x7 and one staged item
    # pass 227 KB; the plan refuses before any launch, and nothing stands in
    before = (sum(cuda_fold.launches_dh.values()), sum(cuda_fold.launches_dh_mma.values()))
    wide = fold.make_geometry(torch.tensor([7, 27], dtype=torch.int32, device=cuda), 28, 27)
    with pytest.raises(RuntimeError, match="cudaError_t 1 .*more than 232448 bytes"):
        cuda_fold.tap_conv_dh_cuda(torch.zeros((2, 2, wide.Lp, 256), device=cuda), wide,
                                   torch.zeros(7, 7, 256, 256, device=cuda), 7, 7)
    assert (sum(cuda_fold.launches_dh.values()),
            sum(cuda_fold.launches_dh_mma.values())) == before
    # float32 dW takes any channels now: 48 output channels (which the first
    # design's 256 threads refused), in a partial 32 x 32 tile
    h = torch.randn((1, 2, geom.Lp, 4), device=cuda)
    ct48 = torch.randn((1, 2, geom.Lp, 48), device=cuda)
    dw = cuda_fold.tap_conv_dw_cuda(h, geom, ct48, 3, 3)
    torch.testing.assert_close(dw, fold.tap_weight_grad(h, geom, ct48, 3, 3), rtol=1e-4,
                               atol=1e-4)


def _f32_routes(cuda, B, L, periods, cin, cout, kh, kw, seed):
    """The float32 dh and dW kernels at these shapes against the plain
    versions, each launched twice: the same bits both times, one CUDA-core
    launch each and none on a tensor-core route, dh 0 at and past each fold
    extent."""

    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=cuda), L, L - 1)
    rng = np.random.default_rng(seed)
    h, ct = (torch.from_numpy(rng.standard_normal((len(periods), B, geom.Lp, c))
                              .astype(np.float32)).to(cuda) for c in (cin, cout))
    w = torch.from_numpy((rng.standard_normal((kh, kw, cin, cout)) * 0.3).astype(np.float32)).to(cuda)
    key = f"{kh}x{kw}"
    counters = (cuda_fold.launches_dh, cuda_fold.launches_dh_mma, cuda_fold.launches_dw,
                cuda_fold.launches_dw_mma)
    before = [c[key] for c in counters]
    dh = [cuda_fold.tap_conv_dh_cuda(ct, geom, w, kh, kw) for _ in range(2)]
    dw = [cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert [c[key] for c in counters] == [before[0] + 2, before[1], before[2] + 2, before[3]]
    want_dh = fold.tap_conv_dh(ct, geom, w, kh, kw)
    want_dw = fold.tap_weight_grad(h, geom, ct, kh, kw)
    torch.testing.assert_close(dh[0], want_dh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw[0], want_dw, rtol=1e-4, atol=1e-4 * float(want_dw.abs().max()))
    for k, total in enumerate(geom.total.tolist()):
        assert not dh[0][k, :, total:].any()
    assert torch.equal(dh[0], dh[1]) and torch.equal(dw[0], dw[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 16), (48, 48), (64, 64), (48, 32), (32, 64), (64, 24),
                                      (18, 30)])
@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7)])
def test_f32_backward_routes_match_plain(cuda, kh, kw, cin, cout):
    """Channels 16-64, Cin != Cout both ways, Cin = 64 at 7x7 (which the first
    float32 dW refused), widths that take 4-byte copies, at B=16."""

    _f32_routes(cuda, 16, 28, [7, 27], cin, cout, kh, kw, seed=cin + cout + kh)


@pytest.mark.cuda
@pytest.mark.parametrize("kh", [3, 5])
def test_f32_backward_routes_take_the_long_context_shape(cuda, kh):
    """configs/long_context.yaml's fold: L=512 (Lp=1023, p_cap 511), K=4,
    mid 32, 3x3 and 5x5: dh staged as kh bands of 64-row items."""

    assert cuda_fold.dh_f32_plan(4, 4, 1023, 32, 32, kh, kh, 511).band == 1
    _f32_routes(cuda, 4, 512, [511, 168, 24, 7], 32, 32, kh, kh, seed=kh)


@pytest.mark.cuda
def test_f32_dh_takes_short_items(cuda):
    """Mid 61 at 7x7, L=245: 32-row items, 8-channel tiles, bands."""

    plan = cuda_fold.dh_f32_plan(2, 2, 489, 61, 61, 7, 7, 244)
    assert (plan.nt, plan.rt, plan.band) == (8, 32, 1)
    _f32_routes(cuda, 2, 245, [244, 30], 61, 61, 7, 7, seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 256, 55, 32, 32, 3, 3, 27), (2, 256, 55, 32, 32, 5, 5, 27), (2, 256, 55, 32, 32, 7, 7, 27),
    (2, 256, 55, 64, 64, 7, 7, 27), (2, 16, 55, 48, 32, 3, 3, 27), (4, 64, 1023, 32, 32, 5, 5, 511),
    (2, 16, 489, 61, 61, 7, 7, 244), (3, 7, 35, 18, 30, 5, 3, 17), (2, 4, 55, 256, 256, 7, 7, 27),
    (2, 4, 55, 32, 32, 3, 3, 56), (2, 4, 55, 8, 8, 1, 35, 27),
])
def test_f32_plans_mirror_the_kernel(cuda, shape):
    """ops/cuda_fold.py::dh_f32_plan and dw_f32_plan give the plans
    csrc/tap_conv_bwd.cu makes, and refuse what it refuses."""

    got = cuda_fold.dh_f32_plan_of_kernel(*shape)
    if got is None:
        with pytest.raises(RuntimeError, match="cudaError_t 1 "):
            cuda_fold.dh_f32_plan(*shape)
    else:
        assert cuda_fold.dh_f32_plan(*shape) == got
    assert cuda_fold.dw_f32_plan(*shape[:7]) == cuda_fold.dw_f32_plan_of_kernel(*shape[:7])


def _mma_route(cuda, sign, B, L, periods, cin, cout, kh, kw, seed):
    """The bf16 tensor-core forward (sign +1) or dh (sign -1) at these
    shapes against the plain version, launched twice: the same bits both
    times, one tensor-core launch each, dh 0 at and past each fold extent."""

    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=cuda), L, L - 1)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((len(periods), B, geom.Lp, cin if sign > 0 else cout))
                         .astype(np.float32)).to(cuda).bfloat16()
    w = torch.from_numpy((rng.standard_normal((kh, kw, cin, cout)) * 0.3).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)).to(cuda)
    key = f"{kh}x{kw}"
    counter = cuda_fold.launches_mma if sign > 0 else cuda_fold.launches_dh_mma
    before = counter[key]
    if sign > 0:
        runs = [cuda_fold.tap_conv_cuda(x, geom, w, bias, kh, kw) for _ in range(2)]
        want = fold.tap_conv(x, geom, w, bias, kh, kw)
    else:
        runs = [cuda_fold.tap_conv_dh_cuda(x, geom, w, kh, kw) for _ in range(2)]
        want = fold.tap_conv_dh(x, geom, w, kh, kw)
        for k, total in enumerate(geom.total.tolist()):
            assert not runs[0][k, :, total:].any()
    torch.cuda.synchronize()
    assert counter[key] == before + 2
    torch.testing.assert_close(runs[0], want, rtol=1e-4, atol=1e-4)
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 32, 48, 64])
@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7)])
@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_tensor_core_routes_match_plain(cuda, sign, kh, kw, c):
    _mma_route(cuda, sign, 16, 28, [7, 27], c, c, kh, kw, seed=c + kh)


@pytest.mark.cuda
@pytest.mark.parametrize("c,kh", [(128, 3), (96, 5), (80, 7)])
@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_tensor_core_routes_take_the_channel_edges(cuda, sign, c, kh):
    """The widest mid the CUDA-core kernels took at Lp=55, at B=16."""

    _mma_route(cuda, sign, 16, 28, [4, 27], c, c, kh, kh, seed=c)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_tensor_core_routes_stage_bands_for_long_sequences(cuda, sign):
    """L=100 (Lp=199, p_cap 99), Cin != Cout: 64-row items staged as bands."""

    assert cuda_fold.fold_mma_plan(sign, 2, 4, 199, 32, 48, 5, 5, 99).band == 1
    _mma_route(cuda, sign, 4, 100, [99, 13], 32, 48, 5, 5, seed=9)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 2, 192, 55, 32, 32, 3, 3, 27), (1, 2, 192, 55, 32, 32, 5, 5, 27),
    (1, 2, 192, 55, 32, 32, 7, 7, 27), (-1, 2, 256, 55, 32, 32, 3, 3, 27),
    (-1, 2, 256, 55, 32, 32, 5, 5, 27), (-1, 2, 256, 55, 32, 32, 7, 7, 27),
    (1, 2, 16, 55, 128, 128, 3, 3, 27), (-1, 2, 16, 55, 96, 96, 5, 5, 27),
    (1, 2, 16, 55, 80, 80, 7, 7, 27), (-1, 2, 16, 55, 80, 80, 7, 7, 27),
    (1, 4, 64, 1023, 32, 32, 5, 5, 511), (-1, 3, 7, 35, 64, 16, 5, 3, 17),
    (1, 2, 4, 55, 24, 32, 3, 3, 27), (-1, 2, 4, 55, 32, 40, 3, 3, 27),
    (1, 2, 4, 55, 32, 32, 3, 3, 56), (1, 2, 4, 55, 256, 256, 7, 7, 27),
])
def test_fold_mma_plan_mirrors_the_kernel(cuda, shape):
    """ops/cuda_fold.py::fold_mma_plan gives the plan csrc/tap_conv_mma.cu
    makes, and refuses what it refuses."""

    got = cuda_fold.fold_mma_plan_of_kernel(*shape)
    if got is None:
        with pytest.raises(RuntimeError, match="cudaError_t 1 "):
            cuda_fold.fold_mma_plan(*shape)
    else:
        assert cuda_fold.fold_mma_plan(*shape) == got


@pytest.mark.cuda
def test_tensor_core_routes_refuse_and_never_fall_back(cuda):
    """A bf16 shape the template cannot take (Cin = 24) raises for the
    forward and dh; the same shape in float32 takes the CUDA-core routes,
    and the tensor-core counters stay where they were."""

    geom = fold.make_geometry(torch.tensor([4], dtype=torch.int32, device=cuda), 8, 7)
    h = torch.zeros((1, 2, geom.Lp, 24), device=cuda, dtype=torch.bfloat16)
    ct = torch.zeros((1, 2, geom.Lp, 32), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 24, 32), device=cuda)
    b = torch.zeros(32, device=cuda)
    counters = (cuda_fold.launches, cuda_fold.launches_mma, cuda_fold.launches_dh,
                cuda_fold.launches_dh_mma)
    before = [sum(c.values()) for c in counters]
    with pytest.raises(RuntimeError, match="cudaError_t 1 .*Cin and Cout must be multiples of 16"):
        cuda_fold.tap_conv_cuda(h, geom, w, b, 3, 3)
    with pytest.raises(RuntimeError, match="cudaError_t 1 .*Cin and Cout must be multiples of 16"):
        cuda_fold.tap_conv_dh_cuda(ct, geom, w, 3, 3)
    assert [sum(c.values()) for c in counters] == before
    out = cuda_fold.tap_conv_cuda(h.float(), geom, w, b, 3, 3)
    dh = cuda_fold.tap_conv_dh_cuda(ct.float(), geom, w, 3, 3)
    torch.cuda.synchronize()
    assert out.shape == (1, 2, geom.Lp, 32) and dh.shape == (1, 2, geom.Lp, 24)
    assert [sum(c.values()) for c in counters] == [before[0] + 1, before[1], before[2] + 1,
                                                   before[3]]


@pytest.mark.cuda
def test_tensor_core_routes_take_unaligned_views(cuda):
    """An input whose data does not start on 16 bytes (a view into a larger
    buffer) is copied by the wrapper, not refused (cp.async reads 16 bytes)."""

    geom = fold.make_geometry(torch.tensor([7, 27], dtype=torch.int32, device=cuda), 28, 27)
    n = 2 * 4 * geom.Lp * 32
    flat = torch.randn(n + 4, device=cuda).bfloat16()
    x = flat[4:].view(2, 4, geom.Lp, 32)  # 8 bytes past an aligned start
    assert x.data_ptr() % 16 == 8
    w = torch.randn(3, 3, 32, 32, device=cuda) * 0.3
    b = torch.zeros(32, device=cuda)
    got = cuda_fold.tap_conv_cuda(x, geom, w, b, 3, 3)
    torch.testing.assert_close(got, fold.tap_conv(x, geom, w, b, 3, 3), rtol=1e-4, atol=1e-4)
    got = cuda_fold.tap_conv_dh_cuda(x, geom, w, 3, 3)
    torch.testing.assert_close(got, fold.tap_conv_dh(x, geom, w, 3, 3), rtol=1e-4, atol=1e-4)
