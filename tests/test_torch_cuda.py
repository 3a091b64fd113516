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
    # beyond the kernel's capacity (W's slice of one kernel row of 4,001 taps
    # at 4 channels passes 227 KB; the 4,096 output channels the first float32
    # kernel refused now take 128 tiles): its plan refuses with
    # cudaErrorInvalidValue before any launch, and nothing stands in
    before = sum(cuda_fold.launches.values())
    with pytest.raises(RuntimeError, match="cudaError_t 1 .*more than 232448 bytes"):
        cuda_fold.tap_conv(h, geom, torch.zeros(1, 4001, 4, 4, device=cuda),
                           torch.zeros(4, device=cuda), 1, 4001)
    assert sum(cuda_fold.launches.values()) == before


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
    (4, 64, 1023, 32, 32, 3, 3, 511), (4, 64, 1023, 32, 32, 5, 5, 511),
    (1, 64, 525, 32, 32, 3, 3, 25), (1, 64, 525, 32, 32, 5, 5, 25),
    (1, 64, 513, 32, 32, 3, 3, 171), (1, 64, 513, 32, 32, 5, 5, 171),
    (1, 2, 1023, 256, 256, 7, 7, 511), (1, 2, 1023, 512, 512, 3, 3, 511),
    (2, 4, 900, 1024, 1024, 7, 7, 899),
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
@pytest.mark.parametrize("K,B,p_max,periods", [
    (4, 64, 511, [511, 168, 24, 7]), (1, 64, 25, [25]), (1, 64, 171, [171])],
    ids=["dynamic", "p25", "p171"])
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_dw_tensor_core_route_takes_the_long_context_shapes(cuda, kh, kw, K, B, p_max, periods):
    """The long-context recipe's bf16 dW (L=512: the dynamic fold, Lp=1023,
    and the exact extents of p=25 and p=171, Lp=525 and 513) takes band 1,
    tap_conv_dw_wgmma_kernel: one persistent block an SM in clusters of 2,
    every tap in each block, 128-row items at Lp 1023 and 64-row ones at the
    exact extents, the plan equal to the kernel's own; against the plain
    version within rtol 1e-4 and 1e-4 of the largest value, with the same
    bits twice, and one run of the kernel on the card a call."""

    L = 512
    geom = _long_geometry(cuda, K, p_max, periods, L)
    plan = cuda_fold.dw_mma_plan(K, B, geom.Lp, 32, 32, kh, kw, geom.p_max)
    assert cuda_fold.dw_mma_plan_of_kernel(K, B, geom.Lp, 32, 32, kh, kw, geom.p_max) == plan
    assert (plan.band, plan.rt, plan.groups, plan.kr) == (1, 128 if K == 4 else 64, 1, kh)
    assert (plan.consumers, plan.cluster, plan.blocks, plan.chunks) == (3, 2, 132, 66)
    g = torch.Generator(device=cuda).manual_seed(kh + K)
    h, ct = (torch.randn((K, B, geom.Lp, 32), generator=g, device=cuda).bfloat16()
             for _ in range(2))
    before = cuda_fold.launches_dw_mma[f"{kh}x{kw}"]
    cuda_fold.clear_kernel_runs(cuda)
    dw = cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
    again = cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
    torch.cuda.synchronize()
    assert cuda_fold.launches_dw_mma[f"{kh}x{kw}"] == before + 2
    assert cuda_fold.kernel_runs(cuda)["dw_mma"] == {f"{kh}x{kw}": 2}
    want = fold.tap_weight_grad(h, geom, ct, kh, kw)
    torch.testing.assert_close(dw, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert torch.equal(dw, again)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,kh,kw,L,periods,rt,mt,groups", [
    (16, 16, 3, 3, 512, [511, 24], 16, 1, 1),  # half channel tiles (16 channels)
    (16, 16, 7, 7, 120, [119, 7], 16, 3, 2),
    (48, 40, 5, 5, 240, [239, 12], 16, 5, 1),  # 2 x 2 channel tiles, half and partial
    (144, 136, 3, 3, 200, [199, 5], 128, 2, 1),  # 5 x 5 channel tiles
    (32, 32, 7, 7, 120, [119, 7], 16, 5, 2),  # kernel rows in groups of 4 and 3
    (48, 40, 7, 7, 120, [119, 6], 32, 5, 2),
    (32, 32, 1, 3, 512, [511, 24], 16, 1, 1),
    (32, 32, 3, 1, 512, [511, 24], 16, 1, 1),
    (32, 32, 3, 7, 200, [199, 9], 16, 4, 1),
])
def test_dw_band_kernel_takes_every_plan_shape(cuda, cin, cout, kh, kw, L, periods, rt, mt,
                                               groups):
    """Band 1 at the shapes its plan takes beyond the long recipe's: each
    count of M tiles a consumer warpgroup holds (1 to 5), kernel rows split
    into groups, several channel tiles on the grid's y, 16-channel slabs
    alone in a tile, output channels past Cout skipped, 1 x kw and kh x 1
    kernels, 16- to 128-row items. Against the plain version within rtol
    1e-4 and 1e-4 of the largest value, with the same bits twice."""

    B = 4
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=cuda), L,
                              max(periods))
    shape = (len(periods), B, geom.Lp, cin, cout, kh, kw, geom.p_max)
    plan = cuda_fold.dw_mma_plan(*shape)
    assert cuda_fold.dw_mma_plan_of_kernel(*shape) == plan
    assert isinstance(plan, cuda_fold.DwBandPlan)
    assert (plan.rt, -(-plan.mtiles // plan.consumers), plan.groups) == (rt, mt, groups)
    rng = np.random.default_rng(kh * 16 + kw + cin)
    h, ct = (torch.from_numpy(rng.standard_normal((len(periods), B, geom.Lp, c))
                              .astype(np.float32)).to(cuda).bfloat16() for c in (cin, cout))
    cuda_fold.clear_kernel_runs(cuda)
    dw = cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
    again = cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
    torch.cuda.synchronize()
    assert cuda_fold.kernel_runs(cuda)["dw_mma"] == {f"{kh}x{kw}": 2}
    want = fold.tap_weight_grad(h, geom, ct, kh, kw)
    torch.testing.assert_close(dw, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert torch.equal(dw, again)


def _long_geometry(cuda, K, p_max, periods, L=512):
    if K == 1:
        return fold.make_dense_geometry(periods[0], L, cuda)
    return fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=cuda), L, p_max)


@pytest.mark.cuda
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_dw_band_kernel_reads_the_buffers_of_each_call(cuda, kh, kw):
    """Two calls in a row on different buffers (and a third on the first
    again) each equal the plain version on their own inputs: the tensor maps
    are encoded at every launch, none is kept from an earlier call."""

    geom = _long_geometry(cuda, 4, 511, [511, 168, 24, 7])
    g = torch.Generator(device=cuda).manual_seed(kh)
    pairs = [tuple(torch.randn((4, 64, geom.Lp, 32), generator=g, device=cuda).bfloat16()
                   for _ in range(2)) for _ in range(2)]
    outs = [cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw) for h, ct in pairs + pairs[:1]]
    torch.cuda.synchronize()
    for out, (h, ct) in zip(outs, pairs + pairs[:1]):
        want = fold.tap_weight_grad(h, geom, ct, kh, kw)
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert not torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_dw_band_kernel_replays_from_a_cuda_graph(cuda, kh, kw):
    """A call captured in a CUDA graph and replayed equals the eager call bit
    for bit, then, after new values are copied into the captured buffers,
    the eager call on those values; the kernel counts each replay's run."""

    geom = _long_geometry(cuda, 4, 511, [511, 168, 24, 7])
    g = torch.Generator(device=cuda).manual_seed(10 + kh)
    h, ct, h2, ct2 = (torch.randn((4, 64, geom.Lp, 32), generator=g, device=cuda).bfloat16()
                      for _ in range(4))
    eager = [cuda_fold.tap_conv_dw_cuda(x, geom, y, kh, kw) for x, y in ((h, ct), (h2, ct2))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_fold.tap_conv_dw_cuda(h, geom, ct, kh, kw)
    cuda_fold.clear_kernel_runs(cuda)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[0])
    h.copy_(h2)
    ct.copy_(ct2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager[1])
    assert cuda_fold.kernel_runs(cuda)["dw_mma"] == {f"{kh}x{kw}": 2}


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


def _f32_forward(cuda, B, L, periods, cin, cout, kh, kw, seed, p_cap=None):
    """The float32 forward kernel at these shapes against the plain version,
    launched twice: the same bits both times, one CUDA-core launch each and
    none on the tensor-core route, every row of Lp compared."""

    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32, device=cuda), L,
                              p_cap or L - 1)
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((len(periods), B, geom.Lp, cin))
                         .astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((kh, kw, cin, cout)) * 0.3).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)).to(cuda)
    key = f"{kh}x{kw}"
    before = (cuda_fold.launches[key], cuda_fold.launches_mma[key])
    runs = [cuda_fold.tap_conv_cuda(h, geom, w, bias, kh, kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert (cuda_fold.launches[key], cuda_fold.launches_mma[key]) == (before[0] + 2, before[1])
    want = fold.tap_conv(h, geom, w, bias, kh, kw)
    assert runs[0].shape == want.shape == (len(periods), B, geom.Lp, cout)
    torch.testing.assert_close(runs[0], want, rtol=1e-4, atol=1e-4)
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 16), (48, 48), (64, 64), (48, 32), (32, 64), (64, 24),
                                      (18, 30), (5, 3), (33, 1)])
@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7)])
def test_f32_forward_route_matches_plain(cuda, kh, kw, cin, cout):
    """Channels 1-64, Cin != Cout both ways, widths that take 4-byte copies,
    Cout below the narrowest tile, at B=16."""

    _f32_forward(cuda, 16, 28, [7, 27], cin, cout, kh, kw, seed=cin + cout + kh)


@pytest.mark.cuda
@pytest.mark.parametrize("kh", [3, 5])
def test_f32_forward_route_takes_the_long_context_shape(cuda, kh):
    """configs/long_context.yaml's fold: L=512 (Lp=1023, p_cap 511), K=4,
    mid 32: 64-row items staged as kh bands."""

    assert cuda_fold.fwd_f32_plan(4, 4, 1023, 32, 32, kh, kh, 511).band == 1
    _f32_forward(cuda, 4, 512, [511, 168, 24, 7], 32, 32, kh, kh, seed=kh)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,p_cap,periods,cin,cout,kh,kw", [
    (1, 10, 10, [10], 2000, 1, 3, 3),  # Cin in 4 slices of 500
    (2, 50, 50, [50, 7], 1, 3, 61, 61),  # 61 kernel rows in 3 slices of 21
])
def test_f32_forward_route_takes_passes(cuda, B, L, p_cap, periods, cin, cout, kh, kw):
    """Shapes the first float32 forward took that one pass cannot: the
    block makes one pass over its items for each slice of input channels
    or kernel rows, each adding to what it wrote in the pass before."""

    assert cuda_fold.fwd_f32_plan(len(periods), B, L + p_cap, cin, cout, kh, kw, p_cap).passes > 1
    _f32_forward(cuda, B, L, periods, cin, cout, kh, kw, seed=cin, p_cap=p_cap)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 192, 55, 32, 32, 3, 3, 27), (2, 192, 55, 32, 32, 5, 5, 27), (2, 192, 55, 32, 32, 7, 7, 27),
    (2, 256, 55, 32, 32, 7, 7, 27), (2, 16, 55, 48, 32, 3, 3, 27), (4, 64, 1023, 32, 32, 5, 5, 511),
    (2, 16, 489, 61, 61, 7, 7, 244), (3, 7, 35, 18, 30, 5, 3, 17), (2, 4, 55, 33, 1, 7, 7, 27),
    (1, 1, 20, 2000, 1, 3, 3, 10), (1, 2, 100, 1, 3, 61, 61, 50), (1, 2, 15, 4, 4096, 3, 3, 7),
    (2, 4, 55, 32, 32, 3, 3, 56), (1, 2, 15, 4, 4, 1, 4001, 7),
])
def test_fwd_f32_plan_mirrors_the_kernel(cuda, shape):
    """ops/cuda_fold.py::fwd_f32_plan gives the plan csrc/tap_conv_fwd.cu
    makes, and refuses what it refuses."""

    got = cuda_fold.fwd_f32_plan_of_kernel(*shape)
    if got is None:
        with pytest.raises(RuntimeError, match="cudaError_t 1 "):
            cuda_fold.fwd_f32_plan(*shape)
    else:
        assert cuda_fold.fwd_f32_plan(*shape) == got


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
def test_f32_forward_takes_unaligned_views(cuda):
    """A float32 input whose data does not start on 16 bytes is copied by the
    wrapper, not refused (cp.async reads 16 bytes), as on the bf16 route."""

    geom = fold.make_geometry(torch.tensor([7, 27], dtype=torch.int32, device=cuda), 28, 27)
    flat = torch.randn(2 * 4 * geom.Lp * 32 + 2, device=cuda)
    x = flat[2:].view(2, 4, geom.Lp, 32)  # 8 bytes past an aligned start
    assert x.data_ptr() % 16 == 8
    w = torch.randn(3, 3, 32, 32, device=cuda) * 0.3
    b = torch.randn(32, device=cuda)
    got = cuda_fold.tap_conv_cuda(x, geom, w, b, 3, 3)
    torch.testing.assert_close(got, fold.tap_conv(x, geom, w, b, 3, 3), rtol=1e-4, atol=1e-4)


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


# --- the frozen-period path: the same kernels at the exact extent (K=1, Lp=total) ---

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5), (7, 7)])
@pytest.mark.parametrize("p", [7, 14, 27])
def test_kernels_at_the_exact_extent_match_plain_and_conv2d(cuda, p, kh, kw, dtype):
    """Forward, dh and dW over ``make_dense_geometry``'s grid: against the plain
    versions (1e-4; dW 1e-4 of its largest value), the same bits twice, the
    C plans equal to their mirrors, and in float32 against conv2d."""

    B, L, C = 24, 28, 32
    geom = fold.make_dense_geometry(p, L, cuda)
    h, kernel, bias = _inputs(p + kh, 1, B, L, geom.Lp, C, kh, kw)
    ct = np.random.default_rng(p).standard_normal(h.shape).astype(np.float32)
    h_t, ct_t = (torch.from_numpy(a).to(cuda).to(dtype) for a in (h, ct))
    k_t, b_t = torch.from_numpy(kernel).to(cuda), torch.from_numpy(bias).to(cuda)
    shape = (1, B, geom.Lp, C, C, kh, kw)
    if dtype == torch.bfloat16:
        for sign in (1, -1):
            assert cuda_fold.fold_mma_plan_of_kernel(sign, *shape, p) == \
                cuda_fold.fold_mma_plan(sign, *shape, p)
        assert cuda_fold.dw_mma_plan_of_kernel(*shape, p) == cuda_fold.dw_mma_plan(*shape, p)
    else:
        assert cuda_fold.fwd_f32_plan_of_kernel(*shape, p) == cuda_fold.fwd_f32_plan(*shape, p)
        assert cuda_fold.dh_f32_plan_of_kernel(*shape, p) == cuda_fold.dh_f32_plan(*shape, p)
    runs = [(cuda_fold.tap_conv_cuda(h_t, geom, k_t, b_t, kh, kw),
             cuda_fold.tap_conv_dh_cuda(ct_t, geom, k_t, kh, kw),
             cuda_fold.tap_conv_dw_cuda(h_t, geom, ct_t, kh, kw)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, dh, dw = runs[0]
    torch.testing.assert_close(out, fold.tap_conv(h_t, geom, k_t, b_t, kh, kw),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dh, fold.tap_conv_dh(ct_t, geom, k_t, kh, kw),
                               rtol=1e-4, atol=1e-4)
    want_dw = fold.tap_weight_grad(h_t, geom, ct_t, kh, kw)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4, atol=1e-4 * float(want_dw.abs().max()))
    if dtype == torch.float32:
        cycles = geom.Lp // p
        grid = h_t[0].reshape(B, cycles, p, C).permute(0, 3, 1, 2)
        ref = torch.nn.functional.conv2d(grid, k_t.permute(3, 2, 0, 1), b_t,
                                         padding=(kh // 2, kw // 2))
        torch.testing.assert_close(out[0], ref.permute(0, 2, 3, 1).reshape(B, geom.Lp, C),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_dense_fold_conv_on_the_card_matches_the_cpu(cuda, dtype):
    """The dense form's autograd Function on the kernels against the plain
    versions; in bf16 the rounding of its output and dW can move a value by
    one bf16 step (2**-8 relative) where the float32 sums differ in order."""

    B, L, C, kh, kw, p = 8, 28, 32, 5, 5, 27
    h, kernel, bias = _inputs(9, 1, B, L, L + (-L) % p, C, kh, kw)
    ct = np.random.default_rng(10).standard_normal(h.shape).astype(np.float32)
    res = {}
    for d in ("cpu", cuda):
        geom = fold.make_dense_geometry(p, L, d)
        args = [torch.from_numpy(a).to(d).requires_grad_() for a in (h, kernel, bias)]
        out = cuda_fold.dense_fold_conv(args[0].to(dtype), geom, args[1], args[2], kh, kw)
        out.backward(torch.from_numpy(ct).to(d))
        res[d] = [out.detach().cpu(), *(a.grad.cpu() for a in args)]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(res[cuda], res["cpu"]):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
def test_frozen_model_on_the_card_matches_the_cpu(cuda):
    """A small float32 model on a frozen spec from its own telemetry: forward
    and gradients card against CPU, and Σ_layers 2 × 3 × U launches of each
    kernel, one per inception branch and unique period."""

    import dataclasses

    from flow_timesnet_tpu_torch import convert, engine
    from flow_timesnet_tpu_torch.models import timesnet

    cfg = timesnet.TimesNetConfig(input_len=28, pred_len=7, d_model=32, d_ff=64, n_layers=2,
                                  kernel_set=((3, 3), (5, 5), (7, 7)), bottleneck_ratio=1.0,
                                  min_period_threshold=7, dropout=0.0, id_embed_dim=0)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
              for k, v in params.items()}
    rng = np.random.default_rng(3)
    t = np.arange(28)
    x = (np.sin(2 * np.pi * t / 7)[None, :, None] + 0.5 * np.cos(2 * np.pi * t / 9.3)[None, :, None]
         + 0.3 * rng.standard_normal((16, 28, 1))).astype(np.float32)
    spec = engine.Engine.frozen_spec_from_telemetry(
        engine.Engine(cfg, params, device="cpu").collect_period_telemetry(
            None, {"x": torch.from_numpy(x)}), cfg.n_layers)
    on_card = engine.Engine(cfg, params, device=cuda).collect_period_telemetry(
        None, {"x": torch.from_numpy(x).to(cuda)})
    assert engine.Engine.frozen_spec_from_telemetry(on_card, cfg.n_layers) == spec
    fcfg = dataclasses.replace(cfg, frozen_periods=spec)
    res = {}
    for d in ("cpu", cuda):
        model = timesnet.TimesNet(fcfg).to(d)
        model.load_state_dict(params)
        for counter in (cuda_fold.launches, cuda_fold.launches_dh, cuda_fold.launches_dw):
            counter.clear()
        rate, disp = model.eval()(torch.from_numpy(x).to(d))
        ((rate ** 2).mean() + (disp ** 2).mean()).backward()
        res[d] = [rate.detach().cpu(), disp.detach().cpu(),
                  *(p.grad.cpu() for p in model.parameters())]
    unique = sum(len({p for p, _, v in layer if v}) for layer in spec)
    assert unique >= 1
    for counter in (cuda_fold.launches, cuda_fold.launches_dh, cuda_fold.launches_dw):
        assert dict(counter) == {k: 2 * unique for k in ("3x3", "5x5", "7x7")}
    scale = max(1.0, max(float(g.abs().max()) for g in res["cpu"][2:]))
    for got, want in zip(res[cuda], res["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
def test_forward_and_train_step_never_wait_for_the_card(cuda, frozen):
    """After a warm-up (which builds the cached geometries and DFT basis), a
    forward and a training step on either path make no synchronizing CUDA
    call: the host runs ahead of the card, as the static design asks."""

    import dataclasses

    from flow_timesnet_tpu_torch import convert, engine
    from flow_timesnet_tpu_torch.models import timesnet

    cfg = timesnet.TimesNetConfig(input_len=28, pred_len=7, d_model=32, d_ff=64, n_layers=2,
                                  kernel_set=((3, 3), (5, 5)), bottleneck_ratio=2.0,
                                  min_period_threshold=7, dropout=0.1, id_embed_dim=0,
                                  compute_dtype="bfloat16")
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    B = 16
    batch = {"x": torch.randn(B, 28, 1, device=cuda), "y": torch.rand(B, 7, 1, device=cuda),
             "mask": torch.ones(B, 7, 1, device=cuda), "row_valid": torch.ones(B, device=cuda)}
    if frozen:
        spec = engine.Engine.frozen_spec_from_telemetry(
            engine.Engine(cfg, params, device=cuda).collect_period_telemetry(None, batch), 2)
        cfg = dataclasses.replace(cfg, frozen_periods=spec)
    eng = engine.Engine(cfg, params, device=cuda)
    state = eng.init_state()
    gen = torch.Generator(device=cuda).manual_seed(0)
    eng.forward(batch["x"])
    eng.train_step(state, 1e-3, gen, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.forward(batch["x"])
        eng.train_step(state, 1e-3, gen, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# -- CUDA graphs: the served request, the training step and the resident epoch --

GRAPH_KERNELS = ((3, 3), (5, 5), (7, 7))  # 2 layers x 2 inception blocks x 3 sizes: 12 a pass


def _graph_setup(cuda, frozen, dropout, B=16):
    """A small bf16 model on ``cuda`` (dynamic, or frozen on its own
    telemetry's spec), its parameters and a padded window batch."""

    import dataclasses

    from flow_timesnet_tpu_torch import convert, engine
    from flow_timesnet_tpu_torch.models import timesnet

    cfg = timesnet.TimesNetConfig(input_len=28, pred_len=7, d_model=32, d_ff=64, n_layers=2,
                                  kernel_set=GRAPH_KERNELS, bottleneck_ratio=2.0,
                                  min_period_threshold=7, dropout=dropout, id_embed_dim=4,
                                  id_vocab=B, compute_dtype="bfloat16")
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
              for k, v in params.items()}
    g = torch.Generator(device=cuda).manual_seed(2)
    batch = {"x": torch.rand(B, 28, 1, device=cuda, generator=g) * 5,
             "y": torch.poisson(torch.full((B, 7, 1), 3.0, device=cuda), generator=g),
             "mask": torch.ones(B, 7, 1, device=cuda),
             "row_valid": torch.ones(B, device=cuda),
             "ids": torch.arange(B, device=cuda, dtype=torch.int32)[:, None]}
    batch["row_valid"][-1] = 0.0
    if frozen:
        spec = engine.Engine.frozen_spec_from_telemetry(
            engine.Engine(cfg, params, device=cuda).collect_period_telemetry(None, batch), 2)
        cfg = dataclasses.replace(cfg, frozen_periods=spec)
    return cfg, params, batch


def _engines(cuda, cfg, params):
    from flow_timesnet_tpu_torch import engine

    kw = dict(use_loss_masking=True, grad_clip_norm=1.0, weight_decay=1e-6, ema_decay=0.99,
              num_series=16)
    graphed, eager = (engine.Engine(cfg, params, device=cuda, **kw) for _ in range(2))
    eager.cuda_graphs = False  # op by op on the card: the yardstick
    return graphed, eager


def _fold_counts():
    return {name: dict(c) for name, c in (
        ("fwd", cuda_fold.launches), ("fwd_mma", cuda_fold.launches_mma),
        ("dh", cuda_fold.launches_dh), ("dh_mma", cuda_fold.launches_dh_mma),
        ("dw", cuda_fold.launches_dw), ("dw_mma", cuda_fold.launches_dw_mma))}


def _per_size(cfg):
    """Launches of each kernel and size in one pass: 2 layers x 2 inception
    blocks on the dynamic path (12 over the three sizes), 2 x U on the
    frozen one (U: the unique valid periods, summed over the layers)."""

    if cfg.frozen_periods is None:
        return 4
    return 2 * sum(len({p for p, _, v in layer if v}) for layer in cfg.frozen_periods)


def _card_runs(run, n=1):
    """The fold-conv kernels the card ran over ``n`` calls of ``run``, as
    the kernels counted themselves (``cuda_fold.kernel_runs``; a replay runs
    no wrapper, so only these counts see it): the bf16 routes by kind and
    size, and ``other``, the runs of the float32 routes."""

    cuda_fold.clear_kernel_runs()
    for _ in range(n):
        run()
    runs = cuda_fold.kernel_runs()
    out = {kind: runs[f"{kind}_mma"] for kind in ("fwd", "dh", "dw")}
    out["other"] = sum(sum(runs[f"{kind}_f32"].values()) for kind in ("fwd", "dh", "dw"))
    return out


def _each_size(n):
    return {f"{kh}x{kw}": n for kh, kw in GRAPH_KERNELS}


def _clear_fold_counts():
    for c in (cuda_fold.launches, cuda_fold.launches_mma, cuda_fold.launches_dh,
              cuda_fold.launches_dh_mma, cuda_fold.launches_dw, cuda_fold.launches_dw_mma):
        c.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
def test_replayed_request_equals_eager_bitwise(cuda, frozen):
    """The served forward replayed from its graph gives the eager forward's
    bits (the same kernels on the same inputs), for two requests on new
    inputs. The wrappers count the warm-up's and the capture's launches and
    nothing at a replay; the kernels' own counts show the card running the
    fold-conv forward once per branch and replay (12 on the dynamic path),
    on the tensor-core route."""

    from flow_timesnet_tpu_torch import graphs

    cfg, params, batch = _graph_setup(cuda, frozen, 0.0)
    graphed, eager = _engines(cuda, cfg, params)
    per = _per_size(cfg)
    for seed, counted in ((0, graphs.WARMUP_CALLS + 1), (1, 0)):  # capture, then a replay
        x = torch.rand(batch["x"].shape, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(seed)) * 5
        want = eager.forward(x, ids=batch["ids"])
        _clear_fold_counts()
        got = graphed.forward(x, ids=batch["ids"])
        counts = _fold_counts()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert counts["fwd"] == counts["fwd_mma"] == (
            {f"{kh}x{kw}": counted * per for kh, kw in GRAPH_KERNELS} if counted else {})
        assert not counts["dh"] and not counts["dw"]
    ran = _card_runs(lambda: graphed.forward(x, ids=batch["ids"]), n=2)
    assert ran == {"fwd": _each_size(2 * per), "dh": {}, "dw": {}, "other": 0}
    assert len(graphed._graphs) == 1  # one signature, one graph


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
def test_ten_replayed_steps_equal_eager_bitwise(cuda, frozen, dropout):
    """Ten training steps replayed from one graph against ten eager steps
    from the same state and generator seed: the same losses, mask counts,
    parameters, Adam moments and EMA, bit for bit (the dropout masks too:
    the graph draws from the registered generator as the eager step does).
    The kernels' own counts of the last step show the card running the
    forward, dh and dW twice per kernel size and layer (12 of each on the
    dynamic path), replayed as eager."""

    cfg, params, batch = _graph_setup(cuda, frozen, dropout)
    graphed, eager = _engines(cuda, cfg, params)
    out = []
    for eng in (graphed, eager):
        state, gen = eng.init_state(), torch.Generator(device=cuda).manual_seed(7)
        losses, masks, last = [], [], {}
        for i in range(10):
            lr = 1e-3 if i < 5 else 5e-4  # the rate of a replay is the tensor's

            def step():
                last["out"] = eng.train_step(state, lr, gen, batch)

            ran = _card_runs(step) if i == 9 else step()
            state, loss, stats = last["out"]
            losses.append(loss)
            masks.append(stats["mask_true"])
        out.append((torch.stack(losses), torch.stack(masks), state, ran))
    (lg, mg, sg, ran), (le, me, se, ran_eager) = out
    assert torch.equal(lg, le) and torch.equal(mg, me)
    for a, b in ((sg.params, se.params), (sg.ema, se.ema)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(sg.tensors(), se.tensors()))
    each = _each_size(_per_size(cfg))
    assert ran == ran_eager == {"fwd": each, "dh": each, "dw": each, "other": 0}


def _staged_plan(cuda, B=16, S=6, seed=0):
    from flow_timesnet_tpu_torch.data import device_windows as dw

    rng = np.random.default_rng(seed)
    t = np.arange(100)[:, None]
    values = np.clip(4 + 2 * np.sin(2 * np.pi * t / 7 + rng.uniform(0, 6, (1, B)))
                     + 0.3 * rng.standard_normal((100, B)), 0, None).astype(np.float32)
    folds = [values[:60], values[60:]]  # 26 and 6 windows a series
    staged = dw.stage_windows(folds, [np.ones_like(f) for f in folds], 28, 7, 1, "direct",
                              device=cuda)
    idx, rv = dw.epoch_index_plan(staged.total, B, shuffle=True, drop_last=True,
                                  rng=np.random.default_rng(seed))
    return staged, idx[:S], rv[:S]


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
def test_resident_epoch_replays_equal_eager_steps_and_never_wait(cuda, frozen):
    """A resident epoch of 6 replayed steps against 6 eager steps on the
    gathered batches (dropout on, one generator seed): bit for bit; then a
    second epoch and a resident evaluation replay under
    ``set_sync_debug_mode("error")`` with their plans on the card, which
    runs each kernel 12 times a step on the card and no wrapper."""

    cfg, params, _ = _graph_setup(cuda, frozen, 0.1)
    staged, idx, rv = _staged_plan(cuda)
    graphed, eager = _engines(cuda, cfg, params)
    state, gen = graphed.init_state(), torch.Generator(device=cuda).manual_seed(3)
    state, losses, mask_true = graphed.train_epoch_resident(state, 1e-3, gen, staged, idx, rv)
    estate, egen = eager.init_state(), torch.Generator(device=cuda).manual_seed(3)
    want = []
    for i, r in zip(idx, rv):
        estate, loss, _ = eager.train_step(estate, 1e-3, egen, eager.gather_staged_batch(staged, i, r))
        want.append(loss)
    assert torch.equal(losses, torch.stack(want))
    assert all(torch.equal(state.params[k], estate.params[k]) for k in state.params)

    idx_d, rv_d = torch.from_numpy(idx).to(cuda), torch.from_numpy(rv).to(cuda)
    graphed.evaluate_resident(state.ema, staged, idx_d, rv_d)  # captures its graph
    torch.cuda.synchronize()
    _clear_fold_counts()
    cuda_fold.clear_kernel_runs()
    torch.cuda.set_sync_debug_mode("error")
    try:  # the epoch's losses come back as device tensors: nothing waits
        state, losses2, _ = graphed.train_epoch_resident(state, 1e-3, gen, staged, idx_d, rv_d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(losses2).all())
    assert not any(_fold_counts().values())  # replays run no wrapper
    runs = cuda_fold.kernel_runs()
    each = _each_size(_per_size(cfg) * len(idx))  # every replayed step runs each kernel
    assert {k: runs[f"{k}_mma"] for k in ("fwd", "dh", "dw")} == {"fwd": each, "dh": each,
                                                                   "dw": each}
    assert not any(runs[f"{k}_f32"] for k in ("fwd", "dh", "dw"))
    # the evaluation reads its sums once, after its replays
    res = graphed.evaluate_resident(state.ema, staged, idx_d, rv_d)
    host = graphed.evaluate(state.ema, [graphed.gather_staged_batch(staged, i, r)
                                        for i, r in zip(idx, rv)])
    assert res["nll"] == host["nll"] and res["smape"] == host["smape"]


@pytest.mark.cuda
def test_graphs_are_captured_per_state_not_per_engine_swap(cuda, monkeypatch):
    """A dynamic and a frozen engine on one ``TrainState`` keep their
    graphs across swaps (the trainer's ``maybe_freeze``); a new state is
    captured anew."""

    import dataclasses

    from flow_timesnet_tpu_torch import graphs

    captures = []
    real = graphs.capture
    monkeypatch.setattr(graphs, "capture", lambda *a, **k: captures.append(1) or real(*a, **k))
    cfg, params, batch = _graph_setup(cuda, True, 0.1)
    dyn, _ = _engines(cuda, dataclasses.replace(cfg, frozen_periods=None), params)
    fro, _ = _engines(cuda, cfg, params)
    state, gen = dyn.init_state(), torch.Generator(device=cuda).manual_seed(0)
    for eng in (dyn, fro, dyn, fro, dyn):
        state, loss, _ = eng.train_step(state, 1e-3, gen, batch)
    assert len(captures) == 2  # one graph each engine
    assert dict(fro.model.named_parameters())["mu_head.kernel"] is state.params["mu_head.kernel"]
    new = dyn.init_state()
    dyn.train_step(new, 1e-3, gen, batch)
    assert len(captures) == 3
    assert bool(torch.isfinite(loss))


@pytest.mark.cuda
def test_capturable_adamw_on_the_card_matches_the_cpu(cuda):
    """The card's AdamW is ``capturable`` (its step counts and learning rate
    on the card, another order of operations); five clipped steps with
    weight decay equal the CPU's (torch's default form, which
    ``tests/test_torch_optim.py`` holds to optax) within rtol/atol 1e-6,
    that test's tolerance."""

    from flow_timesnet_tpu_torch import optim

    rng = np.random.default_rng(0)
    shapes = ((4, 3), (7,), (2, 5, 3))
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    out = {}
    for dev in ("cpu", cuda):
        params = [torch.from_numpy(p.copy()).to(dev) for p in start]
        opt = optim.build_optimizer(params, 1.0, 1e-2)
        assert opt.adamw.defaults["capturable"] == (dev != "cpu")
        for i, g in enumerate(grads):
            opt.set_lr(1e-2 if i < 3 else 3e-3)
            opt.step([torch.from_numpy(x.copy()).to(dev) for x in g])
        out[str(dev)] = [p.cpu() for p in params]
    for a, b in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_a_failed_capture_raises_and_runs_nothing_eagerly(cuda):
    """A forward that reads a value back to the host cannot be captured: the
    request raises, no graph is kept and the counters count only the
    warm-up's launches; the card stays usable."""

    cfg, params, batch = _graph_setup(cuda, False, 0.0)
    graphed, _ = _engines(cuda, cfg, params)
    forward = graphed.model.forward

    def reads_back(x, *args, **kwargs):
        float(x.sum())  # a copy to the host: fine eagerly, refused in a capture
        return forward(x, *args, **kwargs)

    graphed.model.forward = reads_back
    _clear_fold_counts()
    with pytest.raises(RuntimeError):
        graphed.forward(batch["x"])
    assert not graphed._graphs
    from flow_timesnet_tpu_torch import graphs
    assert _fold_counts()["fwd"] == {f"{kh}x{kw}": _per_size(cfg) * graphs.WARMUP_CALLS
                                     for kh, kw in GRAPH_KERNELS}
    torch.cuda.synchronize()
    assert float(torch.ones(3, device=cuda).sum()) == 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_kernels_count_their_runs_as_the_wrappers_count_launches(cuda, compute_dtype):
    """Eagerly every launch runs, so the kernels' own counts of a training
    step (``cuda_fold.kernel_runs``) equal the wrappers' counters, kernel by
    kernel, route by route and size by size."""

    import dataclasses

    cfg, params, batch = _graph_setup(cuda, False, 0.0)
    _, eng = _engines(cuda, dataclasses.replace(cfg, compute_dtype=compute_dtype), params)
    state = eng.init_state()
    eng.train_step(state, 1e-3, None, batch)  # makes the run cells before they are cleared
    _clear_fold_counts()
    cuda_fold.clear_kernel_runs()
    eng.train_step(state, 1e-3, None, batch)
    counts, runs = _fold_counts(), cuda_fold.kernel_runs()
    for kind in ("fwd", "dh", "dw"):
        f32 = {k: n - counts[f"{kind}_mma"].get(k, 0) for k, n in counts[kind].items()}
        assert runs[f"{kind}_mma"] == counts[f"{kind}_mma"]
        assert runs[f"{kind}_f32"] == {k: n for k, n in f32.items() if n}
    mma = compute_dtype == "bfloat16"
    assert bool(runs["fwd_mma"]) == mma and bool(runs["fwd_f32"]) != mma


# -- use_checkpoint: the rematerialised TimesBlocks on the card ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
def test_replayed_checkpointed_steps_equal_eager_and_no_remat(cuda, frozen):
    """Five remat steps at dropout 0.1 replayed from one graph against five
    eager remat steps and five eager steps without remat, from one state and
    generator seed: the same losses and state bit for bit (the recompute
    replays the forward's masks inside the graph too). A replayed step runs
    the forward twice a pass on the card (the recompute in the backward), dh
    and dW once."""

    import dataclasses

    cfg, params, batch = _graph_setup(cuda, frozen, 0.1)
    remat = dataclasses.replace(cfg, use_checkpoint=True)
    graphed, eager = _engines(cuda, remat, params)
    _, plain = _engines(cuda, cfg, params)
    out = []
    for eng in (graphed, eager, plain):
        state, gen = eng.init_state(), torch.Generator(device=cuda).manual_seed(7)
        losses, last = [], {}
        for i in range(5):
            def step():
                last["out"] = eng.train_step(state, 1e-3, gen, batch)

            ran = _card_runs(step) if i == 4 else step()
            state, loss, _ = last["out"]
            losses.append(loss)
        out.append((torch.stack(losses), state, ran))
    (lg, sg, ran), (le, se, ran_eager), (lp, sp, ran_plain) = out
    assert torch.equal(lg, le) and torch.equal(lg, lp)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(sg.tensors(), se.tensors(), sp.tensors()))
    each = _each_size(_per_size(cfg))
    assert ran == ran_eager == {"fwd": _each_size(2 * _per_size(cfg)), "dh": each, "dw": each,
                                "other": 0}
    assert ran_plain == {"fwd": each, "dh": each, "dw": each, "other": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
def test_a_checkpointed_step_never_waits_for_the_card(cuda, frozen):
    """An eager and a replayed remat step at dropout 0.1 make no
    synchronising call after their warm-up: the recompute reads nothing back
    to the host."""

    import dataclasses

    cfg, params, batch = _graph_setup(cuda, frozen, 0.1)
    graphed, eager = _engines(cuda, dataclasses.replace(cfg, use_checkpoint=True), params)
    for eng in (graphed, eager):
        state, gen = eng.init_state(), torch.Generator(device=cuda).manual_seed(0)
        eng.train_step(state, 1e-3, gen, batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.train_step(state, 1e-3, gen, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_train_once_replays_graphs_across_engine_swaps(cuda, tmp_path, monkeypatch):
    """``train_once`` on the card through the scripted engine swaps of
    ``tests/test_torch_train_once_control.py`` (AABBAA: freeze at epoch 2,
    drift back to the dynamic engine at 3, a second spec at 4, a drift at
    5, and at 6 the engine swapped out at 3 takes up the state again) at
    bf16 with dropout on, once replaying CUDA graphs and once op by op
    (``Engine.cuda_graphs = False``). Each engine's graphs were captured on
    the state as it stood then; replayed after the state moved on, they
    must give what the eager dispatch gives: every epoch's losses and
    validation metrics equal bit for bit, and the same best checkpoint."""

    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_train_once_control import (
        control_config, record_epochs, script_specs, write_csv,
    )

    from flow_timesnet_tpu_torch import train as ptrain
    from flow_timesnet_tpu_torch.engine import Engine

    csv_path = write_csv(tmp_path)
    wrappers = (cuda_fold.launches, cuda_fold.launches_dh, cuda_fold.launches_dw)
    runs = {}
    for graphed in (True, False):
        with monkeypatch.context() as m:
            specs = script_specs(m, "AABBAA")
            log = record_epochs(m)
            if not graphed:
                init = Engine.__init__

                def eager_init(self, *args, **kwargs):
                    init(self, *args, **kwargs)
                    self.cuda_graphs = False

                m.setattr(Engine, "__init__", eager_init)
            cfg = control_config(csv_path, tmp_path / f"graphed_{graphed}", 6)
            cfg["train"]["device"] = "cuda"
            cfg["model"].update(d_model=64, d_ff=128, dropout=0.1, compute_dtype="bfloat16")
            _clear_fold_counts()
            cuda_fold.clear_kernel_runs()
            best, paths = ptrain.train_once(cfg)
            ran = sum(n for kind in cuda_fold.kernel_runs().values() for n in kind.values())
            wrapped = sum(sum(counter.values()) for counter in wrappers)
            runs[graphed] = dict(specs=specs, log=log, best=best, paths=paths, ran=ran,
                                 wrapped=wrapped)

    g, e = runs[True], runs[False]
    want = [None, "A", None, "B", None, "A"]
    for run in (g, e):
        assert run["log"]["specs"] == [None if k is None else run["specs"][k] for k in want]
        assert run["log"]["engines"][5] is run["log"]["engines"][1]
    assert g["specs"] == e["specs"]
    # the graphed run replays (the kernels ran more often than any wrapper
    # launched them); the eager run launches every kernel through its wrapper
    assert g["ran"] > g["wrapped"] > 0 and e["ran"] == e["wrapped"] > 0
    for ep, (lg, le) in enumerate(zip(g["log"]["losses"], e["log"]["losses"]), start=1):
        assert np.array_equal(lg, le), f"epoch {ep}: losses"
    for ep, (mg, me) in enumerate(zip(g["log"]["metrics"], e["log"]["metrics"]), start=1):
        assert (float(mg["nll"]), float(mg["smape"])) == (float(me["nll"]), float(me["smape"])), (
            f"epoch {ep}: validation metrics")
    assert g["best"] == e["best"]
    assert g["paths"]["metrics"]["best_epoch"] == e["paths"]["metrics"]["best_epoch"]
    assert (tmp_path / "graphed_True" / "timesnet.msgpack").read_bytes() == (
        tmp_path / "graphed_False" / "timesnet.msgpack").read_bytes()


@pytest.mark.cuda
def test_chunked_predict_replays_one_graph(cuda, tmp_path, monkeypatch):
    """``predict_once`` on the card from ``train_once``'s artifacts, the
    series cut into 4-row chunks on a frozen spec (10 series: 4 + 4 + 2
    padded rows a TEST file, 15 chunks in all): one forward graph captured,
    replayed for every chunk (the kernels' own run counts: the warm-up calls
    and 15 replays; the wrappers: the warm-up and the capture), and the
    submission equal, byte for byte, to the one dispatched op by op
    (``Engine.cuda_graphs = False``)."""

    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_train_once_control import control_config, write_csv

    import chip_smoke
    from flow_timesnet_tpu_torch import graphs, predict
    from flow_timesnet_tpu_torch.engine import Engine
    from flow_timesnet_tpu_torch.train import train_once

    data = tmp_path / "data"
    os.makedirs(data)
    chip_smoke.write_demand_csv(np, str(data / "train.csv"), 7, 2, 5, 150)
    cfg = control_config(data / "train.csv", tmp_path / "artifacts", 2)
    cfg["train"]["device"] = "cuda"
    # d_model 64: the inception's 16 channels, the least the tensor-core kernels take
    cfg["model"].update(d_model=64, d_ff=128, compute_dtype="bfloat16")
    train_once(cfg)
    spec = [[[7, 4, True], [14, 2, True]]] * 2
    cfg["data"].update(test_dir=str(data / "test"),
                       sample_submission=str(data / "sample_submission.csv"))
    cfg["train"]["frozen_periods_spec"] = spec
    cfg["predict"] = {"chunk_rows": 4, "freeze_periods": "on"}
    out = {}
    for graphed in (True, False):
        with monkeypatch.context() as m:
            captures = []
            capture = graphs.capture
            m.setattr(graphs, "capture", lambda *a, **k: captures.append(1) or capture(*a, **k))
            if not graphed:
                init = Engine.__init__

                def eager_init(self, *args, **kwargs):
                    init(self, *args, **kwargs)
                    self.cuda_graphs = False

                m.setattr(Engine, "__init__", eager_init)
            cfg["submission"] = {"out_path": str(tmp_path / f"graphed_{graphed}.csv"),
                                 "format": "row_key"}
            _clear_fold_counts()
            cuda_fold.clear_kernel_runs()
            path = predict.predict_once(cfg)
            ran = sum(cuda_fold.kernel_runs()["fwd_mma"].values())
            wrapped = sum(cuda_fold.launches_mma.values())
            out[graphed] = dict(csv=open(path, "rb").read(), captures=len(captures), ran=ran,
                                wrapped=wrapped)
    g, e = out[True], out[False]
    per_pass = 2 * 2 * 2  # 2 layers x 2 inception blocks x 2 unique periods, one kernel size
    assert g["captures"] == 1 and e["captures"] == 0
    assert g["wrapped"] == (graphs.WARMUP_CALLS + 1) * per_pass
    assert g["ran"] == (graphs.WARMUP_CALLS + 15) * per_pass
    assert e["ran"] == e["wrapped"] == 15 * per_pass
    assert g["csv"] == e["csv"] and g["csv"].count(b"\n") == 1 + 5 * 7
