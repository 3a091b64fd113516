"""The float32 forward kernel's decomposition, modelled in numpy on the CPU.

``csrc/tap_conv_fwd.cu::tap_conv_fwd_kernel`` runs only on the card. These
tests model how it cuts the work, block by block, and hold the model against
the port's plain ``ops/fold.py::tap_conv``, the JAX package's
``ops/fold.py::tap_conv`` and its Pallas kernel (``sign=+1``) in interpret
mode, over every row of Lp (rows past each fold extent read the grid through
taps with dc < 0, and later convs read them):

- the launch plan of ``ops/cuda_fold.py::fwd_f32_plan``, which the kernel's
  C plan mirrors, at the flagship shapes, over every shape the first float32
  forward took, and its refusals;
- W's column slice staged once a pass as its [tap][ci] rows, the lane
  layout (RG rows x CG groups of 4 output channels), the warps of each group
  spread over the schedulers, the items with the candidates alternating,
  each staged as one window or kr bands with every never-staged row NaN,
  the zero row a masked lane reads, the warp vote that skips a tap, the
  channel tiles and the passes over kernel rows and input channels;
- the shared-memory loads of the lane layout: each in the fewest
  wavefronts its bytes allow.

float32 products are exact in both the model and the references, so they
differ only in the order of the float32 sums: within 1e-5 of the largest
|value|.
"""

import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flow_timesnet_tpu.ops import fold as jfold  # noqa: E402
from flow_timesnet_tpu.ops.pallas_fold import tap_conv_pallas  # noqa: E402
from flow_timesnet_tpu_torch.ops import cuda_fold, fold  # noqa: E402
from port_helpers import float4_wavefronts  # noqa: E402

TOL = 1e-5
L = 28  # the flagship's window: Lp = 55, p_cap = 27


def _round4(n):
    return -(-n // 4) * 4


# --- the model of tap_conv_fwd_kernel -------------------------------------------

def fwd_lanes(nt):
    """(CG, RG, WR): lanes are RG rows by CG groups of 4 output channels
    (lane l: rows l % RG + RG i, i < 4, channels 4 (l // RG) .. + 3), and a
    warp owns WR = 4 * RG consecutive rows (of an item, or past it where the
    item is shorter)."""

    cg = nt // 4
    assert cuda_fold.f32_warp_rows(nt) == 4 * (32 // cg)
    return cg, 32 // cg, 4 * (32 // cg)


def warp_of(plan, warp):
    """(group, row tile) of a warp: warp = wt * groups + (g + wt) % groups."""

    wt = warp // plan.groups
    return (warp % plan.groups - wt) % plan.groups, wt


def pass_of(plan, cin, kh, n):
    """Pass n's kernel rows [r0, r1) and input channels [ci0, ci0 + cw)."""

    ci_passes = -(-cin // plan.kc)
    r0, ci0 = n // ci_passes * plan.kr, n % ci_passes * plan.kc
    return r0, min(kh, r0 + plan.kr), ci0, min(plan.kc, cin - ci0)


def staged_w(w, n0, nt, r0, r1, ci0, cw, kc4):
    """W's slice as a block stages it for a pass: [tap of rows r0..r1, kc4,
    nt] rows of co; rows [cw, round4(cw)) zero, and NaN wherever no copy
    lands (rows past them, columns past Cout)."""

    kw, cout = w.shape[1], w.shape[3]
    w_s = np.full(((r1 - r0) * kw, kc4, nt), np.nan, np.float32)
    nco = min(nt, cout - n0)
    for tap in range((r1 - r0) * kw):
        dci, dji = divmod(r0 * kw + tap, kw)
        w_s[tap, :cw, :nco] = w[dci, dji, ci0:ci0 + cw, n0:n0 + nco]
    w_s[:, cw:_round4(cw)] = 0.0
    return w_s


def stage_fwd(buf, plan, seq, t0, p, r0, r1, ci0, cw, kh, kw):
    """One item of h into ``buf`` as a group stages it for a pass: its data
    columns NaN first (what a stale buffer may hold; the columns [cw,
    round4(cw)) were zeroed at the pass's start and no copy writes them),
    then the window or the bands of kernel rows [r0, r1), rows outside
    [0, Lp) left stale. Returns, per kernel row, the base such that the
    staged row of output row t and tap (dc, dj) is base[dci] + (t - t0) + dj."""

    Lp = seq.shape[0]
    rh, rw = kh // 2, kw // 2
    buf[:, :cw] = np.nan

    def put(b_row, g0, n):
        for r in range(n):
            if 0 <= g0 + r < Lp:
                buf[b_row + r, :cw] = seq[g0 + r, ci0:ci0 + cw]

    if plan.band:
        band_rows = plan.rt + kw - 1
        assert (r1 - r0) * band_rows <= plan.buf_rows
        for s in range(r1 - r0):
            put(s * band_rows, t0 + (r0 + s - rh) * p - rw, band_rows)
        return {r0 + s: s * band_rows + rw for s in range(r1 - r0)}
    padw = rh * p + rw
    w0 = max(0, t0 - padw)
    n = min(Lp, t0 + plan.rt + padw) - w0
    assert n <= plan.buf_rows
    put(0, w0, n)
    return {dci: t0 - w0 + (dci - rh) * p for dci in range(r0, r1)}


def model_fwd(h, w, bias, periods, cycles, kh, kw, p_max, plan=None):
    """The forward as the kernel computes it: tile, chunk, pass, group, item,
    warp, tap."""

    K, B, Lp, cin = h.shape
    cout = w.shape[3]
    plan = plan or cuda_fold.fwd_f32_plan(K, B, Lp, cin, cout, kh, kw, p_max)
    nt = plan.nt
    _, _, WR = fwd_lanes(nt)
    rt, tpi = plan.rt, max(1, plan.rt // WR)
    assert plan.warps == plan.groups * tpi
    warps = [warp_of(plan, w) for w in range(plan.warps)]
    assert sorted(warps) == [(g, wt) for g in range(plan.groups) for wt in range(tpi)]
    assert plan.passes == -(-kh // plan.kr) * -(-cin // plan.kc)
    assert plan.sx == cuda_fold.f32_stride(plan.kc)
    kc4 = _round4(plan.kc)
    n_rt = plan.lp_pad // rt
    out = np.full((K, B, Lp, cout), np.nan, np.float32)
    written = np.zeros((K, B, Lp, cout), int)
    for tile in range(plan.tiles):
        n0 = tile * nt
        cols = n0 + np.arange(nt)
        on = cols < cout
        for chunk in range(plan.chunks):
            i0 = chunk * plan.per_chunk
            n_items = min(plan.per_chunk, K * B * n_rt - i0)
            assert n_items >= 1
            for n in range(plan.passes):
                r0, r1, ci0, cw = pass_of(plan, cin, kh, n)
                w_s = staged_w(w, n0, nt, r0, r1, ci0, cw, kc4)
                for g in range(plan.groups):
                    buf = np.full((plan.buf_rows, plan.sx), np.nan, np.float32)
                    buf[:, cw:_round4(cw)] = 0.0
                    for item in range(i0 + g, i0 + n_items, plan.groups):
                        k, b, t0 = item % K, item // K // n_rt, (item // K % n_rt) * rt
                        p = min(max(int(periods[k]), 1), p_max)
                        cyc = int(cycles[k])
                        base = stage_fwd(buf, plan, h[k, b], t0, p, r0, r1, ci0, cw, kh, kw)
                        end = min(t0 + rt, Lp)  # rows past the item or the sequence
                        for _, wt in [gw for gw in warps if gw[0] == g]:
                            t = t0 + wt * WR + np.arange(WR)
                            acc = np.zeros((WR, nt), np.float32)
                            for dci in range(r0, r1):
                                dc = dci - kh // 2
                                for dji in range(kw):
                                    dj = dji - kw // 2
                                    s = t + dc * p + dj
                                    v = ((t < end) & (t // p + dc >= 0) & (t // p + dc < cyc)
                                         & (t % p + dj >= 0) & (t % p + dj < p)
                                         & (s >= 0) & (s < Lp))
                                    if not v.any():  # the warp vote: every row masked
                                        continue
                                    src = base[dci] + t - t0 + dj
                                    assert (src[v] >= 0).all() and (src[v] < plan.buf_rows).all()
                                    # a masked lane reads the zero row; nothing is
                                    # multiplied by a mask
                                    a = np.where(v[:, None], buf[np.where(v, src, 0), :_round4(cw)],
                                                 0.0)
                                    acc += a @ w_s[(dci - r0) * kw + dji, :_round4(cw)]
                            keep = t < end
                            idx = (k, b, t[keep][:, None], cols[on][None, :])
                            val = acc[keep][:, on]
                            if n > 0:  # what this lane wrote in the pass before
                                val = out[idx] + val
                            if n == plan.passes - 1:
                                val = val + bias[cols[on]]
                            out[idx] = val
                            written[idx] += 1
    assert (written == plan.passes).all()  # every output once a pass, by one lane
    return out, plan


# --- inputs and references ---------------------------------------------------------

def _inputs(seed, K, B, Lp, cin, cout, kh, kw):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((K, B, Lp, cin)).astype(np.float32)  # every row is data
    w = (rng.standard_normal((kh, kw, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return h, w, bias


def _references(h, w, bias, periods, Lc, kh, kw, pallas=False):
    """(geometry, plain, JAX[, Pallas in interpret mode])."""

    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), Lc, Lc - 1)
    plain = fold.tap_conv(torch.from_numpy(h), geom, torch.from_numpy(w),
                          torch.from_numpy(bias), kh, kw).numpy()
    jg = jfold.make_geometry(jnp.asarray(periods, jnp.int32), Lc, p_cap=Lc - 1)
    args = (jnp.asarray(h), jg, jnp.asarray(w), jnp.asarray(bias), kh, kw)
    out = [geom, plain, np.asarray(jfold.tap_conv(*args))]
    if pallas:
        out.append(np.asarray(tap_conv_pallas(*args, interpret=True)))
    return out


def _assert_close(got, want, name):
    assert got.shape == want.shape  # every row of Lp
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=name)


def _check(seed, periods, kh, kw, cin=32, cout=32, B=5, Lc=L, pallas=False, plan=None):
    Lp = 2 * Lc - 1
    h, w, bias = _inputs(seed, len(periods), B, Lp, cin, cout, kh, kw)
    refs = _references(h, w, bias, periods, Lc, kh, kw, pallas)
    geom = refs[0]
    got, plan = model_fwd(h, w, bias, geom.periods.numpy(), geom.cycles.numpy(), kh, kw,
                          Lc - 1, plan)
    _assert_close(got, refs[1], "forward: plain")
    _assert_close(got, refs[2], "forward: JAX")
    if pallas:
        _assert_close(got, refs[3], "forward: Pallas (interpret)")
    return plan


# --- the model against the references ----------------------------------------------

@pytest.mark.parametrize("p", [1, 7, 27])
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5), (7, 7), (1, 3)])
def test_model_matches_plain_jax_and_pallas(kh, kw, p):
    """The flagship fold (L=28, Lp=55, 32 channels) at B=5, the second
    candidate 27 (14 beside 27): the plan's tiles, one window an item."""

    plan = _check(kh * 100 + p, [p, 27 if p != 27 else 14], kh, kw, pallas=True)
    assert (plan.passes, plan.band, plan.rt) == (1, 0, 64)


@pytest.mark.parametrize("cin,cout", [(16, 48), (48, 16), (64, 32), (24, 40), (18, 30), (5, 3),
                                      (3, 7), (33, 1)])
@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7)])
def test_model_over_channels(kh, kw, cin, cout):
    """Cin != Cout both ways, widths that are not a multiple of 4 (4-byte
    copies on the card, zero columns past Cin), several channel tiles and
    tiles past Cout, and Cout below the narrowest tile."""

    plan = _check(cin * 7 + cout + kh, [4, 27], kh, kw, cin, cout, B=3)
    assert plan.tiles * plan.nt >= cout and (plan.nt <= cout or plan.nt == 8)


@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_model_takes_the_long_context_shape(kh, kw):
    """configs/long_context.yaml's fold: L=512 (Lp=1023, p_cap 511), K=4,
    mid 32, one series: 16 items a sequence, staged as kh bands."""

    plan = _check(kh, [511, 168, 24, 7], kh, kw, B=1, Lc=512, pallas=kh == 3)
    assert (plan.band, plan.rt, plan.lp_pad, plan.passes) == (1, 64, 1024, 1)
    assert plan.buf_rows == kh * (64 + kw - 1) < min(1023, 64 + 2 * plan.pad)


@settings(max_examples=12, deadline=None)
@given(st.data())
def test_model_matches_plain_over_periods_and_sizes(data):
    Lc = data.draw(st.integers(4, 40), label="L")
    kh = data.draw(st.sampled_from([1, 3, 5, 7]), label="kh")
    kw = data.draw(st.sampled_from([1, 3, 5, 7]), label="kw")
    periods = data.draw(st.lists(st.integers(1, Lc - 1), min_size=1, max_size=3), label="periods")
    cin = data.draw(st.sampled_from([3, 4, 16, 32, 40]), label="cin")
    cout = data.draw(st.sampled_from([3, 8, 32, 36]), label="cout")
    B = data.draw(st.integers(1, 3), label="B")
    _check(data.draw(st.integers(0, 2**31 - 1), label="seed"), periods, kh, kw, cin, cout, B=B,
           Lc=Lc)


def test_groups_take_several_items():
    """A chunk of more items than groups: each group stages its items one
    after another into one buffer."""

    plan = cuda_fold.fwd_f32_plan(2, 6, 55, 32, 32, 3, 3, L - 1)._replace(
        per_chunk=4, chunks=3, groups=3, warps=12)
    _check(11, [7, 27], 3, 3, B=6, plan=plan)


@pytest.mark.parametrize("kr,kc,band", [(5, 32, 0), (2, 32, 0), (5, 12, 0), (2, 8, 1), (1, 4, 1)])
def test_passes_over_kernel_rows_and_channels(kr, kc, band):
    """Plans that cut the 5x5 kernel's rows into slices of kr and Cin = 18
    into slices of kc channels (the last one partial, not a multiple of 4),
    staged as one window or kr bands: each pass adds its sum to what the
    lane wrote in the pass before, and the bias comes last."""

    cin, kh = 18, 5
    plan = cuda_fold.fwd_f32_plan(2, 3, 55, cin, 20, kh, kh, L - 1)
    kc = min(kc, cin)
    buf_rows = kr * (plan.rt + kh - 1) if band else plan.buf_rows
    plan = plan._replace(kr=kr, kc=kc, sx=cuda_fold.f32_stride(kc), band=band, buf_rows=buf_rows,
                         passes=-(-kh // kr) * -(-cin // kc))
    _check(kr * 10 + kc, [7, 27], kh, kh, cin, 20, B=3, plan=plan)


@pytest.mark.parametrize("shape,kr,kc", [
    ((1, 1, 20, 2000, 1, 3, 3, 10), 3, 500),  # Cin in slices: W and an item too wide at once
    ((1, 2, 100, 1, 3, 61, 61, 50), 21, 1),  # kernel rows in slices: 3,721 taps of W
])
def test_plans_take_passes_where_one_does_not_fit(shape, kr, kc):
    """Shapes the first kernel took (4 (Lp Cin + kw Cin Cout) bytes within
    227 KB) that one pass cannot take: the plan cuts the channels or the
    kernel rows, and the model of those passes matches the plain version."""

    K, B, Lp, cin, cout, kh, kw, p_max = shape
    plan = cuda_fold.fwd_f32_plan(*shape)
    assert (plan.kr, plan.kc) == (kr, kc) and plan.passes > 1 and plan.nt == 8
    Lc = Lp - p_max
    periods = [p_max] if K == 1 else [p_max, 7][:K]
    h, w, bias = _inputs(3, K, B, Lp, cin, cout, kh, kw)
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), Lc, p_max)
    assert geom.Lp == Lp
    got, _ = model_fwd(h, w, bias, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, p_max)
    want = fold.tap_conv(torch.from_numpy(h), geom, torch.from_numpy(w), torch.from_numpy(bias),
                         kh, kw)
    _assert_close(got, want.numpy(), "forward in passes: plain")


def test_never_reads_h_past_the_fold():
    """A valid tap reads h inside [0, total): NaN in the rows [total, Lp) of
    h (which may hold anything) reaches no output, where the plain version's
    multiply by the mask would spread it; the output rows [total, Lp) are
    still computed from the grid."""

    kh = kw = 7
    h, w, bias = _inputs(4, 2, 3, 55, 32, 32, kh, kw)
    geom = fold.make_geometry(torch.tensor([7, 27], dtype=torch.int32), L, L - 1)
    poisoned = h.copy()
    for k, total in enumerate(geom.total.tolist()):
        poisoned[k, :, total:] = np.nan
    got, _ = model_fwd(poisoned, w, bias, geom.periods.numpy(), geom.cycles.numpy(), kh, kw,
                       L - 1)
    zeroed = np.nan_to_num(poisoned, nan=0.0)
    want = fold.tap_conv(torch.from_numpy(zeroed), geom, torch.from_numpy(w),
                         torch.from_numpy(bias), kh, kw).numpy()
    assert np.isfinite(got).all()
    _assert_close(got, want, "forward, h NaN past the fold")
    assert not np.allclose(want[0, :, 28:35], bias)  # rows past p = 7's fold read the grid


# --- lanes and shared-memory loads ---------------------------------------------------

@pytest.mark.parametrize("nt", cuda_fold.FWD_TILES)
def test_lanes_cover_the_warp_tile_and_load_without_conflicts(nt):
    """Lane l has rg = l % RG and cg = l // RG: rows rg + RG * i (i < 4) and
    output channels 4 cg .. 4 cg + 3 cover the warp's WR x nt tile once; the
    h float4s of one i take the fewest wavefronts their bytes allow, and the
    W float4s of one ci, all in one staged row, take one."""

    CG, RG, WR = fwd_lanes(nt)
    seen = np.zeros((WR, nt), int)
    for lane in range(32):
        rg, cg = lane % RG, lane // RG
        for i in range(4):
            seen[rg + RG * i, 4 * cg:4 * cg + 4] += 1
    assert (seen == 1).all()
    for cin in (8, 30, 32, 48, 64):
        sx = cuda_fold.f32_stride(cin)
        for i in range(4):
            for row0 in (0, 5, 13):
                for ci in (0, 4, 28):
                    addr = [((row0 + lane % RG + RG * i) * sx + ci) // 4 for lane in range(32)]
                    assert float4_wavefronts(addr) == -(-len(set(addr)) // 8)
        for tap, ci in ((0, 0), (3, 5)):
            addr = [((tap * _round4(cin) + ci) * nt + 4 * (lane // RG)) // 4 for lane in range(32)]
            assert float4_wavefronts(addr) == 1


# --- the plans -------------------------------------------------------------------------

@pytest.mark.parametrize("B,kh,nt,groups,per_chunk,chunks,smem", [
    (256, 3, 32, 4, 4, 128, 68_688),
    (256, 5, 32, 4, 4, 128, 134_224),
    (256, 7, 16, 8, 8, 64, 163_856),
    (192, 3, 32, 4, 3, 128, 68_688),
    (192, 5, 32, 4, 3, 128, 134_224),
    (192, 7, 16, 8, 6, 64, 163_856),
])
def test_plan_at_the_flagship_shapes(B, kh, nt, groups, per_chunk, chunks, smem):
    """K=2, Lp=55, 32 channels, p_cap 27, training (B=256) and serving
    (B=192): each sequence one item staged as one window of its 55 rows, 16
    warps a block, one pass, in 128 blocks (one wave on 132 SMs), each chunk
    holding both candidates. At 7x7 W's 32 columns (196 KB) and four 16-row
    groups pass 227 KB by 80 bytes, so the tile is 16 channels."""

    plan = cuda_fold.fwd_f32_plan(2, B, 55, 32, 32, kh, kh, 27)
    assert (plan.nt, plan.groups, plan.per_chunk, plan.chunks, plan.smem) == (
        nt, groups, per_chunk, chunks, smem)
    assert (plan.lp_pad, plan.rt, plan.band, plan.buf_rows, plan.kr, plan.kc, plan.passes,
            plan.sx, plan.warps) == (64, 64, 0, 55, kh, 32, 1, 36, 16)
    assert plan.per_chunk <= plan.groups and plan.chunks * plan.tiles == 128
    assert plan.smem == 4 * (kh * kh * 32 * nt + groups * 55 * 36 + 36)
    if kh == 7:
        assert 4 * (49 * 32 * 32 + 4 * 55 * 36 + 36) == cuda_fold.MAX_SMEM_BYTES + 80


def _first_kernel_took(Lp, cin, cout, kw):
    """The first float32 forward's limits: the whole sequence and one kernel
    row of W in 227 KB of shared memory, and 8 outputs a thread of 256."""

    return 4 * (Lp * cin + kw * cin * cout) <= cuda_fold.MAX_SMEM_BYTES and cout <= 2048


def test_plan_takes_every_shape_the_first_kernel_took():
    """Cin = Cout = C (the model's inception convs) at the shipped kernel
    sizes and any Lp = L + p_cap, then a seeded draw of shapes far from the
    model's (Cin up to 8,000 beside Cout up to 2,048, Lp up to 60,000,
    kernels up to 201 x 101): every shape the first kernel took has a plan
    within 227 KB."""

    def takes(shape):
        return cuda_fold.fwd_f32_plan(*shape).smem <= cuda_fold.MAX_SMEM_BYTES

    for kh, kw in [(3, 3), (5, 5), (7, 7), (1, 3)]:
        for c in list(range(1, 65)) + list(range(72, 257, 8)):
            for Lp in list(range(3, 120)) + list(range(120, 3000, 37)):
                if _first_kernel_took(Lp, c, c, kw):
                    assert takes((2, 16, Lp, c, c, kh, kw, max(1, Lp // 2)))
    rng = random.Random(7)
    n = 0
    while n < 3000:
        kh = rng.choice([1, 3, 5, 7, 9, 11, 21, 51, 101, 201])
        kw = rng.choice([1, 3, 5, 7, 9, 11, 17, 35, 101])
        cin = rng.choice([rng.randint(1, 8), rng.randint(1, 64), rng.randint(1, 512),
                          rng.randint(1, 8000)])
        cout = rng.choice([rng.randint(1, 8), rng.randint(1, 64), rng.randint(1, 2048)])
        Lp = rng.choice([rng.randint(2, 120), rng.randint(2, 3000), rng.randint(2, 60000)])
        if not _first_kernel_took(Lp, cin, cout, kw):
            continue
        p_max = rng.choice([1, max(1, Lp // 2), max(1, Lp - 1), max(1, Lp // kh)])
        assert takes((2, 16, Lp, cin, cout, kh, kw, p_max)), (Lp, cin, cout, kh, kw, p_max)
        n += 1
    # the 4,096 output channels the first kernel refused take 128 tiles of 32
    assert cuda_fold.fwd_f32_plan(1, 2, 15, 4, 4096, 3, 3, 7).tiles == 128


@pytest.mark.parametrize("shape,why", [
    ((2, 4, 55, 32, 32, 3, 4, 27), "kernel size odd"),
    ((2, 4, 55, 0, 32, 3, 3, 27), "positive"),
    ((2, 4, 55, 32, 32, 3, 3, 56), r"p_max must lie in \[1, Lp\]"),
    ((2, 4, 55, 32, 32, 3, 3, 0), r"p_max must lie in \[1, Lp\]"),
    ((1, 2, 15, 4, 4, 1, 4001, 7), "more than 232448 bytes"),
])
def test_plan_refuses_what_the_kernel_cannot_take(shape, why):
    """A kernel row of 4,001 taps at 4 channels (W's slice alone 256 KB),
    which the first kernel refused too, and shapes no kernel takes."""

    with pytest.raises(RuntimeError, match=f"tap_conv_fwd launch failed with cudaError_t 1 .*{why}"):
        cuda_fold.fwd_f32_plan(*shape)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the forward is the plain version in float32: no launch is
    counted on either route."""

    kh, kw = 5, 5
    geom = fold.make_geometry(torch.tensor([7, 27], dtype=torch.int32), L, L - 1)
    h, w, bias = _inputs(5, 2, 2, geom.Lp, 32, 32, kh, kw)
    before = (sum(cuda_fold.launches.values()), sum(cuda_fold.launches_mma.values()))
    args = (torch.from_numpy(h), geom, torch.from_numpy(w), torch.from_numpy(bias), kh, kw)
    assert torch.equal(cuda_fold.tap_conv(*args), fold.tap_conv(*args))
    assert (sum(cuda_fold.launches.values()), sum(cuda_fold.launches_mma.values())) == before
