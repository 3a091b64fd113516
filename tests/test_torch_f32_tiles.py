"""The float32 dh and dW kernels' decompositions, modelled in numpy on the CPU.

``csrc/tap_conv_bwd.cu::tap_conv_dh_kernel`` and ``tap_conv_dw_kernel`` run
only on the card. These tests model how each cuts the work, block by block,
and hold the models against the port's plain ``ops/fold.py::tap_conv_dh`` /
``tap_weight_grad``, the JAX package's custom VJP (``ops/fold.py::
_tap_conv_bwd``, which returns both) and, for dh, its Pallas kernel with
``sign=-1`` in interpret mode:

- the launch plans of ``ops/cuda_fold.py::dh_f32_plan`` and ``dw_f32_plan``,
  which the kernels' C plans mirror, at the flagship shapes, over every shape
  the first float32 kernels took, and their refusals;
- dh: W's channel tile staged once as its [tap][ci][co] rows, the lane
  layout (RG rows x CG channels, 4 of each a lane), the warps of each group
  spread over the schedulers, the items with the candidates alternating,
  each staged as one window or kh bands with every never-staged row NaN,
  the zero row a masked lane reads, the warp vote that skips a tap, groups
  of warps and the channel tiles;
- dW: the block's kernel rows, each over the chunk's items in rounds of one
  item a split, staged as ct rows and an h band with every never-staged row
  NaN, the ballot of valid rows (the same in every lane), the splits that
  share a tap and sum in split order, and pass 2 summing the chunks in chunk
  order;
- the shared-memory loads of both lane layouts: each in the fewest
  wavefronts its bytes allow.

float32 products are exact in both the model and the references, so they
differ only in the order of the float32 sums: within 2e-5 (the JAX package's
fold-conv gradient tolerance) of the largest |value|.
"""

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

ROWS = cuda_fold.F32_ROWS
TILE = cuda_fold.DW_TILE
TOL = 2e-5
SIZES = [(3, 3), (5, 5), (7, 7), (1, 3)]
L = 28  # the flagship's window: Lp = 55, p_cap = 27


def _taps(kh, kw):
    return [(dc, dj) for dc in range(-(kh // 2), kh // 2 + 1) for dj in range(-(kw // 2), kw // 2 + 1)]


# --- dh: the model of tap_conv_dh_kernel ---------------------------------------

def dh_lanes(nt):
    """(CG, RG, WR): lanes are RG rows by CG channels (lane l: rows l % RG +
    RG i, channels l // RG + CG m, i, m < 4), and a warp owns WR = 4 * RG
    consecutive rows (of an item, or past it where the item is shorter)."""

    cg = nt // 4
    assert cuda_fold.f32_warp_rows(nt) == 4 * (32 // cg)
    return cg, 32 // cg, 4 * (32 // cg)


def stage_dh(buf, plan, seq, t0, p, kh, kw):
    """One item of ct into ``buf`` as a group stages it: its data columns
    NaN first (what a stale buffer may hold; the columns past Cout were
    zeroed once and no copy writes them), then the window or the kh bands,
    rows outside [0, Lp) left stale. Returns, per kernel row, the base such
    that the staged row of output row s and tap (dc, dj) is
    base[dc] + (s - t0) - dj."""

    Lp, cout = seq.shape
    rh, rw = kh // 2, kw // 2
    buf[:, :cout] = np.nan

    def put(b_row, g0, n):
        for r in range(n):
            if 0 <= g0 + r < Lp:
                buf[b_row + r, :cout] = seq[g0 + r]

    if plan.band:
        band_rows = plan.rt + kw - 1
        for s in range(kh):
            put(s * band_rows, t0 - (s - rh) * p - rw, band_rows)
        return [s * band_rows + rw for s in range(kh)]
    padw = rh * p + rw
    w0 = max(0, t0 - padw)
    n = min(Lp, t0 + plan.rt + padw) - w0
    assert n <= plan.buf_rows
    put(0, w0, n)
    return [t0 - w0 - (s - rh) * p for s in range(kh)]


def staged_w(w, n0, nt, kh, kw):
    """W's tile of input channels [n0, n0 + nt) as a block stages it: [tap,
    nt, f32_stride(Cout)] rows of co, zero past Cout, NaN in the rows past
    Cin (no copy lands there)."""

    cin, cout = w.shape[2:]
    w_s = np.full((kh * kw, nt, cuda_fold.f32_stride(cout)), np.nan, np.float32)
    w_s[:, :, cout:] = 0.0
    for i, (dc, dj) in enumerate(_taps(kh, kw)):
        n = min(nt, cin - n0)
        w_s[i, :n, :cout] = w[dc + kh // 2, dj + kw // 2, n0:n0 + n]
    return w_s


def dh_warp(plan, warp):
    """(group, row tile) of a warp: warp = wt * groups + (g + wt) % groups."""

    wt = warp // plan.groups
    return (warp % plan.groups - wt) % plan.groups, wt


def model_dh(ct, w, periods, cycles, kh, kw, p_max, plan=None):
    """dh as the kernel computes it: tile, chunk, group, item, warp, tap."""

    K, B, Lp, cout = ct.shape
    cin = w.shape[2]
    plan = plan or cuda_fold.dh_f32_plan(K, B, Lp, cin, cout, kh, kw, p_max)
    CG, RG, WR = dh_lanes(plan.nt)
    rt, tpi = plan.rt, max(1, plan.rt // WR)
    assert plan.warps == plan.groups * tpi
    warps = [dh_warp(plan, w) for w in range(plan.warps)]
    assert sorted(warps) == [(g, wt) for g in range(plan.groups) for wt in range(tpi)]
    cout4 = -(-cout // 4) * 4
    n_rt = plan.lp_pad // rt
    dh = np.full((K, B, Lp, cin), np.nan, np.float32)
    written = np.zeros((K, B, Lp, cin), int)
    for tile in range(plan.tiles):
        n0 = tile * plan.nt
        w_s = staged_w(w, n0, plan.nt, kh, kw)
        w_tap = w_s[:, :, :cout4].transpose(0, 2, 1)  # [tap, co, ci]: a lane reads rows ci
        for chunk in range(plan.chunks):
            i0 = chunk * plan.per_chunk
            n_items = min(plan.per_chunk, K * B * n_rt - i0)
            assert n_items >= 1
            for g in range(plan.groups):
                buf = np.zeros((plan.buf_rows, plan.sc), np.float32)  # the columns past Cout: 0
                for item in range(i0 + g, i0 + n_items, plan.groups):
                    k, b, t0 = item % K, item // K // n_rt, (item // K % n_rt) * rt
                    p = min(max(int(periods[k]), 1), p_max)
                    total = int(cycles[k]) * p
                    base = stage_dh(buf, plan, ct[k, b], t0, p, kh, kw)
                    end = min(t0 + rt, total)  # rows past the item or the fold: all taps masked
                    for _, wt in [gw for gw in warps if gw[0] == g]:
                        s = t0 + wt * WR + np.arange(WR)
                        acc = np.zeros((WR, plan.nt), np.float32)
                        for i, (dc, dj) in enumerate(_taps(kh, kw)):
                            v = ((s < end) & (s % p - dj >= 0) & (s % p - dj < p)
                                 & (s - dc * p - dj >= 0) & (s - dc * p - dj < Lp))
                            if not v.any():  # the warp vote: every row masked
                                continue
                            src = base[dc + kh // 2] + s - t0 - dj
                            assert (src[v] >= 0).all() and (src[v] < plan.buf_rows).all()
                            # a masked lane reads the zero row; nothing is multiplied by a mask
                            a = np.where(v[:, None], buf[np.where(v, src, 0), :cout4], 0.0)
                            acc += a @ w_tap[i]  # column c: the lane with cg = c % CG, m = c // CG
                        keep = s < min(t0 + rt, Lp)
                        cols = n0 + np.arange(plan.nt)
                        on = cols < cin
                        rows = s[keep]
                        dh[k, b, rows[:, None], cols[on][None, :]] = acc[keep][:, on]
                        written[k, b, rows[:, None], cols[on][None, :]] += 1
    assert (written == 1).all()  # every output once, no scratch and no reduction
    return dh, plan


# --- dW: the model of tap_conv_dw_kernel -----------------------------------------

def model_dw(h, ct, periods, cycles, kh, kw, plan=None):
    """dW as the kernel computes it: pass 1 per block and kernel row, pass 2
    over the chunks in chunk order."""

    K, B, Lp, cin = h.shape
    cout = ct.shape[-1]
    plan = plan or cuda_fold.dw_f32_plan(K, B, Lp, cin, cout, kh, kw)
    rh, rw = kh // 2, kw // 2
    co_tiles = -(-cout // TILE)
    n_rt = -(-Lp // ROWS)
    band_rows = ROWS + plan.taps - 1
    partial = np.full((plan.chunks, kh, kw, cin, cout), np.nan, np.float32)
    for bx in range(plan.tiles * plan.tap_groups):
        tile, jg = bx % plan.tiles, bx // plan.tiles
        ci0, co0 = (tile // co_tiles) * TILE, (tile % co_tiles) * TILE
        nci, nco = min(TILE, cin - ci0), min(TILE, cout - co0)
        dj_lo = jg * plan.taps - rw
        for chunk in range(plan.chunks):
            k, c = divmod(chunk, plan.chunks_per_k)
            i0 = c * plan.per_chunk
            n_items = min(plan.per_chunk, B * n_rt - i0)
            assert n_items >= 1
            p, cyc = max(int(periods[k]), 1), int(cycles[k])
            acc = np.zeros((plan.taps, plan.splits, TILE, TILE), np.float32)
            rounds = -(-n_items // plan.splits)  # a round: one item a split
            for step in range(kh * rounds):
                dci, rnd = divmod(step, rounds)
                dc = dci - rh
                for split in range(plan.splits):
                    item = i0 + rnd * plan.splits + split
                    if item >= i0 + n_items:
                        continue  # a split with no item in the last round
                    b, t0 = item // n_rt, (item % n_rt) * ROWS
                    # the ring's buffer: every row stale (NaN) until a copy lands
                    ct_s = np.full((ROWS, TILE), np.nan, np.float32)
                    h_s = np.full((band_rows, TILE), np.nan, np.float32)
                    n = min(ROWS, Lp - t0)
                    ct_s[:n, :nco] = ct[k, b, t0:t0 + n, co0:co0 + nco]
                    g0 = t0 + dc * p + dj_lo
                    for r in range(band_rows):
                        if 0 <= g0 + r < Lp:
                            h_s[r, :nci] = h[k, b, g0 + r, ci0:ci0 + nci]
                    t = t0 + np.arange(ROWS)
                    for tap in range(plan.taps):
                        dj = jg * plan.taps + tap - rw
                        if dj + rw >= kw:
                            continue  # an idle warp of a last, smaller tap group
                        # the ballot: the same in every lane of the warp
                        valid = (t < Lp) & (t // p + dc >= 0) & (t // p + dc < cyc) \
                            & (t % p + dj >= 0) & (t % p + dj < p)
                        r = np.nonzero(valid)[0]
                        acc[tap, split] += h_s[r + dj - dj_lo].T @ ct_s[r]
                if rnd == rounds - 1:  # the kernel row's last round
                    for tap in range(plan.taps):
                        dji = jg * plan.taps + tap
                        if dji >= kw:
                            continue
                        tot = acc[tap, 0].copy()
                        for o in range(1, plan.splits):  # in split order
                            tot += acc[tap, o]
                        partial[chunk, dci, dji, ci0:ci0 + nci, co0:co0 + nco] = tot[:nci, :nco]
                    acc[:] = 0.0
    assert not np.isnan(partial).any()  # every chunk writes every element once, from staged rows
    dw = np.zeros((kh, kw, cin, cout), np.float32)
    for chunk in range(plan.chunks):
        dw += partial[chunk]
    return dw, plan


# --- inputs and references ---------------------------------------------------------

def _inputs(seed, K, B, Lp, cin, cout, kh, kw):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((K, B, Lp, cin)).astype(np.float32)
    ct = rng.standard_normal((K, B, Lp, cout)).astype(np.float32)  # over all Lp rows
    w = (rng.standard_normal((kh, kw, cin, cout)) * 0.3).astype(np.float32)
    return h, ct, w


def _references(h, ct, w, periods, Lc, kh, kw, pallas=False, monkeypatch=None):
    """(geometry, plain dh, plain dW, JAX dh, JAX dW[, Pallas dh])."""

    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), Lc, Lc - 1)
    plain_dh = fold.tap_conv_dh(torch.from_numpy(ct), geom, torch.from_numpy(w), kh, kw).numpy()
    plain_dw = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct), kh, kw).numpy()
    jg = jfold.make_geometry(jnp.asarray(periods, jnp.int32), Lc, p_cap=Lc - 1)
    res = (jnp.asarray(h), jg.periods, jg.cycles, jg.col, jg.row, jnp.asarray(w))
    jdh, _, _, _, _, jdw, _ = jfold._tap_conv_bwd(kh, kw, jg.Lp, Lc, res, jnp.asarray(ct))
    out = [geom, plain_dh, plain_dw, np.asarray(jdh), np.asarray(jdw)]
    if pallas:  # the Pallas backward runs the kernel with sign=-1
        monkeypatch.setenv("FLOW_TIMESNET_PALLAS_BWD", "1")
        bias = jnp.zeros((w.shape[3],), jnp.float32)
        _, vjp = jax.vjp(lambda x: tap_conv_pallas(x, jg, jnp.asarray(w), bias, kh, kw,
                                                   interpret=True), jnp.asarray(h))
        out.append(np.asarray(vjp(jnp.asarray(ct))[0]))
    return out


def _assert_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=name)


def _check(seed, periods, kh, kw, cin=32, cout=32, B=5, Lc=L, pallas=False, monkeypatch=None,
           kinds=("dh", "dw")):
    Lp = 2 * Lc - 1
    h, ct, w = _inputs(seed, len(periods), B, Lp, cin, cout, kh, kw)
    refs = _references(h, ct, w, periods, Lc, kh, kw, pallas, monkeypatch)
    geom = refs[0]
    per, cyc = geom.periods.numpy(), geom.cycles.numpy()
    plans = {}
    if "dh" in kinds:
        got, plans["dh"] = model_dh(ct, w, per, cyc, kh, kw, Lc - 1)
        _assert_close(got, refs[1], "dh: plain")
        _assert_close(got, refs[3], "dh: JAX")
        if pallas:
            _assert_close(got, refs[5], "dh: Pallas (interpret)")
        for k, total in enumerate(geom.total.tolist()):  # exactly 0 at and past the fold
            assert not got[k, :, total:].any()
    if "dw" in kinds:
        got, plans["dw"] = model_dw(h, ct, per, cyc, kh, kw)
        _assert_close(got, refs[2], "dW: plain")
        _assert_close(got, refs[4], "dW: JAX")
    return plans


# --- the models against the references ----------------------------------------------

@pytest.mark.parametrize("p", [1, 7, 27])
@pytest.mark.parametrize("kh,kw", SIZES)
def test_models_match_plain_and_jax(kh, kw, p, monkeypatch):
    """The flagship fold (L=28, Lp=55, 32 channels) at B=5, the second
    candidate 27 (14 beside 27); the Pallas sign=-1 kernel at p = 7."""

    _check(kh * 100 + p, [p, 27 if p != 27 else 14], kh, kw, pallas=p == 7,
           monkeypatch=monkeypatch)


@pytest.mark.parametrize("cin,cout", [(16, 48), (48, 16), (64, 32), (64, 64), (24, 40), (18, 30)])
@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7)])
def test_models_over_channels(kh, kw, cin, cout):
    """Channels 16-64, Cin != Cout both ways, Cin = 64 at 7x7 (which the first
    float32 dW refused), and widths that are not a multiple of 4 (4-byte
    copies on the card): several channel tiles, tiles past the channels."""

    plans = _check(cin * 7 + cout + kh, [4, 27], kh, kw, cin, cout, B=3)
    assert plans["dh"].tiles * plans["dh"].nt >= cin
    assert plans["dw"].tiles == -(-cin // TILE) * -(-cout // TILE)


@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_models_take_the_long_context_shape(kh, kw):
    """configs/long_context.yaml's fold: L=512 (Lp=1023, p_cap 511), K=4,
    mid 32, one series: 16 items a sequence, dh staged as kh bands."""

    plans = _check(kh, [511, 168, 24, 7], kh, kw, B=1, Lc=512)
    assert (plans["dh"].band, plans["dh"].rt, plans["dh"].lp_pad) == (1, 64, 1024)
    assert plans["dh"].buf_rows == kh * (ROWS + kw - 1) < min(1023, ROWS + 2 * plans["dh"].pad)


def test_dh_model_takes_short_items_where_64_rows_do_not_fit():
    """Mid 61 at 7x7 and L=245 (Lp=490): W's 8-channel tile and one 64-row
    item (490 rows either way) pass 227 KB, so an item is 32 rows staged as
    bands, and a warp's 64 rows reach past it."""

    plan = cuda_fold.dh_f32_plan(2, 16, 490, 61, 61, 7, 7, 245)
    assert (plan.nt, plan.rt, plan.band) == (8, 32, 1) and plan.lp_pad == 512
    kh = kw = 7
    h, ct, w = _inputs(13, 2, 1, 489, 61, 61, kh, kw)
    geom, plain_dh = _references(h, ct, w, [245, 30], 245, kh, kw)[:2]
    got, _ = model_dh(ct, w, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, 244)
    _assert_close(got, plain_dh, "dh, 32-row items")


@settings(max_examples=12, deadline=None)
@given(st.data())
def test_models_match_plain_over_periods_and_sizes(data):
    Lc = data.draw(st.integers(4, 40), label="L")
    kh = data.draw(st.sampled_from([1, 3, 5, 7]), label="kh")
    kw = data.draw(st.sampled_from([1, 3, 5, 7]), label="kw")
    periods = data.draw(st.lists(st.integers(1, Lc - 1), min_size=1, max_size=3), label="periods")
    cin = data.draw(st.sampled_from([4, 16, 32, 40]), label="cin")
    cout = data.draw(st.sampled_from([3, 8, 32, 36]), label="cout")
    B = data.draw(st.integers(1, 3), label="B")
    _check(data.draw(st.integers(0, 2**31 - 1), label="seed"), periods, kh, kw, cin, cout, B=B,
           Lc=Lc)


def test_groups_take_several_items():
    """A chunk of more items than groups: each group stages its items one
    after another into one buffer (the long-context plans do this)."""

    kh = kw = 3
    h, ct, w = _inputs(11, 2, 6, 2 * L - 1, 32, 32, kh, kw)
    geom, plain_dh, plain_dw = _references(h, ct, w, [7, 27], L, kh, kw)[:3]
    per, cyc = geom.periods.numpy(), geom.cycles.numpy()
    # chunks of 4 items over 3 groups: group 0 takes items 0 and 3 of each
    plan = cuda_fold.dh_f32_plan(2, 6, 55, 32, 32, kh, kw, L - 1)._replace(
        per_chunk=4, chunks=3, groups=3, warps=12)
    got, _ = model_dh(ct, w, per, cyc, kh, kw, L - 1, plan=plan)
    _assert_close(got, plain_dh, "dh, several items a group")
    plan_w = cuda_fold.dw_f32_plan(2, 6, 55, 32, 32, kh, kw)._replace(
        per_chunk=4, chunks_per_k=2, chunks=4)
    got, _ = model_dw(h, ct, per, cyc, kh, kw, plan=plan_w)
    _assert_close(got, plain_dw, "dW, several items a chunk")


def test_dw_never_reads_h_past_the_fold():
    """A valid tap of dW reads h inside [0, total): NaN in the rows [total,
    Lp) of h (which may hold anything) reaches no element of dW, where the
    plain version's multiply by the mask would spread it."""

    kh = kw = 7
    h, ct, w = _inputs(4, 2, 3, 55, 32, 32, kh, kw)
    geom = fold.make_geometry(torch.tensor([7, 27], dtype=torch.int32), L, L - 1)
    poisoned = h.copy()
    for k, total in enumerate(geom.total.tolist()):
        poisoned[k, :, total:] = np.nan
    got, _ = model_dw(poisoned, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw)
    zeroed = np.nan_to_num(poisoned, nan=0.0)
    want = fold.tap_weight_grad(torch.from_numpy(zeroed), geom, torch.from_numpy(ct), kh, kw)
    assert np.isfinite(got).all()
    _assert_close(got, want.numpy(), "dW, h NaN past the fold")


# --- lanes and shared-memory loads ---------------------------------------------------

@pytest.mark.parametrize("nt", cuda_fold.DH_TILES)
def test_dh_lanes_cover_the_warp_tile_and_load_without_conflicts(nt):
    """Lane l has rg = l % RG and cg = l // RG: rows rg + RG * i and input
    channels cg + CG * m (i, m < 4) cover the warp's WR x nt tile once; the
    ct float4s of one i and the W float4s of one m each take the fewest
    wavefronts their bytes allow."""

    CG, RG, WR = dh_lanes(nt)
    seen = np.zeros((WR, nt), int)
    for lane in range(32):
        rg, cg = lane % RG, lane // RG
        for i in range(4):
            for m in range(4):
                seen[rg + RG * i, cg + CG * m] += 1
    assert (seen == 1).all()
    for cout in (8, 30, 32, 48, 64):
        sc = cuda_fold.f32_stride(cout)
        for i in range(4):  # ct: lane's row rg + RG i at co, 4 floats
            for row0 in (0, 5, 13):
                addr = [((row0 + lane % RG + RG * i) * sc) // 4 for lane in range(32)]
                assert float4_wavefronts(addr) == -(-len(set(addr)) // 8)
        for tap in (0, 3):  # W: the float4 of (tap, ci = cg + CG m) at co
            for m in range(4):
                addr = [((tap * nt + lane // RG + CG * m) * sc + 8) // 4 for lane in range(32)]
                assert float4_wavefronts(addr) == 1


@pytest.mark.parametrize("groups,tpi", [(4, 4), (3, 4), (8, 2), (5, 2), (15, 1), (1, 4)])
def test_dh_warps_spread_each_group_and_row_tile_over_the_schedulers(groups, tpi):
    """Warps go to the 4 schedulers by warp % 4. With the flagship's groups
    of 4 (or 8 of 2) each group's warps, and each row tile's warps, land on
    distinct schedulers, so the row tiles a small period leaves live (the
    first of each item) are not all on one scheduler."""

    plan = cuda_fold.DhF32Plan(*([0] * 8), groups, groups * tpi, 0, 0, 0)
    where = {dh_warp(plan, w): w % 4 for w in range(groups * tpi)}
    assert sorted(where) == [(g, wt) for g in range(groups) for wt in range(tpi)]
    if groups % 4 == 0:
        for g in range(groups):
            assert len({where[g, wt] for wt in range(tpi)}) == tpi
        for wt in range(tpi):
            assert len({where[g, wt] for g in range(groups)}) == min(4, groups)


def test_dw_lanes_cover_the_warp_tile_and_load_without_conflicts():
    """Lane l owns ci 4 (l >> 2) .. + 3 and co 8 (l & 3) .. + 7 of the warp's
    32 x 32 tile, once each; a row's h float4 and its two ct float4s each
    take one wavefront."""

    seen = np.zeros((TILE, TILE), int)
    for lane in range(32):
        cg, og = lane >> 2, lane & 3
        seen[4 * cg:4 * cg + 4, 8 * og:8 * og + 8] += 1
    assert (seen == 1).all()
    r = 9
    assert float4_wavefronts([(r * TILE + 4 * (lane >> 2)) // 4 for lane in range(32)]) == 1
    for half in range(2):
        assert float4_wavefronts([(r * TILE + 8 * (lane & 3) + 4 * half) // 4 for lane in range(32)]) == 1


def test_row_stride_is_an_odd_number_of_float4s():
    for cols in range(1, 300):
        stride = cuda_fold.f32_stride(cols)
        assert stride % 4 == 0 and (stride // 4) % 2 == 1 and cols <= stride <= cols + 7
        assert len({(r * stride // 4) % 8 for r in range(8)}) == 8


# --- the plans -------------------------------------------------------------------------

@pytest.mark.parametrize("kh,nt,groups,per_chunk,chunks,smem", [
    (3, 32, 4, 4, 128, 73_296),
    (5, 32, 4, 4, 128, 147_024),
    (7, 16, 8, 8, 64, 176_400),
])
def test_dh_plan_at_the_training_shape(kh, nt, groups, per_chunk, chunks, smem):
    """K=2, B=256, Lp=55, 32 channels, p_cap 27: each sequence one item staged
    as one window of its 55 rows, 16 warps a block, each group one item, in
    128 blocks (one wave on 132 SMs), each chunk half of each candidate. At
    7x7 all of W (226 KB as staged) leaves no room for an item, so the tile
    is 16 channels."""

    plan = cuda_fold.dh_f32_plan(2, 256, 55, 32, 32, kh, kh, 27)
    assert (plan.nt, plan.groups, plan.per_chunk, plan.chunks, plan.smem) == (
        nt, groups, per_chunk, chunks, smem)
    assert (plan.lp_pad, plan.rt, plan.band, plan.buf_rows, plan.sc, plan.warps) == (
        64, 64, 0, 55, 36, 16)
    assert plan.per_chunk <= plan.groups and plan.chunks * plan.tiles == 128
    assert plan.smem == 4 * (kh * kh * nt + groups * 55 + 1) * 36


@pytest.mark.parametrize("kh,taps,splits,mb", [(3, 3, 4, 4.72), (5, 5, 3, 13.11), (7, 7, 2, 25.69)])
def test_dw_plan_at_the_training_shape(kh, taps, splits, mb):
    """One block an SM: 128 chunks of 4 sequences, every kernel row in every
    block, 12-15 warps (at most as many splits as a chunk has items); the
    scratch the wrapper allocates."""

    plan = cuda_fold.dw_f32_plan(2, 256, 55, 32, 32, kh, kh)
    assert (plan.tiles, plan.tap_groups, plan.taps, plan.splits) == (1, 1, taps, splits)
    assert (plan.chunks, plan.per_chunk, plan.chunks_per_k) == (128, 4, 64)
    assert plan.warps == taps * splits <= cuda_fold.F32_MAX_WARPS
    assert round(4 * plan.scratch_elems(kh, kh, 32, 32) / 1e6, 2) == mb
    # a ring of 2 rounds of an item a split (ct rows and h band), the splits' tiles
    assert plan.smem == 4 * (2 * splits * (128 + taps - 1) * 32 + (splits - 1) * taps * 1024)
    # kw = 1 would take 16 splits; the ring leaves room for 6
    assert cuda_fold.dw_f32_plan(2, 4096, 55, 32, 32, 1, 1).splits == 6


def test_plans_take_every_shape_the_first_float32_kernels_took():
    """Cin = Cout = C (the model's inception convs) at the shipped kernel
    sizes and any Lp = L + p_cap: every shape the first dh kernel took
    (4 (Lp C + kw C^2) <= 227 KB) and the first dW kernel took (C | 256,
    kw C <= 32 * 256 / C, 4 Lp 2C <= 227 KB) has a plan, and so does dW at
    Cin = 64, 7x7."""

    for kh, kw in [(3, 3), (5, 5), (7, 7), (1, 3)]:
        for c in list(range(1, 65)) + list(range(72, 257, 8)):
            for Lp in list(range(3, 120)) + list(range(120, 3000, 37)):
                p_max = max(1, Lp // 2)
                if 4 * (Lp * c + kw * c * c) <= cuda_fold.MAX_SMEM_BYTES and c <= 2048:
                    assert cuda_fold.dh_f32_plan(2, 16, Lp, c, c, kh, kw, p_max).smem <= \
                        cuda_fold.MAX_SMEM_BYTES
                if 256 % c == 0 and kw * c <= 32 * (256 // c) and 8 * Lp * c <= \
                        cuda_fold.MAX_SMEM_BYTES:
                    assert cuda_fold.dw_f32_plan(2, 16, Lp, c, c, kh, kw).smem <= \
                        cuda_fold.MAX_SMEM_BYTES
    assert cuda_fold.dw_f32_plan(2, 256, 55, 64, 64, 7, 7).tiles == 4


@pytest.mark.parametrize("name,shape,why", [
    ("dh", (2, 4, 55, 32, 32, 3, 4, 27), "kernel size odd"),
    ("dh", (2, 4, 55, 0, 32, 3, 3, 27), "positive"),
    ("dh", (2, 4, 55, 32, 32, 3, 3, 56), r"p_max must lie in \[1, Lp\]"),
    ("dh", (2, 4, 55, 32, 32, 3, 3, 0), r"p_max must lie in \[1, Lp\]"),
    ("dh", (2, 4, 55, 256, 256, 7, 7, 27), "more than 232448 bytes"),
    ("dw", (2, 4, 55, 32, 32, 4, 3), "kernel size odd"),
    ("dw", (2, 0, 55, 32, 32, 3, 3), "positive"),
])
def test_plans_refuse_what_the_kernels_cannot_take(name, shape, why):
    plan = cuda_fold.dh_f32_plan if name == "dh" else cuda_fold.dw_f32_plan
    with pytest.raises(RuntimeError, match=f"tap_conv_{name} launch failed with cudaError_t 1 .*{why}"):
        plan(*shape)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU ``TapConv`` computes dh and dW with the plain versions in
    float32: no kernel launch is counted on either route."""

    kh, kw, periods = 5, 5, [7, 27]
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    h, ct, w = _inputs(5, 2, 2, geom.Lp, 32, 32, kh, kw)
    counters = (cuda_fold.launches_dh, cuda_fold.launches_dw)
    before = [sum(c.values()) for c in counters]
    h_t = torch.from_numpy(h).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    out = cuda_fold.tap_conv(h_t, geom, w_t, torch.zeros(32), kh, kw)
    out.backward(torch.from_numpy(ct))
    want_dh = fold.tap_conv_dh(torch.from_numpy(ct), geom, torch.from_numpy(w), kh, kw)
    want_dw = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct), kh, kw)
    assert torch.equal(h_t.grad, want_dh) and torch.equal(w_t.grad, want_dw)
    assert [sum(c.values()) for c in counters] == before
