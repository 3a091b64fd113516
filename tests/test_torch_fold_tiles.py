"""The bf16 tensor-core forward and dh template's decomposition, modelled in
numpy on the CPU.

``csrc/tap_conv_mma.cu::tap_conv_mma_kernel`` runs only on the card. These
tests model how it cuts the work, for both signs (+1: the forward, -1: the dh
adjoint), and hold the model against the port's plain ``ops/fold.py::tap_conv``
/ ``tap_conv_dh``, the JAX package's ``tap_conv`` and its adjoint (the XLA
custom VJP), and its Pallas kernel in interpret mode for both signs:

- the launch plan of ``ops/cuda_fold.py::fold_mma_plan``, which the kernel's
  C plan mirrors, at the flagship shapes and at the channel edges the
  CUDA-core kernels take, and its refusals;
- the ldmatrix lane addresses of A (the shifted X rows) and of B (W staged
  as [ci][co] rows: ldmatrix.trans for the forward, plain for dh) against
  the mma.sync m16n8k16 fragment layout;
- each item staged as one window or as kh bands of rows, rows outside
  [0, Lp) filled (here with NaN, which the kernel's zero fill only makes
  safer), every shifted read in bounds, never-staged rows NaN, the per-lane
  AND masks of A's rows g and g + 8, the warp-level tap skip, K-aligned
  chunks, groups of warps and the channel tile.

The inputs are bf16 values held in float32, as the kernel sees them: every
product is exact, so the model differs from the references only in the order
of the float32 sums. Within 2e-5 of the largest |out|.
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
from flow_timesnet_tpu_torch.ops import _build, cuda_fold, fold  # noqa: E402
from port_helpers import a_fragment_rows, a_matrix, b_matrix, ldmatrix  # noqa: E402

ROWS = cuda_fold.MMA_ROWS
TOL = 2e-5
SIZES = [(3, 3), (5, 5), (7, 7), (1, 3)]
L = 28  # the flagship's window: Lp = 55, p_cap = 27


# --- the kernel's lane arithmetic, as tap_conv_mma_kernel writes it ----------

def a_address(lane):
    """(row within the m-tile, channel offset) lane names for A's ldmatrix."""

    return (lane & 7) + ((lane >> 3) & 1) * 8, (lane >> 4) * 8


def b_address(sign, lane):
    """(row, column) of W's staged slice that lane names for B's ldmatrix:
    forward rows are k (ci), dh rows are n (ci)."""

    if sign > 0:
        return (lane & 7) + ((lane >> 3) & 1) * 8, (lane >> 4) * 8
    return (lane & 7) + (lane >> 4) * 8, ((lane >> 3) & 1) * 8


def tap_valid(sign, t, dc, dj, p, cyc, Lp):
    """The predicate a lane evaluates for its output row t and tap (dc, dj)."""

    if sign > 0:
        return t < Lp and 0 <= t // p + dc < cyc and 0 <= t % p + dj < p
    return t < cyc * p and 0 <= t % p - dj < p and 0 <= t - dc * p - dj < Lp


_VALIDITY = {}


def item_validity(sign, rt, t0, p, cyc, Lp, kh, kw):
    """Per (tap, row) validity of an item built lane by lane, as each lane
    holds rows g and g + 8 of its warp's m-tile (every lane that holds a row
    agrees on it), and per (m-tile, tap) the warp's skip: no lane's row
    valid. ([kh * kw, rt] bool, [rt // 16, kh * kw] bool)."""

    key = (sign, rt, t0, p, cyc, Lp, kh, kw)
    if key in _VALIDITY:
        return _VALIDITY[key]
    taps = [(dc, dj) for dc in range(-(kh // 2), kh // 2 + 1) for dj in range(-(kw // 2), kw // 2 + 1)]
    valid = np.full((len(taps), rt), -1, np.int8)
    skip = np.zeros((rt // ROWS, len(taps)), bool)
    for mt in range(rt // ROWS):
        for i, (dc, dj) in enumerate(taps):
            vote = False
            for lane in range(32):
                for row in set(a_fragment_rows(lane)):
                    v = tap_valid(sign, t0 + mt * ROWS + row, dc, dj, p, cyc, Lp)
                    assert valid[i, mt * ROWS + row] in (-1, v)
                    valid[i, mt * ROWS + row] = v
                    vote |= v
            skip[mt, i] = not vote
    assert (valid >= 0).all()  # every row of every m-tile is some lane's
    _VALIDITY[key] = (valid.astype(bool), skip)
    return _VALIDITY[key]


def stage(buf, plan, xs, sign, t0, p, kh, kw, fill):
    """One item into ``buf`` as the kernel stages it: every row NaN first
    (what a stale buffer may hold), then the window or the kh bands, rows
    outside [0, Lp) set to ``fill`` (the kernel: 0). Returns the base row of
    each kernel row dc: the staged row of output row t0 + r and tap (dc, dj)
    is base[dc] + r + sign * dj."""

    Lp = xs.shape[0]
    rh, rw = kh // 2, kw // 2
    buf[:] = np.nan

    def put(b_row, g_row, n):
        for r in range(n):
            g = g_row + r
            buf[b_row + r] = xs[g] if 0 <= g < Lp else fill

    if plan.band:
        band_rows = plan.rt + kw - 1
        for s in range(kh):
            put(s * band_rows, t0 + sign * (s - rh) * p - rw, band_rows)
        return [s * band_rows + rw for s in range(kh)]
    padw = rh * p + rw
    put(plan.pad - padw, t0 - padw, plan.rt + 2 * padw)
    return [plan.pad + sign * (s - rh) * p for s in range(kh)]


def model_fold(sign, x, w, bias, periods, cycles, kh, kw, p_max, fill=np.nan):
    """The forward (sign +1: x = h, + bias) or dh (sign -1: x = ct) as the
    kernel computes it, block by block: tile, chunk, group, item, warp, tap."""

    K, B, Lp, cx = x.shape
    cin, cout = w.shape[2:]
    plan = cuda_fold.fold_mma_plan(sign, K, B, Lp, cin, cout, kh, kw, p_max)
    cy = cout if sign > 0 else cin
    rt, n_rt = plan.rt, plan.lp_pad // plan.rt
    out = np.full((K, B, Lp, cy), np.nan, np.float32)
    written = np.zeros((K, B, Lp, cy), int)
    taps = [(dc, dj) for dc in range(-(kh // 2), kh // 2 + 1) for dj in range(-(kw // 2), kw // 2 + 1)]
    for tile in range(plan.tiles):
        n0 = tile * plan.nt
        ncols = min(plan.nt, cy - n0)
        # the staged slice of each tap as B (k, n), NaN past the channels: no mma reads it
        w_b = np.full((len(taps), cx, plan.nt), np.nan, np.float32)
        for i, (dc, dj) in enumerate(taps):
            wt = w[dc + kh // 2, dj + kw // 2]  # [Cin, Cout]
            w_b[i, :, :ncols] = (wt[:, n0:n0 + ncols] if sign > 0 else wt[n0:n0 + ncols].T)
        for chunk in range(plan.chunks):
            k, c = divmod(chunk, plan.chunks_per_k)  # one candidate per chunk
            i0 = c * plan.per_chunk
            n_items = min(plan.per_chunk, B * n_rt - i0)
            assert n_items >= 1
            p, cyc = min(max(int(periods[k]), 1), p_max), int(cycles[k])
            for g in range(plan.groups):
                bufs = np.empty((plan.stages, plan.buf_rows, cx), np.float32)
                for j, item in enumerate(range(i0 + g, i0 + n_items, plan.groups)):
                    b, t0 = item // n_rt, (item % n_rt) * rt
                    buf = bufs[j % plan.stages]
                    base = stage(buf, plan, x[k, b], sign, t0, p, kh, kw, fill)
                    valid, skip = item_validity(sign, rt, t0, p, cyc, Lp, kh, kw)
                    for mt in range(rt // ROWS):
                        acc = np.zeros((ROWS, ncols), np.float32)
                        for i, (dc, dj) in enumerate(taps):
                            if skip[mt, i]:
                                continue
                            rows = base[dc + kh // 2] + mt * ROWS + np.arange(ROWS) + sign * dj
                            assert 0 <= rows.min() and rows.max() < plan.buf_rows
                            a = np.where(valid[i, mt * ROWS:(mt + 1) * ROWS, None], buf[rows], 0.0)
                            acc += a @ w_b[i, :, :ncols]
                        t = t0 + mt * ROWS + np.arange(ROWS)
                        keep = t < Lp
                        res = acc + (bias[n0:n0 + ncols] if sign > 0 else 0.0)
                        out[k, b, t[keep], n0:n0 + ncols] = res[keep]
                        written[k, b, t[keep], n0:n0 + ncols] += 1
    assert (written == 1).all()  # every output once, no scratch and no reduction
    return out, plan


# --- inputs and references ---------------------------------------------------

def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(seed, K, B, Lp, cin, cout, kh, kw):
    """h [K, B, Lp, Cin], ct [K, B, Lp, Cout], W and bias: bf16 values in float32."""

    rng = np.random.default_rng(seed)
    h = _bf16(rng.standard_normal((K, B, Lp, cin)).astype(np.float32))
    ct = _bf16(rng.standard_normal((K, B, Lp, cout)).astype(np.float32))
    w = _bf16((rng.standard_normal((kh, kw, cin, cout)) * 0.3).astype(np.float32))
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return h, ct, w, bias


def _plain(sign, x, w, bias, periods, Lc, kh, kw):
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), Lc, Lc - 1)
    args = (torch.from_numpy(x), geom, torch.from_numpy(w))
    if sign > 0:
        return geom, fold.tap_conv(*args, torch.from_numpy(bias), kh, kw).numpy()
    return geom, fold.tap_conv_dh(*args, kh, kw).numpy()


def _jax(sign, x, w, bias, periods, Lc, kh, kw, pallas=False, monkeypatch=None):
    """The JAX package's tap_conv (sign +1) or its adjoint through jax.vjp
    (sign -1); ``pallas``: through tap_conv_pallas in interpret mode, whose
    backward runs the Pallas kernel with sign=-1 (FLOW_TIMESNET_PALLAS_BWD)."""

    jg = jfold.make_geometry(jnp.asarray(periods, jnp.int32), Lc, p_cap=Lc - 1)
    if pallas:
        monkeypatch.setenv("FLOW_TIMESNET_PALLAS_BWD", "1")

    def conv(h_):
        if pallas:
            return tap_conv_pallas(h_, jg, jnp.asarray(w), jnp.asarray(bias), kh, kw, interpret=True)
        return jfold.tap_conv(h_, jg, jnp.asarray(w), jnp.asarray(bias), kh, kw)

    if sign > 0:
        return np.asarray(conv(jnp.asarray(x)))
    K, B, Lp, _ = x.shape
    h0 = jnp.zeros((K, B, Lp, w.shape[2]), jnp.float32)
    _, vjp = jax.vjp(conv, h0)
    return np.asarray(vjp(jnp.asarray(x))[0])


def _assert_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=name)


def _check(sign, seed, periods, kh, kw, cin=32, cout=32, B=5, Lc=L, jax_too=True,
           pallas=False, monkeypatch=None):
    Lp = 2 * Lc - 1
    h, ct, w, bias = _inputs(seed, len(periods), B, Lp, cin, cout, kh, kw)
    x = h if sign > 0 else ct
    geom, plain = _plain(sign, x, w, bias, periods, Lc, kh, kw)
    got, plan = model_fold(sign, x, w, bias, geom.periods.numpy(), geom.cycles.numpy(), kh, kw,
                           Lc - 1)
    _assert_close(got, plain, "plain")
    if sign < 0:  # rows at and past each fold extent come out exactly 0
        for k, total in enumerate(geom.total.tolist()):
            assert not got[k, :, total:].any()
    if jax_too:
        _assert_close(got, _jax(sign, x, w, bias, periods, Lc, kh, kw), "JAX")
    if pallas:
        _assert_close(got, _jax(sign, x, w, bias, periods, Lc, kh, kw, True, monkeypatch),
                      "Pallas (interpret)")
    return got, plan


# --- the model against the references ----------------------------------------

@pytest.mark.parametrize("p", [1, 4, 7, 14, 27])
@pytest.mark.parametrize("kh,kw", SIZES)
@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_model_matches_plain_and_jax(sign, kh, kw, p, monkeypatch):
    """The flagship fold (L=28, Lp=55, 32 channels) at B=5 with two
    candidates, the second one 27 (14 beside 27): each chunk holds one
    period. The Pallas kernel, in interpret mode, at p = 7."""

    periods = [p, 27 if p != 27 else 14]
    _check(sign, kh * 100 + p, periods, kh, kw, pallas=p == 7, monkeypatch=monkeypatch)


@pytest.mark.parametrize("cin,cout", [(16, 16), (48, 32), (32, 48), (64, 64)])
@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7)])
@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_model_over_channels(sign, kh, kw, cin, cout):
    """Channel counts that leave part of a 32-column tile past the output's
    channels (48) or take several tiles (64), Cin != Cout in both orders."""

    _, plan = _check(sign, cin + cout + kh, [4, 27], kh, kw, cin, cout, B=3)
    cy = cout if sign > 0 else cin
    assert plan.tiles == -(-cy // plan.nt)


@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_model_long_sequences_stage_bands(sign, kh, kw):
    """L=100 (Lp=199, p_cap 99): an item is a 64-row tile of a sequence and is
    staged as kh bands, not one window of 64 + 2 * pad rows."""

    _, plan = _check(sign, 7 + kh, [99, 13], kh, kw, B=2, Lc=100)
    assert plan.band == 1 and plan.rt == 64 and plan.lp_pad == 256
    assert plan.buf_rows == kh * (64 + kw - 1) < 64 + 2 * plan.pad


@settings(max_examples=12, deadline=None)
@given(st.data())
def test_model_matches_plain_over_periods_and_sizes(data):
    Lc = data.draw(st.integers(4, 30), label="L")
    kh = data.draw(st.sampled_from([1, 3, 5, 7]), label="kh")
    kw = data.draw(st.sampled_from([1, 3, 5, 7]), label="kw")
    periods = data.draw(st.lists(st.integers(1, Lc - 1), min_size=1, max_size=3), label="periods")
    cin = data.draw(st.sampled_from([16, 32, 48]), label="cin")
    cout = data.draw(st.sampled_from([16, 32, 48]), label="cout")
    B = data.draw(st.integers(1, 3), label="B")
    sign = data.draw(st.sampled_from([1, -1]), label="sign")
    _check(sign, data.draw(st.integers(0, 2**31 - 1), label="seed"), periods, kh, kw, cin, cout,
           B=B, Lc=Lc)


@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_zero_fill_and_nan_fill_agree(sign):
    """The masks alone decide every output: rows outside [0, Lp) staged as 0
    (the kernel) or as NaN give the same bits."""

    h, ct, w, bias = _inputs(3, 2, 3, 55, 32, 32, 5, 5)
    x = h if sign > 0 else ct
    geom = fold.make_geometry(torch.tensor([7, 27], dtype=torch.int32), L, L - 1)
    per, cyc = geom.periods.numpy(), geom.cycles.numpy()
    zero, _ = model_fold(sign, x, w, bias, per, cyc, 5, 5, L - 1, fill=0.0)
    nan, _ = model_fold(sign, x, w, bias, per, cyc, 5, 5, L - 1, fill=np.nan)
    np.testing.assert_array_equal(zero, nan)


def test_forward_never_reads_rows_past_the_fold():
    """A valid forward tap reads h only inside [0, total): NaN in the rows
    [total, Lp) (which the next conv reads as grid cells, and which may hold
    anything) reaches no output, where the plain version's multiply by the
    mask would spread it."""

    h, _, w, bias = _inputs(4, 2, 3, 55, 32, 32, 7, 7)
    geom = fold.make_geometry(torch.tensor([7, 27], dtype=torch.int32), L, L - 1)
    poisoned, zeroed = h.copy(), h.copy()
    for k, total in enumerate(geom.total.tolist()):
        poisoned[k, :, total:] = np.nan
        zeroed[k, :, total:] = 0.0
    got, _ = model_fold(1, poisoned, w, bias, geom.periods.numpy(), geom.cycles.numpy(), 7, 7,
                        L - 1)
    _, want = _plain(1, zeroed, w, bias, [7, 27], L, 7, 7)
    assert np.isfinite(got).all()
    _assert_close(got, want, "plain, rows past the fold zeroed")


# --- fragments ---------------------------------------------------------------

@pytest.mark.parametrize("nt", [32, 16, 8])
@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_fragment_addresses_load_the_mma_operands(sign, nt):
    """ldmatrix at the kernel's lane addresses yields A = the staged X rows
    and B = W[ci][co] (forward: k = ci, n = co, ldmatrix.trans) or W^T (dh:
    k = co, n = ci, plain ldmatrix) in the m16n8k16 layout; x2 (nt = 8) takes
    the first two matrices. The epilogue's accumulator layout covers each
    (row, column) of a warp's 16 x nt tile once."""

    rng = np.random.default_rng(nt)
    cx, r0, ks = 48, 5, 2  # a shifted m-tile start and the last k-step
    sx = cuda_fold.row_stride(cx)
    x_s = rng.standard_normal((40, sx)).astype(np.float32)
    a = ldmatrix(x_s, [(r0 + a_address(l)[0], ks * 16 + a_address(l)[1]) for l in range(32)])
    np.testing.assert_array_equal(a_matrix(a), x_s[r0:r0 + 16, ks * 16:ks * 16 + 16])
    for lane in range(32):  # the rows the lane's masks are built for
        for reg, row in enumerate(a_fragment_rows(lane)):
            assert a[lane, reg, 0] == x_s[r0 + row, ks * 16 + 2 * (lane % 4) + 8 * (reg // 2)]

    if sign > 0:  # the slice's rows are ci (k), its columns the tile's co (n)
        w_s = rng.standard_normal((cx, cuda_fold.row_stride(nt))).astype(np.float32)
        want = w_s[:cx, :nt]  # B (k, n)
    else:  # rows the tile's ci (n), columns co (k)
        w_s = rng.standard_normal((nt, cuda_fold.row_stride(cx))).astype(np.float32)
        want = w_s[:nt, :cx].T
    n = 2 if nt == 8 else 4
    for np_ in range(max(1, nt // 16)):
        addr = []
        for lane in range(32):
            r, c = b_address(sign, lane)
            if sign > 0:
                addr.append((ks * 16 + r, 16 * np_ + c))
            else:
                addr.append((16 * np_ + r, ks * 16 + c) if lane < 8 * n else (0, 0))
        frag = ldmatrix(w_s, addr, trans=sign > 0, n=n)
        for half in range(n // 2):  # registers (0, 1) hold n-tile 2 np_, (2, 3) 2 np_ + 1
            nt0 = 16 * np_ + 8 * half
            np.testing.assert_array_equal(b_matrix(frag[:, 2 * half:2 * half + 2]),
                                          want[ks * 16:ks * 16 + 16, nt0:nt0 + 8])

    seen = np.zeros((16, nt), int)  # the epilogue: (row, column) of accumulator e of n-tile j
    for lane in range(32):
        for j in range(nt // 8):
            for e in range(4):
                seen[lane // 4 + 8 * (e // 2), 8 * j + 2 * (lane % 4) + e % 2] += 1
    assert (seen == 1).all()


def test_row_stride_is_conflict_free():
    """8 consecutive staged rows start in 8 distinct 16-byte bank groups at
    every width a plan stages, and the pad is the least that does it."""

    for cols in range(8, 264, 8):
        stride = cuda_fold.row_stride(cols)
        assert stride in (cols, cols + 8)
        groups = {(r * stride * 2 // 16) % 8 for r in range(8)}
        assert len(groups) == 8, cols
        if stride == cols + 8:
            assert len({(r * cols * 2 // 16) % 8 for r in range(8)}) < 8


# --- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("sign,kh,B,per_chunk,pad,smem", [
    (1, 3, 192, 3, 28, 61_440),
    (1, 5, 192, 3, 56, 120_320),
    (1, 7, 192, 3, 84, 199_680),
    (-1, 3, 256, 4, 28, 61_440),
    (-1, 5, 256, 4, 56, 120_320),
    (-1, 7, 256, 4, 84, 199_680),
])
def test_plan_at_the_flagship_shapes(sign, kh, B, per_chunk, pad, smem):
    """The serving forward (B=192) and the training dh (B=256), K=2, Lp=55,
    32 channels, p_cap 27: one 64-row item a sequence staged as one window,
    all of W in one tile, 4 groups of 4 warps, chunks aligned to K that give
    each group at most one item (so one staged item a group), in 128 blocks:
    one wave on 132 SMs."""

    plan = cuda_fold.fold_mma_plan(sign, 2, B, 55, 32, 32, kh, kh, 27)
    assert (plan.per_chunk, plan.pad, plan.smem) == (per_chunk, pad, smem)
    assert (plan.lp_pad, plan.rt, plan.band, plan.nt, plan.tiles) == (64, 64, 0, 32, 1)
    assert (plan.groups, plan.warps, plan.stages, plan.chunks) == (4, 16, 1, 128)
    assert plan.per_chunk <= plan.groups and plan.chunks == 2 * plan.chunks_per_k
    assert (plan.chunks_per_k - 1) * plan.per_chunk < B <= plan.chunks_per_k * plan.per_chunk
    # W: kh * kh taps of 32 x 40; one window of 64 + 2 * pad rows of 40 per group
    assert plan.smem == 2 * kh * kh * 32 * 40 + 4 * 2 * (64 + 2 * pad) * 40


def test_plan_keeps_a_ring_where_groups_take_several_items():
    """L=512 (Lp=1023, p_cap 511) at 5x5: 16 items a sequence, staged as
    bands, many per group, so each group keeps a two-item ring."""

    plan = cuda_fold.fold_mma_plan(1, 4, 256, 1023, 32, 32, 5, 5, 511)
    assert (plan.band, plan.stages, plan.lp_pad // plan.rt) == (1, 2, 16)
    assert plan.per_chunk > plan.groups and plan.buf_rows == 5 * (64 + 4)


@pytest.mark.parametrize("c,kh", [(128, 3), (96, 5), (80, 7)])
@pytest.mark.parametrize("sign", [1, -1], ids=["fwd", "dh"])
def test_plan_takes_the_channel_edges(sign, c, kh):
    """The widest mid each CUDA-core kernel takes at the flagship's Lp=55
    (4 (Lp C + kw C^2) <= 227 KB): the plan finds a tile."""

    assert 4 * (55 * c + kh * c * c) <= cuda_fold.MAX_SMEM_BYTES
    plan = cuda_fold.fold_mma_plan(sign, 2, 192, 55, c, c, kh, kh, 27)
    assert plan.smem <= cuda_fold.MAX_SMEM_BYTES and plan.tiles * plan.nt >= c


def test_plan_takes_every_shape_the_cuda_core_kernels_take():
    """Every bf16 shape with Cin = Cout = C a multiple of 16 (the model's
    inception convs) that the CUDA-core kernels took, 4 (Lp C + kw C^2) <=
    227 KB, at the shipped kernel sizes and any Lp = L + p_cap, p_cap <= L - 1:
    window or bands, the plan fits."""

    for kh, kw in [(3, 3), (5, 5), (7, 7), (1, 3)]:
        for c in range(16, 257, 16):
            for Lp in list(range(3, 120)) + list(range(120, 3000, 37)):
                if 4 * (Lp * c + kw * c * c) > cuda_fold.MAX_SMEM_BYTES:
                    continue
                p_max = max(1, Lp // 2)
                for sign in (1, -1):
                    plan = cuda_fold.fold_mma_plan(sign, 2, 16, Lp, c, c, kh, kw, p_max)
                    assert plan.smem <= cuda_fold.MAX_SMEM_BYTES


@pytest.mark.parametrize("shape,why", [
    ((1, 2, 4, 55, 24, 32, 3, 3, 27), "Cin and Cout must be multiples of 16"),
    ((-1, 2, 4, 55, 32, 40, 3, 3, 27), "Cin and Cout must be multiples of 16"),
    ((1, 2, 4, 55, 32, 32, 3, 4, 27), "kernel size odd"),
    ((-1, 2, 4, 55, 32, 32, 3, 3, 56), r"p_max must lie in \[1, Lp\]"),
    ((1, 2, 4, 55, 256, 256, 7, 7, 27), "more than 232448 bytes"),
    ((-1, 2, 4, 55, 256, 256, 7, 7, 27), "more than 232448 bytes"),
])
def test_plan_refuses_what_the_kernel_cannot_take(shape, why):
    with pytest.raises(RuntimeError, match=f"cudaError_t 1 .*{why}"):
        cuda_fold.fold_mma_plan(*shape)


# --- around the kernel ----------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    """On the CPU ``TapConv`` runs the plain forward and dh, in bf16 too: no
    launch is counted on either route."""

    kh, kw, periods = 5, 5, [7, 27]
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    h, ct, w, bias = _inputs(5, 2, 2, geom.Lp, 32, 32, kh, kw)
    counters = (cuda_fold.launches, cuda_fold.launches_mma, cuda_fold.launches_dh,
                cuda_fold.launches_dh_mma)
    before = [sum(c.values()) for c in counters]
    h_t = torch.from_numpy(h).bfloat16().requires_grad_()
    out = cuda_fold.tap_conv(h_t, geom, torch.from_numpy(w), torch.from_numpy(bias), kh, kw)
    out.backward(torch.from_numpy(ct))
    _assert_close(out.detach().numpy(), _plain(1, h, w, bias, periods, L, kh, kw)[1], "forward")
    want_dh = _plain(-1, _bf16(ct), w, bias, periods, L, kh, kw)[1]
    np.testing.assert_allclose(h_t.grad.float().numpy(), want_dh, rtol=2 ** -7, atol=2 ** -7)
    assert [sum(c.values()) for c in counters] == before


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a header in csrc/ (the PTX helpers) gives every library a
    new name, so a stale build is never loaded; the sources stay ``*.cu``."""

    (tmp_path / "a.cu").write_text('#include "helpers.cuh"\n')
    (tmp_path / "helpers.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("a.cu")
    assert _build.sources() == ["a.cu"]
    (tmp_path / "helpers.cuh").write_text("// v2\n")
    second = _build.library_path("a.cu")
    assert first != second and first.name.startswith("a-") and second.name.startswith("a-")
    (tmp_path / "more.cuh").write_text("// another header\n")
    assert _build.library_path("a.cu") != second
