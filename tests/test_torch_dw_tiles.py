"""The bf16 tensor-core dW kernel's decomposition, modelled in numpy on the CPU.

``csrc/tap_conv_bwd.cu::tap_conv_dw_mma_kernel`` runs only on the card. These
tests model how it cuts the work, step by step, and hold the model against
the port's plain ``ops/fold.py::tap_weight_grad`` and the JAX package's
``ops/fold.py::_tap_weight_grad`` on the same numpy inputs:

- the launch plan of ``ops/cuda_fold.py::dw_mma_plan``, which the kernel's C
  plan mirrors (chunk count, scratch size, pad rows, shared-memory bytes),
  and its refusal of the shapes the kernel cannot take;
- the ldmatrix.trans lane addresses against the mma.sync m16n8k16 fragment
  layout (PTX ISA), and the fragment masks as an AND on packed bf16 pairs;
- band 0: each sequence of h staged between zero rows, every shifted row
  read in bounds, 16-row k-steps whose rows beyond Lp hold NaN (stale
  shared memory) until the per-(tap, row) validity clears them;
- band 1 (long sequences): items of ``rt`` rows of a sequence, the block's
  kernel row staging one band of ``rt + kw - 1`` rows of h with zero rows
  wherever the band leaves [0, Lp), ct's rows past Lp zero too, each lane's
  masks built from the item's (row, col) table, k-steps wholly past Lp
  skipped;
- chunks that never straddle two candidates, and pass 2 summing the chunks
  in chunk order.

The inputs are bf16 values held in float32, as the kernel sees them: every
product is exact, so the model differs from the references only in the order
of the float32 sums. Within 2e-5 (the JAX package's fold-conv gradient
tolerance), relative to the largest |dW| since dW sums thousands of products.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flow_timesnet_tpu.ops import fold as jfold  # noqa: E402
from flow_timesnet_tpu_torch.ops import cuda_fold, fold  # noqa: E402
from port_helpers import a_matrix, b_matrix, ldmatrix  # noqa: E402

ROWS = cuda_fold.MMA_ROWS
TOL = 2e-5
SIZES = [(3, 3), (5, 5), (7, 7), (1, 3)]


# --- the kernel's lane arithmetic, as tap_conv_dw_mma_kernel writes it -------

def a_address(lane):
    """(row within the k-step, channel offset) lane names for A's ldmatrix."""

    return (lane & 7) + ((lane >> 4) << 3), ((lane >> 3) & 1) * 8


def b_address(lane):
    """(row within the k-step, channel offset) lane names for B's ldmatrix."""

    return (lane & 7) + (((lane >> 3) & 1) << 3), (lane >> 4) * 8


def fragment_rows(ks, lane):
    """The rows t of the B fragment's pairs (register 0: t, t + 1; register 1:
    t + 8, t + 9) that lane holds at k-step ks."""

    t0 = ks * ROWS + 2 * (lane % 4)
    return [[t0, t0 + 1], [t0 + 8, t0 + 9]]


def lane_masks(row_tab, col_tab, Lp, cycles, p, dc, dj, ks, lane):
    """The two AND masks of lane's B registers for tap (dc, dj) at k-step ks."""

    masks = [0, 0]
    for reg, pair in enumerate(fragment_rows(ks, lane)):
        for half, t in enumerate(pair):
            r, c = row_tab[t] + dc, col_tab[t] + dj
            if t < Lp and 0 <= r < cycles and 0 <= c < p:
                masks[reg] |= 0xFFFF0000 if half else 0x0000FFFF
    return masks


# --- the model of the whole kernel -------------------------------------------

def block_validity(plan, Lp, cycles, p, dc, kw):
    """Per (tap dj, row t) validity of a block, built lane by lane from the
    kernel's masks; every lane that holds a row agrees on it. [kw, lp_pad]."""

    t = np.arange(plan.lp_pad)
    row_tab, col_tab = t // p, t % p  # t >= 0: the floor
    valid = np.full((kw, plan.lp_pad), -1, np.int8)
    for w in range(kw):
        for ks in range(plan.lp_pad // ROWS):
            for lane in range(32):
                masks = lane_masks(row_tab, col_tab, Lp, cycles, p, dc, w - kw // 2, ks, lane)
                for reg, pair in enumerate(fragment_rows(ks, lane)):
                    for half, row in enumerate(pair):
                        bits = (masks[reg] >> (16 * half)) & 0xFFFF
                        assert bits in (0, 0xFFFF)
                        assert valid[w, row] in (-1, bits != 0)
                        valid[w, row] = bits != 0
    assert (valid >= 0).all()  # every row of every k-step is some lane's
    return valid.astype(bool)


def item_table(t0, rt, Lp, p):
    """Band 1's (row(t), col(t)) table of an item's rows t0 .. t0 + rt - 1,
    as the kernel stages it: a row past Lp takes a row far below 0."""

    t = t0 + np.arange(rt)
    return np.where(t < Lp, t // p, -(1 << 30)), np.where(t < Lp, t % p, 0)


def band_lane_masks(rows, cols, cycles, p, dc, dj, ks, lane):
    """The two AND masks of lane's B registers for tap (dc, dj) at k-step ks
    of a band-1 item, from its (row, col) table."""

    masks = [0, 0]
    for reg, pair in enumerate(fragment_rows(ks, lane)):
        for half, t in enumerate(pair):
            r, c = rows[t] + dc, cols[t] + dj
            if 0 <= r < cycles and 0 <= c < p:
                masks[reg] |= 0xFFFF0000 if half else 0x0000FFFF
    return masks


def band_validity(rows, cols, cycles, p, dc, kw):
    """Per (tap dj, row of the item) validity that the lanes' band-1 masks
    hold, in one numpy expression: [kw, rt]."""

    dj = np.arange(kw)[:, None] - kw // 2
    r, c = rows[None] + dc, cols[None] + dj
    return (r >= 0) & (r < cycles) & (c >= 0) & (c < p)


def model_dw(h, ct, periods, cycles, kh, kw, p_max):
    """dW as the kernel computes it: pass 1 per chunk, pass 2 in chunk order."""

    K, B, Lp, cin = h.shape
    cout = ct.shape[-1]
    plan = cuda_fold.dw_mma_plan(K, B, Lp, cin, cout, kh, kw, p_max)
    rh, rw = kh // 2, kw // 2
    per_seq = plan.lp_pad // plan.rt
    partial = np.zeros((plan.chunks, kh, kw, cin, cout), np.float32)
    validity = {}  # band 0 builds it per block; it depends on (p, cycles, dc) alone
    for chunk in range(plan.chunks):
        k, c = divmod(chunk, plan.chunks_per_k)  # one candidate per chunk
        items = range(c * plan.per_chunk, min(B * per_seq, (c + 1) * plan.per_chunk))
        assert len(items) >= 1
        p, cyc = min(max(int(periods[k]), 1), p_max), int(cycles[k])
        for dc in range(-rh, rh + 1):
            for item in items:
                b, t0 = item // per_seq, (item % per_seq) * plan.rt
                if plan.band == 0:
                    assert plan.rt == plan.lp_pad and t0 == 0
                    key = (p, cyc, dc)
                    if key not in validity:
                        validity[key] = block_validity(plan, Lp, cyc, p, dc, kw)
                    valid = validity[key]
                    staged = np.zeros((plan.buf_rows, cin), np.float32)
                    staged[plan.pad:plan.pad + Lp] = h[k, b]
                    ct_s = np.full((plan.rt, cout), np.nan, np.float32)  # stale beyond Lp
                    ct_s[:Lp] = ct[k, b]
                    ksteps = plan.rt // ROWS
                else:
                    # one band of h for this kernel row, zero outside [0, Lp)
                    g = t0 + dc * p - rw + np.arange(plan.buf_rows)
                    inside = (g >= 0) & (g < Lp)
                    staged = np.where(inside[:, None], h[k, b, np.clip(g, 0, Lp - 1)], 0.0)
                    t = t0 + np.arange(plan.rt)
                    ct_s = np.where((t < Lp)[:, None], ct[k, b, np.clip(t, 0, Lp - 1)], 0.0)
                    valid = band_validity(*item_table(t0, plan.rt, Lp, p), cyc, p, dc, kw)
                    ksteps = min(plan.rt // ROWS, -(-(Lp - t0) // ROWS))
                for w in range(kw):
                    shift = (plan.pad + dc * p + w - rw) if plan.band == 0 else w
                    for ks in range(ksteps):
                        rows = shift + ks * ROWS + np.arange(ROWS)
                        assert 0 <= rows.min() and rows.max() < staged.shape[0]
                        b_frag = np.where(valid[w, ks * ROWS:(ks + 1) * ROWS, None],
                                          ct_s[ks * ROWS:(ks + 1) * ROWS], 0.0)
                        partial[chunk, dc + rh, w] += staged[rows].T @ b_frag
    dw = np.zeros((kh, kw, cin, cout), np.float32)
    for chunk in range(plan.chunks):
        dw += partial[chunk]
    return dw, plan


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(seed, K, B, Lp, cin, cout):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.standard_normal((K, B, Lp, cin)).astype(np.float32)),
            _bf16(rng.standard_normal((K, B, Lp, cout)).astype(np.float32)))


def _references(h, ct, periods, L, kh, kw):
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    plain = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct), kh, kw).numpy()
    jg = jfold.make_geometry(jnp.asarray(periods, jnp.int32), L, p_cap=L - 1)
    want = np.asarray(jfold._tap_weight_grad(
        jnp.asarray(h), jg.periods, jg.cycles, jg.col, jg.row, jnp.asarray(ct), kh, kw, jg.Lp, L))
    return geom, plain, want


def _assert_close(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=name)


@pytest.mark.parametrize("periods", [(1, 27), (4, 14), (7, 27), (14, 4), (27, 7)])
@pytest.mark.parametrize("kh,kw", SIZES)
def test_model_matches_plain_and_jax(kh, kw, periods):
    """The flagship fold (L=28, Lp=55, 32 channels) at B=42: 5x5 and 7x7
    chunks hold several sequences and 7x7's last chunk fewer than the rest."""

    L, B = 28, 42
    h, ct = _inputs(kh * 100 + periods[0], len(periods), B, 2 * L - 1, 32, 32)
    geom, plain, want = _references(h, ct, list(periods), L, kh, kw)
    got, plan = model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, L - 1)
    assert plan.chunks == len(periods) * plan.chunks_per_k
    _assert_close(got, plain, "plain")
    _assert_close(got, want, "JAX")


@settings(max_examples=12, deadline=None)
@given(st.data())
def test_model_matches_plain_over_periods_and_sizes(data):
    L = data.draw(st.integers(4, 30), label="L")
    kh = data.draw(st.sampled_from([1, 3, 5, 7]), label="kh")
    kw = data.draw(st.sampled_from([1, 3, 5, 7]), label="kw")
    periods = data.draw(st.lists(st.integers(1, L - 1), min_size=1, max_size=3), label="periods")
    cin = data.draw(st.sampled_from([16, 32, 48]), label="cin")
    cout = data.draw(st.sampled_from([8, 24, 32, 40]), label="cout")
    B = data.draw(st.integers(1, 3), label="B")
    h, ct = _inputs(data.draw(st.integers(0, 2**31 - 1), label="seed"), len(periods), B,
                    2 * L - 1, cin, cout)
    geom, plain, want = _references(h, ct, periods, L, kh, kw)
    got, _ = model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, L - 1)
    _assert_close(got, plain, "plain")
    _assert_close(got, want, "JAX")


def test_fragment_addresses_load_the_mma_operands():
    """ldmatrix.trans at the kernel's lane addresses yields A[ci, t] = h[t, ci]
    and B[t, co] = ct[t, co] in the m16n8k16 layout, and the accumulator
    layout the epilogue writes covers each (ci, co) of the tile once."""

    rng = np.random.default_rng(0)
    t0, ci0, co0, cin, cout = 16, 16, 8, 48, 40  # a k-step, an m-tile and a pair of n-tiles inside
    h_s = rng.standard_normal((64, cin + cuda_fold.MMA_ROW_PAD)).astype(np.float32)
    ct_s = rng.standard_normal((64, cout + cuda_fold.MMA_ROW_PAD)).astype(np.float32)

    a_frag = ldmatrix(h_s, [(t0 + a_address(l)[0], ci0 + a_address(l)[1]) for l in range(32)],
                      trans=True)
    np.testing.assert_array_equal(a_matrix(a_frag), h_s[t0:t0 + 16, ci0:ci0 + 16].T)

    b_frag = ldmatrix(ct_s, [(t0 + b_address(l)[0], co0 + b_address(l)[1]) for l in range(32)],
                      trans=True)
    for nt in range(2):  # registers (0, 1) hold n-tile co0, (2, 3) n-tile co0 + 8
        np.testing.assert_array_equal(b_matrix(b_frag[:, 2 * nt:2 * nt + 2]),
                                      ct_s[t0:t0 + 16, co0 + 8 * nt:co0 + 8 * nt + 8])
        # the B registers' rows are those the masks are built for
        for lane in range(32):
            for reg, pair in enumerate(fragment_rows(1, lane)):
                for half, t in enumerate(pair):
                    assert b_frag[lane, 2 * nt + reg, half] == ct_s[t, co0 + 8 * nt + lane // 4]

    seen = np.zeros((32, 32), int)  # the epilogue: (ci, co) of accumulator e of tile (mt, nt)
    for lane in range(32):
        for mt in range(2):
            for nt in range(4):
                for e in range(4):
                    seen[16 * mt + lane // 4 + 8 * (e // 2), 8 * nt + 2 * (lane % 4) + e % 2] += 1
    assert (seen == 1).all()


def test_masks_select_packed_bf16_pairs():
    """An AND with a lane's masks keeps a valid row's bf16 bits and turns any
    other, NaN and Inf included, into +0."""

    ct = torch.tensor([[1.5, -2.0], [float("nan"), float("inf")], [3.25, -0.0]],
                      dtype=torch.bfloat16)
    bits = ct.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)
    packed = bits[:, 0] | (bits[:, 1] << 16)  # one register: a pair of rows of one column
    for mask, want in ((0xFFFFFFFF, (True, True)), (0x0000FFFF, (True, False)),
                       (0xFFFF0000, (False, True)), (0, (False, False))):
        out = packed & np.uint32(mask)
        lo, hi = (out & 0xFFFF).astype(np.uint16), (out >> 16).astype(np.uint16)
        for keep, half, orig in ((want[0], lo, bits[:, 0]), (want[1], hi, bits[:, 1])):
            np.testing.assert_array_equal(half, orig if keep else 0)


@pytest.mark.parametrize("kh,kw,chunks,per_chunk,pad,smem", [
    (3, 3, 104, 5, 28, 62_464),
    (5, 5, 40, 13, 56, 82_432),
    (7, 7, 22, 24, 84, 102_400),
    (1, 3, 256, 2, 1, 45_184),
])
def test_plan_at_the_training_shape(kh, kw, chunks, per_chunk, pad, smem):
    """The flagship training call (K=2, B=256, Lp=55, 32 channels, p_cap 27):
    the numbers the kernel's source note gives, a scratch smaller than the
    CUDA-core version's (6.3 / 10.5 / 14.9 MB at 3x3 / 5x5 / 7x7) and chunks
    aligned to K."""

    plan = cuda_fold.dw_mma_plan(2, 256, 55, 32, 32, kh, kw, 27)
    assert (plan.chunks, plan.per_chunk, plan.pad, plan.smem) == (chunks, per_chunk, pad, smem)
    assert plan.lp_pad == 64 and plan.tiles == 1 and plan.warps == kw
    # the whole window fits: a whole sequence an item, as before the banded staging
    assert (plan.band, plan.rt, plan.buf_rows) == (0, 64, 64 + 2 * pad)
    assert plan.chunks == 2 * plan.chunks_per_k
    assert (plan.chunks_per_k - 1) * plan.per_chunk < 256 <= plan.chunks_per_k * plan.per_chunk
    nbytes = 4 * plan.scratch_elems(kh, kw, 32, 32)
    assert nbytes < {3: 6.3e6, 5: 10.5e6, 7: 14.9e6, 1: 6.3e6}[kh]
    # shared memory: a ring of 4 buffers of (zero rows, h, zero rows) and ct, the masks, the table
    assert plan.smem == (2 * 4 * ((64 + 2 * pad) * 40 + 64 * 40) + 8 * kw * 4 * 32 + 8 * 64)


@pytest.mark.parametrize("shape,why", [
    ((2, 4, 55, 24, 32, 3, 3, 27), "Cin must be a multiple of 16"),
    ((2, 4, 55, 32, 12, 3, 3, 27), "Cout a multiple of 8"),
    ((2, 4, 55, 32, 32, 1, 17, 27), "at most 16 taps"),
    ((2, 4, 55, 32, 32, 3, 4, 27), "kernel size odd"),
    ((2, 4, 55, 32, 32, 3, 3, 56), r"p_max must lie in \[1, Lp\]"),
    ((2, 4, 55, 32, 32, 3, 3, 0), r"p_max must lie in \[1, Lp\]"),
    ((2, 4, 900, 1024, 1024, 7, 7, 899), "shared memory"),
])
def test_plan_refuses_what_the_kernel_cannot_take(shape, why):
    with pytest.raises(RuntimeError, match=f"cudaError_t 1 .*{why}"):
        cuda_fold.dw_mma_plan(*shape)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU ``TapConv`` computes dW with the plain version, in bf16 too:
    no kernel launch is counted on either route."""

    L, kh, kw, periods = 28, 5, 5, [7, 27]
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    h, ct = _inputs(5, 2, 2, geom.Lp, 32, 32)
    before = (sum(cuda_fold.launches_dw.values()), sum(cuda_fold.launches_dw_mma.values()))
    kernel = torch.zeros((kh, kw, 32, 32), requires_grad=True)
    out = cuda_fold.tap_conv(torch.from_numpy(h).bfloat16(), geom, kernel, torch.zeros(32), kh, kw)
    out.backward(torch.from_numpy(ct))
    want = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct).bfloat16(), kh, kw)
    _assert_close(kernel.grad.numpy(), want.numpy(), "TapConv on the CPU")
    assert (sum(cuda_fold.launches_dw.values()), sum(cuda_fold.launches_dw_mma.values())) == before


# --- band 1: the long-context shapes, where a whole sequence does not fit -------

LONG_SHAPES = [  # (K, B, Lp, p_max), each at 3x3 and 5x5, with 32 channels
    (4, 64, 1023, 511),  # dynamic: L=512, p_cap = L - 1
    (1, 64, 525, 25),  # frozen exact extent, p=25: 21 cycles
    (1, 64, 513, 171),  # frozen exact extent, p=171: 3 cycles
]
# shared memory a block needed when every item was a whole sequence
WHOLE_SEQUENCE_SMEM = {(1023, 3): 1_040_384, (1023, 5): 1_400_832, (525, 3): 384_128,
                       (525, 5): 417_664, (513, 3): 477_568, (513, 5): 604_544}


@pytest.mark.parametrize("K,B,Lp,p_max", LONG_SHAPES)
@pytest.mark.parametrize("k", [3, 5])
def test_plan_takes_the_long_context_shapes(K, B, Lp, p_max, k):
    """The long-context recipe's calls, which a ring of whole sequences
    cannot hold in one SM's shared memory, take 64-row items whose h is one
    band of 64 + kw - 1 rows, within ``MAX_SMEM_BYTES``."""

    lp16 = -(-Lp // ROWS) * ROWS
    pad = (k // 2) * p_max + k // 2
    whole = 2 * 4 * ((lp16 + 2 * pad) * 40 + lp16 * 40) + 8 * k * (lp16 // ROWS) * 32 + 8 * lp16
    assert whole == WHOLE_SEQUENCE_SMEM[(Lp, k)] > cuda_fold.MAX_SMEM_BYTES
    plan = cuda_fold.dw_mma_plan(K, B, Lp, 32, 32, k, k, p_max)
    assert (plan.band, plan.rt, plan.buf_rows, plan.pad) == (1, 64, 64 + k - 1, pad)
    assert plan.lp_pad == -(-Lp // 64) * 64 and plan.lp_pad - Lp < 64
    # the ring of four items and their (row, col) tables
    assert plan.smem == 2 * 4 * ((64 + k - 1) * 40 + 64 * 40) + 8 * 4 * 64
    assert plan.smem <= cuda_fold.MAX_SMEM_BYTES
    items = B * plan.lp_pad // 64
    assert plan.chunks == K * plan.chunks_per_k
    assert (plan.chunks_per_k - 1) * plan.per_chunk < items <= plan.chunks_per_k * plan.per_chunk


@pytest.mark.parametrize("cin,k,rt", [(32, 7, 64), (128, 7, 64), (256, 7, 32), (512, 7, 16),
                                      (512, 3, 16), (384, 5, 32)])
def test_band_plan_takes_the_first_item_height_that_fits(cin, k, rt):
    """Wide channels take 32- or 16-row items where 64 rows do not fit."""

    plan = cuda_fold.dw_mma_plan(1, 2, 1023, cin, cin, k, k, 511)
    assert (plan.band, plan.rt, plan.buf_rows) == (1, rt, rt + k - 1)
    for taller in (r for r in cuda_fold.MMA_BAND_ROWS if r > rt):
        assert 2 * 4 * ((taller + k - 1) + taller) * (cin + 8) + 32 * taller > \
            cuda_fold.MAX_SMEM_BYTES


@pytest.mark.parametrize("Lp,dc,p,cycles", [(1023, -1, 511, 2), (1023, 1, 24, 22), (525, 2, 25, 21),
                                            (513, 0, 171, 3), (70, 1, 7, 10)])
def test_band_lane_masks_hold_the_item_table_validity(Lp, dc, p, cycles):
    """Each lane's band-1 masks, built from the item's (row, col) table at
    every k-step, hold the (tap, row) validity of the fold, rows past Lp
    invalid: every row of every k-step is some lane's, and they agree."""

    kw, rt = 5, 64
    for t0 in (0, (Lp - 1) // rt * rt):  # the first item, and the last (rows past Lp)
        rows, cols = item_table(t0, rt, Lp, p)
        want = band_validity(rows, cols, cycles, p, dc, kw)
        t = t0 + np.arange(rt)
        fold_valid = ((t[None] < Lp) & (t[None] // p + dc >= 0) & (t[None] // p + dc < cycles)
                      & (t[None] % p + np.arange(kw)[:, None] - kw // 2 >= 0)
                      & (t[None] % p + np.arange(kw)[:, None] - kw // 2 < p))
        np.testing.assert_array_equal(want, fold_valid)
        seen = np.zeros((kw, rt), int)
        for w in range(kw):
            for ks in range(rt // ROWS):
                for lane in range(32):
                    masks = band_lane_masks(rows, cols, cycles, p, dc, w - kw // 2, ks, lane)
                    for reg, pair in enumerate(fragment_rows(ks, lane)):
                        for half, row in enumerate(pair):
                            bits = (masks[reg] >> (16 * half)) & 0xFFFF
                            assert bits == (0xFFFF if want[w, row] else 0)
                            seen[w, row] += 1
        assert (seen == 8).all()  # each row of a k-step: the 8 lanes of its pair, one per column


@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_band_model_matches_plain_and_jax_at_long_context(kh, kw):
    """The dynamic long-context fold (L=512, Lp=1023, p_cap 511, K=4 at
    periods such as the hourly data's) at B=1 in 64-row items: every row of
    Lp, the last item's rows past Lp and the zero rows of bands that leave
    [0, Lp) included."""

    L, periods = 512, [511, 168, 24, 7]
    h, ct = _inputs(kh, len(periods), 1, 2 * L - 1, 32, 32)
    geom, plain, want = _references(h, ct, periods, L, kh, kw)
    got, plan = model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, L - 1)
    assert plan.band == 1 and plan.lp_pad == 1024
    _assert_close(got, plain, "plain")
    _assert_close(got, want, "JAX")


@pytest.mark.parametrize("p", [25, 171])
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_band_model_matches_plain_at_the_exact_extent(kh, kw, p):
    """The frozen long-context path: K=1, Lp = total (525 at p=25, 513 at
    p=171), p_max = p, at B=2."""

    L = 512
    geom = fold.make_dense_geometry(p, L)
    h, ct = _inputs(p + kh, 1, 2, geom.Lp, 32, 32)
    plain = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct), kh, kw).numpy()
    got, plan = model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, geom.p_max)
    assert plan.band == 1 and geom.Lp == {25: 525, 171: 513}[p]
    _assert_close(got, plain, "plain")


def test_band_model_takes_32_row_items():
    """256 channels at 7x7 stage 32-row items (64 rows do not fit): the
    model over 8 channel tiles against the plain version."""

    L, periods, kh, kw = 40, [39, 6], 7, 7
    h, ct = _inputs(3, len(periods), 1, 2 * L - 1, 256, 256)
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    plain = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct), kh, kw).numpy()
    got, plan = model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, L - 1)
    assert (plan.band, plan.rt, plan.tiles) == (1, 32, 64)
    _assert_close(got, plain, "plain")


@settings(max_examples=8, deadline=None)
@given(st.data())
def test_band_model_matches_plain_over_periods_and_sizes(data):
    """Band 1 over drawn periods, kernel sizes and channels (wide enough that
    a whole sequence does not fit), against the plain version and JAX."""

    L = data.draw(st.integers(70, 120), label="L")
    kh = data.draw(st.sampled_from([3, 5, 7]), label="kh")
    kw = data.draw(st.sampled_from([1, 3, 5, 7]), label="kw")
    periods = data.draw(st.lists(st.integers(1, L - 1), min_size=1, max_size=2), label="periods")
    cin = data.draw(st.sampled_from([128, 144]), label="cin")
    cout = data.draw(st.sampled_from([128, 136]), label="cout")
    B = data.draw(st.integers(1, 2), label="B")
    h, ct = _inputs(data.draw(st.integers(0, 2**31 - 1), label="seed"), len(periods), B,
                    2 * L - 1, cin, cout)
    geom, plain, want = _references(h, ct, periods, L, kh, kw)
    got, plan = model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, L - 1)
    assert plan.band == 1
    _assert_close(got, plain, "plain")
    _assert_close(got, want, "JAX")
