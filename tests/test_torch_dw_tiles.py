"""The bf16 tensor-core dW kernels' decompositions, modelled in numpy on the CPU.

``csrc/tap_conv_bwd.cu::tap_conv_dw_mma_kernel`` (band 0, whole sequences)
and ``tap_conv_dw_wgmma_kernel`` (band 1, long sequences) run only on the
card. These tests model how each cuts the work, step by step, and hold the
models against the port's plain ``ops/fold.py::tap_weight_grad`` and the JAX
package's ``ops/fold.py::_tap_weight_grad`` on the same numpy inputs:

- the launch plan of ``ops/cuda_fold.py::dw_mma_plan``, which the kernels' C
  plan mirrors (chunk count, scratch size, pad rows, shared-memory bytes,
  band 1's stages, groups, M tiles, warpgroups and clusters), and its
  refusal of the shapes the kernels cannot take;
- band 0: the ldmatrix.trans lane addresses against the mma.sync m16n8k16
  fragment layout (PTX ISA), the fragment masks as an AND on packed bf16
  pairs, each sequence of h staged between zero rows, every shifted row
  read in bounds, 16-row k-steps whose rows beyond Lp hold NaN (stale
  shared memory) until the per-(tap, row) validity clears them, chunks that
  never straddle two candidates, pass 2 in chunk order;
- band 1: items of ``rt`` rows walked by persistent blocks; each item's ct
  staged once and one band of ``rt + kw - 1`` rows of h for each kernel row
  that some row of the item reaches, as TMA boxes with zeros outside the
  tensor (kernel rows no row reaches left stale, NaN); the 64-byte swizzle
  of the staged rows and the ldmatrix.trans addresses into it; the
  producer's tap table and the lanes' A masks; wgmma M tiles of four (tap,
  16 channels) slabs, skipped where no row of the item is valid for any of
  their taps; the accumulators' map to the partial-sum buffer; each
  cluster's blocks summed in rank order, then pass 2 over the clusters.

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


def model_dw(h, ct, periods, cycles, kh, kw, p_max):
    """dW as the kernels compute it: band 0's pass 1 per chunk and pass 2 in
    chunk order, or band 1's model (:func:`band_model_dw`)."""

    K, B, Lp, cin = h.shape
    cout = ct.shape[-1]
    plan = cuda_fold.dw_mma_plan(K, B, Lp, cin, cout, kh, kw, p_max)
    if plan.band == 1:
        return band_model_dw(h, ct, periods, cycles, kh, kw, p_max)
    assert plan.rt == plan.lp_pad
    rh, rw = kh // 2, kw // 2
    partial = np.zeros((plan.chunks, kh, kw, cin, cout), np.float32)
    validity = {}  # built per block; it depends on (p, cycles, dc) alone
    for chunk in range(plan.chunks):
        k, c = divmod(chunk, plan.chunks_per_k)  # one candidate per chunk
        items = range(c * plan.per_chunk, min(B, (c + 1) * plan.per_chunk))
        assert len(items) >= 1
        p, cyc = min(max(int(periods[k]), 1), p_max), int(cycles[k])
        for dc in range(-rh, rh + 1):
            key = (p, cyc, dc)
            if key not in validity:
                validity[key] = block_validity(plan, Lp, cyc, p, dc, kw)
            valid = validity[key]
            for b in items:
                staged = np.zeros((plan.buf_rows, cin), np.float32)
                staged[plan.pad:plan.pad + Lp] = h[k, b]
                ct_s = np.full((plan.rt, cout), np.nan, np.float32)  # stale beyond Lp
                ct_s[:Lp] = ct[k, b]
                for w in range(kw):
                    shift = plan.pad + dc * p + w - rw
                    for ks in range(plan.rt // ROWS):
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
    ((2, 4, 900, 8192, 8192, 7, 7, 899), "more blocks or items than a grid holds"),
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


# --- band 1: the long-context shapes, tap_conv_dw_wgmma_kernel ----------------

LONG_SHAPES = [  # (K, B, Lp, p_max), each at 3x3 and 5x5, with 32 channels
    (4, 64, 1023, 511),  # dynamic: L=512, p_cap = L - 1
    (1, 64, 525, 25),  # frozen exact extent, p=25: 21 cycles
    (1, 64, 513, 171),  # frozen exact extent, p=171: 3 cycles
]
# shared memory a block needed when every item was a whole sequence
WHOLE_SEQUENCE_SMEM = {(1023, 3): 1_040_384, (1023, 5): 1_400_832, (525, 3): 384_128,
                       (525, 5): 417_664, (513, 3): 477_568, (513, 5): 604_544}
ROW_BYTES = cuda_fold.BAND_ROW_BYTES


def swizzle64(r, c):
    """Byte offset of 16-byte chunk c of 64-byte row r in a 1,024-byte-aligned
    buffer that TMA wrote with the 64-byte swizzle (csrc/hopper_ptx.cuh)."""

    return 64 * r + 16 * (c ^ ((r >> 1) & 3))


def band_item(i, K, B, Lp, plan, periods, cycles, p_max, dc0, kr):
    """Item i as both of the kernel's roles decode it: (sequence, first row,
    p, cycles, klo, khi), [klo, khi] the group's kernel rows that some row
    of the item reaches."""

    seq, t0 = i % (K * B), (i // (K * B)) * plan.rt
    k = seq // B
    p, cyc = min(max(int(periods[k]), 1), p_max), int(cycles[k])
    r_lo, r_hi = t0 // p, (min(t0 + plan.rt, Lp) - 1) // p
    return seq, t0, p, cyc, max(0, -r_hi - dc0), min(kr - 1, cyc - 1 - r_lo - dc0)


def tap_table(t0, rt, Lp, p, cyc, dc0, klo, khi, kr, kw):
    """The producer's table of an item: one word a row, bit kri * kw + wj set
    where tap (dc0 + kri, wj - kw // 2) is valid there."""

    rw = kw // 2
    t = t0 + np.arange(rt)
    row, col = t // p, t % p
    lo, hi = np.maximum(klo, -row - dc0), np.minimum(khi, cyc - 1 - row - dc0)
    wlo, whi = np.maximum(0, rw - col), np.minimum(kw - 1, p - 1 - col + rw)
    words = np.zeros(rt, np.uint64)
    for kri in range(kr):
        for wj in range(kw):
            on = (t < Lp) & (lo <= kri) & (kri <= hi) & (wlo <= wj) & (wj <= whi)
            words |= np.where(on, np.uint64(1) << np.uint64(kri * kw + wj), np.uint64(0))
    assert (words < 2 ** cuda_fold.BAND_TAP_BITS).all()
    return words


def band_lane_masks(words, tap, ks, lane):
    """A lane's two AND masks for the A registers of a slab of tap ``tap`` at
    k-step ks, as the kernel builds them from the rows' words: registers 0, 1
    hold rows 16 ks + 2 q + {0, 1}, registers 2, 3 rows + {8, 9}."""

    q, out = lane % 4, []
    for base in (16 * ks + 2 * q, 16 * ks + 8 + 2 * q):
        lo, hi = (int(words[base]) >> tap) & 1, (int(words[base + 1]) >> tap) & 1
        out.append((0xFFFF if lo else 0) | (0xFFFF0000 if hi else 0))
    return out


def tile_kernel_rows(mt, nslabs, cib, kw):
    """The kernel rows that M tile mt's four slabs read (slab = 4 mt + warp)."""

    return 4 * mt // cib // kw, min(4 * mt + 3, nslabs - 1) // cib // kw


def band_model_dw(h, ct, periods, cycles, kh, kw, p_max, plan=None):
    """dW as tap_conv_dw_wgmma_kernel computes it: blocks (item chunk x,
    channel tile and kernel-row group y), each walking items x, x + blocks,
    ... with the producer's staging (TMA boxes, zeros outside the tensor,
    kernel rows no row reaches left stale: NaN) and tap table, the consumer
    warpgroups' live M tiles over 16-row k-steps, A masked per (tap, row);
    then each cluster's blocks summed in rank order, and pass 2 over the
    clusters in order."""

    K, B, Lp, cin = h.shape
    cout = ct.shape[-1]
    plan = plan or cuda_fold.dw_mma_plan(K, B, Lp, cin, cout, kh, kw, p_max)
    assert plan.band == 1
    rt, rh, rw, cs = plan.rt, kh // 2, kw // 2, plan.cluster
    co_tiles = -(-cout // 32)
    items = K * B * (plan.lp_pad // rt)
    h_flat, ct_flat = h.reshape(K * B, Lp, cin), ct.reshape(K * B, Lp, cout)

    def box(x, seq, r0, rows, c0):  # a TMA box of 32 channels: zeros outside the tensor
        out = np.zeros((rows, 32), np.float32)
        r = r0 + np.arange(rows)
        inside = (r >= 0) & (r < Lp)
        width = min(32, x.shape[-1] - c0)
        out[inside, :width] = x[seq, r[inside], c0:c0 + width]
        return out

    partial = np.zeros((plan.chunks, kh, kw, cin, cout), np.float32)
    for y in range(plan.tiles * plan.groups):
        group, tile = y % plan.groups, y // plan.groups
        ci0, co0 = (tile // co_tiles) * 32, (tile % co_tiles) * 32
        cib = min(2, (cin - ci0) // 16)
        kr = min(plan.kr, kh - group * plan.kr)
        dc0 = group * plan.kr - rh
        nslabs = kr * kw * cib
        mtiles = -(-nslabs // 4)
        assert mtiles <= plan.consumers * cuda_fold.BAND_WG_TILES and kr * kw <= 32
        slab_tap = [(s // cib) for s in range(nslabs)]
        red = np.zeros((plan.blocks, nslabs, 16, 32), np.float32)
        for x in range(plan.blocks):
            acc = np.zeros((mtiles * 4, 16, 32), np.float32)  # per slab: its 16 rows of an M tile
            staged = 0
            for i in range(x, items, plan.blocks):
                seq, t0, p, cyc, klo, khi = band_item(i, K, B, Lp, plan, periods, cycles, p_max,
                                                      dc0, kr)
                words = tap_table(t0, rt, Lp, p, cyc, dc0, klo, khi, kr, kw)
                if klo > khi:  # skipped whole: no tap is valid at any of its rows
                    assert not words.any()
                    continue
                staged += 1
                ct_s = box(ct_flat, seq, t0, rt, co0)
                bands = np.full((kr, plan.buf_rows, 32), np.nan, np.float32)  # stale
                for kri in range(klo, khi + 1):
                    bands[kri] = box(h_flat, seq, t0 + (dc0 + kri) * p - rw, plan.buf_rows, ci0)
                ks_end = min(rt // ROWS, -(-(Lp - t0) // ROWS))
                assert not words[ks_end * ROWS:].any()  # rows past the last k-step: past Lp
                n = ks_end * ROWS
                for mt in range(mtiles):
                    lo, hi = tile_kernel_rows(mt, nslabs, cib, kw)
                    live = lo <= khi and hi >= klo
                    for s in range(4 * mt, min(4 * mt + 4, nslabs)):
                        tap = slab_tap[s]
                        kri, wj, cb = tap // kw, tap % kw, s % cib
                        valid = ((words[:n] >> np.uint64(tap)) & np.uint64(1)).astype(bool)
                        if not live:  # a skipped tile holds no valid row
                            assert not valid.any()
                            continue
                        a = bands[kri, wj:wj + n, 16 * cb:16 * cb + 16].T  # [ci, t]
                        a = np.where(valid[None], a, np.float32(0))  # the AND: stale bits too
                        acc[s] += a @ ct_s[:n]
            assert staged <= plan.per_chunk
            red[x] = acc[:nslabs]
        for c in range(plan.chunks):  # each cluster's blocks, in rank order
            total = red[c * cs].copy()
            for r in range(1, cs):
                total += red[c * cs + r]
            for s in range(nslabs):
                tap = slab_tap[s]
                dci, wj, ci = group * plan.kr + tap // kw, tap % kw, ci0 + 16 * (s % cib)
                width = min(32, cout - co0)
                partial[c, dci, wj, ci:ci + 16, co0:co0 + width] = total[s, :, :width]
    dw = np.zeros((kh, kw, cin, cout), np.float32)
    for c in range(plan.chunks):  # pass 2
        dw += partial[c]
    return dw, plan


@pytest.mark.parametrize("K,B,Lp,p_max", LONG_SHAPES)
@pytest.mark.parametrize("k", [3, 5])
def test_plan_takes_the_long_context_shapes(K, B, Lp, p_max, k):
    """The long-context recipe's calls, which a ring of whole sequences
    cannot hold in one SM's shared memory: one persistent block an SM (66
    clusters of 2), every tap of the kernel in each block (5 or 13 M tiles
    over three consumer warpgroups), 128-row items at Lp 1023 and 64-row
    ones at the exact extents, a ring of at least four stages within
    ``MAX_SMEM_BYTES``, and one partial a cluster in the scratch."""

    lp16 = -(-Lp // ROWS) * ROWS
    pad = (k // 2) * p_max + k // 2
    whole = 2 * 4 * ((lp16 + 2 * pad) * 40 + lp16 * 40) + 8 * k * (lp16 // ROWS) * 32 + 8 * lp16
    assert whole == WHOLE_SEQUENCE_SMEM[(Lp, k)] > cuda_fold.MAX_SMEM_BYTES
    plan = cuda_fold.dw_mma_plan(K, B, Lp, 32, 32, k, k, p_max)
    rt = 128 if Lp == 1023 else 64
    assert isinstance(plan, cuda_fold.DwBandPlan)
    assert (plan.band, plan.rt, plan.buf_rows) == (1, rt, rt + k - 1)
    assert plan.lp_pad == -(-Lp // rt) * rt
    assert (plan.groups, plan.kr, plan.tiles) == (1, k, 1)
    assert (plan.mtiles, plan.consumers, plan.warps) == ({3: 5, 5: 13}[k], 3, 16)
    assert (plan.cluster, plan.blocks, plan.chunks) == (2, 132, 66)
    # a stage: ct's rows, one 1,024-aligned band of h a kernel row, the tap table, a header
    band = -(-(rt + k - 1) // 16) * 16 * 64
    assert plan.stage_bytes == -(-(rt * 64 + k * band + 4 * rt + 16) // 1024) * 1024
    assert plan.stages == min(8, (cuda_fold.MAX_SMEM_BYTES - 1024 - 128) // plan.stage_bytes) >= 4
    assert plan.smem == 1024 + plan.stages * plan.stage_bytes <= cuda_fold.MAX_SMEM_BYTES - 128
    items = K * B * plan.lp_pad // rt
    assert plan.per_chunk == -(-items // 132) and items >= 4 * 132
    # the scratch: 2.4 MB at 3x3, 6.8 MB at 5x5
    assert 4 * plan.scratch_elems(k, k, 32, 32) == 66 * k * k * 32 * 32 * 4


@pytest.mark.parametrize("K,B,Lp,cin,cout,kh,kw,rt,groups,kr", [
    (4, 64, 1023, 32, 32, 7, 7, 128, 2, 4),  # 7x7: 49 taps pass 32 bits: two groups of rows
    (2, 17, 1023, 32, 32, 5, 5, 64, 1, 5),  # 17 x 16 x 2 = 544 items of 64 rows: 4 a block
    (1, 17, 1023, 32, 32, 3, 3, 32, 1, 3),  # 272 items of 64 rows are too few: 32 rows
    (4, 2, 1023, 32, 32, 3, 3, 16, 1, 3),  # few items at every height: the shortest
    (1, 64, 1023, 512, 512, 3, 3, 128, 1, 3),  # 256 channel tiles: two blocks a tile
    (1, 8, 600, 64, 64, 15, 15, 128, 8, 2),  # 15 x 15: 8 groups of 2 kernel rows
])
def test_band_plan_takes_the_first_item_height_that_fits(K, B, Lp, cin, cout, kh, kw, rt,
                                                         groups, kr):
    """The item height is the tallest whose ring fits and whose items give
    every block 4 on average, else the shortest that fits; kernel rows split
    into groups where a block's slabs pass 60 or its taps 32 bits."""

    plan = cuda_fold.dw_mma_plan(K, B, Lp, cin, cout, kh, kw, Lp // 2)
    assert plan.band == 1
    assert (plan.rt, plan.groups, plan.kr) == (rt, groups, kr)
    cib = min(2, cin // 16)
    assert plan.kr * kw * cib <= cuda_fold.BAND_MAX_SLABS and plan.kr * kw <= 32
    assert plan.mtiles == -(-(kr * kw * cib) // 4) <= plan.consumers * cuda_fold.BAND_WG_TILES
    ys = plan.tiles * plan.groups
    assert plan.blocks % 2 == 0 and plan.blocks * ys <= max(132, 2 * ys)
    for taller in (r for r in cuda_fold.BAND_ROWS if r > plan.rt):
        items = K * B * -(-Lp // taller)
        rows = -(-(taller + kw - 1) // 16) * 16
        stage = -(-((taller + kr * rows) * 64 + 4 * taller + 16) // 1024) * 1024
        assert items < 4 * plan.blocks or (231296 // stage) < 4


@pytest.mark.parametrize("Lp,dc,p,cycles", [(1023, -1, 511, 2), (1023, 1, 24, 22), (525, 2, 25, 21),
                                            (513, 0, 171, 3), (70, 1, 7, 10)])
def test_band_lane_masks_hold_the_item_table_validity(Lp, dc, p, cycles):
    """The producer's tap table of an item, read through each lane's masks
    at every k-step, holds the (tap, row) validity of the fold, rows past Lp
    invalid; a kernel row outside the item's live range has no valid row."""

    kh, kw, rt = 5, 5, 64
    kr, dc0 = kh, -(kh // 2)
    for t0 in (0, (Lp - 1) // rt * rt):  # the first item, and the last (rows past Lp)
        r_lo, r_hi = t0 // p, (min(t0 + rt, Lp) - 1) // p
        klo, khi = max(0, -r_hi - dc0), min(kr - 1, cycles - 1 - r_lo - dc0)
        words = tap_table(t0, rt, Lp, p, cycles, dc0, klo, khi, kr, kw)
        t = t0 + np.arange(rt)
        kri = dc - dc0
        for wj in range(kw):
            fold_valid = ((t < Lp) & (t // p + dc >= 0) & (t // p + dc < cycles)
                          & (t % p + wj - kw // 2 >= 0) & (t % p + wj - kw // 2 < p))
            if not klo <= kri <= khi:
                assert not fold_valid.any()
            tap = kri * kw + wj
            for ks in range(rt // ROWS):
                for lane in range(32):
                    masks = band_lane_masks(words, tap, ks, lane)
                    q2 = 2 * (lane % 4)
                    for reg, base in enumerate((16 * ks + q2, 16 * ks + 8 + q2)):
                        for half in range(2):
                            bits = (masks[reg] >> (16 * half)) & 0xFFFF
                            assert bits == (0xFFFF if fold_valid[base + half] else 0)


@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_band_model_matches_plain_and_jax_at_long_context(kh, kw):
    """The dynamic long-context fold (L=512, Lp=1023, p_cap 511, K=4 at
    periods such as the hourly data's) at B=1, on the tiling of the B=64
    call (128-row items, 132 blocks in clusters of 2): every row of Lp, the
    last item's rows past Lp, bands that leave [0, Lp), skipped kernel rows
    and items included."""

    L, periods = 512, [511, 168, 24, 7]
    h, ct = _inputs(kh, len(periods), 1, 2 * L - 1, 32, 32)
    geom, plain, want = _references(h, ct, periods, L, kh, kw)
    plan = cuda_fold.dw_mma_plan(4, 64, 2 * L - 1, 32, 32, kh, kw, L - 1)
    got, plan = band_model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, L - 1,
                              plan)
    assert plan.band == 1 and plan.lp_pad == 1024 and plan.rt == 128
    _assert_close(got, plain, "plain")
    _assert_close(got, want, "JAX")


@pytest.mark.parametrize("p", [25, 171])
@pytest.mark.parametrize("kh,kw", [(3, 3), (5, 5)])
def test_band_model_matches_plain_at_the_exact_extent(kh, kw, p):
    """The frozen long-context path: K=1, Lp = total (525 at p=25, 513 at
    p=171), p_max = p, at B=9: 64-row items, 81 of them over 132 blocks."""

    L = 512
    geom = fold.make_dense_geometry(p, L)
    h, ct = _inputs(p + kh, 1, 9, geom.Lp, 32, 32)
    plain = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct), kh, kw).numpy()
    plan = cuda_fold.dw_mma_plan(1, 64, geom.Lp, 32, 32, kh, kw, geom.p_max)
    got, plan = band_model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw,
                              geom.p_max, plan)
    assert plan.band == 1 and plan.rt == 64 and geom.Lp == {25: 525, 171: 513}[p]
    _assert_close(got, plain, "plain")


def test_band_model_takes_kernel_row_groups_and_wide_channels():
    """7x7 over 48 input and 40 output channels: two kernel-row groups
    (4 + 3 rows), a half-used input-channel tile (16 of 32) and a
    partly-filled output tile (8 of 32), against the plain version."""

    L, periods, kh, kw = 80, [79, 6], 7, 7
    h, ct = _inputs(3, len(periods), 2, 2 * L - 1, 48, 40)
    geom = fold.make_geometry(torch.tensor(periods, dtype=torch.int32), L, L - 1)
    plain = fold.tap_weight_grad(torch.from_numpy(h), geom, torch.from_numpy(ct), kh, kw).numpy()
    got, plan = band_model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, L - 1)
    assert (plan.band, plan.groups, plan.kr, plan.tiles) == (1, 2, 4, 4)
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
    got, plan = band_model_dw(h, ct, geom.periods.numpy(), geom.cycles.numpy(), kh, kw, L - 1)
    assert plan.band == 1
    _assert_close(got, plain, "plain")
    _assert_close(got, want, "JAX")


@pytest.mark.parametrize("start", [0, 1, 2, 3, 5, 6, 7, 9, 13])
def test_swizzle64_matrices_fall_in_distinct_banks(start):
    """Eight consecutive 64-byte rows of one 16-byte chunk, an ldmatrix
    matrix at any tap offset, lie in eight distinct 16-byte bank groups
    under the 64-byte swizzle, and the swizzle is a permutation of each
    row's chunks."""

    for c in range(4):
        groups = {(swizzle64(start + r, c) // 16) % 8 for r in range(8)}
        assert len(groups) == 8
    for r in range(start, start + 8):
        assert sorted(swizzle64(r, c) - 64 * r for c in range(4)) == [0, 16, 32, 48]


@pytest.mark.parametrize("wj,cb", [(0, 0), (1, 1), (3, 0), (4, 1), (6, 1)])
def test_swizzled_fragment_addresses_load_the_masked_a_operand(wj, cb):
    """A band staged as TMA writes it (64-byte swizzle) read back by
    ldmatrix.trans at the kernel's lane addresses (its a_off at a k-step)
    gives the slab's A[ci, t] = h[t + wj, 16 cb + ci] in the m16n8k16 A
    layout that wgmma takes from registers; the lane masks then keep the
    valid rows' bf16 bits and turn the rest, stale NaN included, to +0."""

    rng = np.random.default_rng(wj * 7 + cb)
    rows = 80
    band = rng.standard_normal((rows, 32)).astype(np.float32)
    band[5, :] = np.nan  # a stale row that the masks must clear
    smem = np.full((rows * 4, 8), np.inf, np.float32)  # 16-byte chunks of shared memory
    for r in range(rows):
        for c in range(4):
            smem[swizzle64(r, c) // 16] = band[r, 8 * c:8 * c + 8]
    for ks in range(3):
        addrs = []
        for lane in range(32):
            a_row, a_chunk = (lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1
            off = swizzle64(wj + a_row, 2 * cb + a_chunk) + 1024 * ks
            assert off % 16 == 0
            addrs.append((off // 16, 0))
        frag = ldmatrix(smem, addrs, trans=True)
        want = band[16 * ks + wj:16 * ks + wj + 16, 16 * cb:16 * cb + 16].T
        np.testing.assert_array_equal(a_matrix(frag), want)
        valid = ~np.isnan(band[16 * ks + wj:16 * ks + wj + 16, 0])
        words = np.where(valid, np.uint64(1) << np.uint64(9), np.uint64(0))
        bits = torch.from_numpy(frag).bfloat16().view(torch.int16).numpy().astype(np.uint16)
        for lane in range(32):
            rows = np.concatenate([np.zeros(16 * ks, np.uint64), words])
            masks = band_lane_masks(rows, 9, ks, lane)
            for reg in range(4):
                packed = int(bits[lane, reg, 0]) | (int(bits[lane, reg, 1]) << 16)
                out = packed & masks[reg // 2]
                for half in range(2):
                    t = 2 * (lane % 4) + half + 8 * (reg // 2)
                    want_bits = int(bits[lane, reg, half]) if valid[t] else 0
                    assert (out >> (16 * half)) & 0xFFFF == want_bits


def test_band_accumulators_cover_each_slab_once():
    """The epilogue's map of a thread's wgmma m64n32k16 accumulators (warp
    w's rows 16 w .. 16 w + 15, d[4 n + e] at row g + 8 (e // 2), column
    8 n + 2 q + e % 2) to the partial-sum buffer covers each (channel,
    output channel) of each of the warpgroup's slabs once, in rows of
    ``BAND_RED_STRIDE`` floats where each half-warp's float2 stores take 16
    distinct bank pairs."""

    stride = cuda_fold.BAND_RED_STRIDE
    seen = np.zeros((4, 16, 32), int)
    for w in range(4):
        for n in range(4):
            for half in range(2):
                pairs = []
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    row = g + 8 * half
                    seen[w, row, 8 * n + 2 * q:8 * n + 2 * q + 2] += 1
                    word = (w * 16 + row) * stride + 8 * n + 2 * q
                    assert word % 2 == 0
                    pairs.append((word % 32) // 2)
                assert len(set(pairs[:16])) == 16 and len(set(pairs[16:])) == 16
    assert (seen == 1).all()


@pytest.mark.parametrize("kh", [3, 5])
def test_band_skips_items_and_kernel_rows_no_row_reaches(kh):
    """At the dynamic long-context call (periods 511, 168, 24, 7; B=64): the
    kernel rows no row of an item reaches are neither staged nor multiplied
    (at p=511, cycles 2: dc = +2 never, dc = -2 only in the item holding row
    1022; at 3x3 one of dc = +-1 in every item but the one holding row 511),
    and the items past each period's reach are skipped whole."""

    K, B, Lp, L = 4, 64, 1023, 512
    periods = np.array([511, 168, 24, 7])
    cycles = -(-L // periods)
    plan = cuda_fold.dw_mma_plan(K, B, Lp, 32, 32, kh, kh, L - 1)
    rh = kh // 2
    live_rows = {k: [] for k in range(K)}
    for i in range(K * B * plan.lp_pad // plan.rt):
        seq, t0, p, cyc, klo, khi = band_item(i, K, B, Lp, plan, periods, cycles, L - 1, -rh, kh)
        if seq % B == 0:
            live_rows[seq // B].append((t0, klo, khi))
    for t0, klo, khi in live_rows[0]:  # p=511: rows 0 and 1 of the fold, and row 1022 in row 2
        assert khi < kh - 1 if kh == 5 else True  # dc = +2 reads row -1 or -2: never
        if kh == 5:
            assert (klo == 0) == (t0 + plan.rt > 1022)  # dc = -2: only row 1022 reaches it
        if kh == 3 and not t0 <= 511 < t0 + plan.rt:
            assert khi - klo == 1
    for k in (2, 3):
        p, cyc = int(periods[k]), int(cycles[k])
        for t0, klo, khi in live_rows[k]:
            assert (klo > khi) == (t0 // p > cyc - 1 + rh)
    dead = sum(klo > khi for rows in live_rows.values() for _, klo, khi in rows)
    assert dead == {3: 7, 5: 6}[kh]  # of the 4 x 8 row tiles of one sequence a candidate


@pytest.mark.parametrize("shape", [
    (2, 4, 900, 8192, 8192, 3, 3, 899),  # 65,536 channel tiles: more than a grid's y
    (1, 4, 600, 4096, 8192, 15, 15, 599),  # 32,768 tiles x 8 kernel-row groups
    (1, 4, 600, 2048, 2048, 15, 15, 599),  # 4,096 tiles x 8 groups is 32,768: taken
])
def test_band_plan_refuses_more_blocks_than_a_grid_holds(shape):
    """Band 1 takes any channel count (32-channel tiles); it refuses only
    more channel tiles x kernel-row groups than a grid's y holds."""

    if shape[3] * shape[4] < 2 ** 23:
        assert cuda_fold.dw_mma_plan(*shape).band == 1
        return
    with pytest.raises(RuntimeError, match="cudaError_t 1 .*more blocks or items than a grid"):
        cuda_fold.dw_mma_plan(*shape)
