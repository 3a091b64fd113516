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
- each sequence of h staged between zero rows, every shifted row read in
  bounds, 16-row k-steps whose rows beyond Lp hold NaN (stale shared
  memory) until the per-(tap, row) validity clears them, chunks that never
  straddle two candidates, and pass 2 summing the chunks in chunk order.

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
    """dW as the kernel computes it: pass 1 per chunk, pass 2 in chunk order."""

    K, B, Lp, cin = h.shape
    cout = ct.shape[-1]
    plan = cuda_fold.dw_mma_plan(K, B, Lp, cin, cout, kh, kw, p_max)
    rh, rw = kh // 2, kw // 2
    partial = np.zeros((plan.chunks, kh, kw, cin, cout), np.float32)
    validity = {}  # the kernel builds it per block; it depends on (p, cycles, dc) alone
    for chunk in range(plan.chunks):
        k, c = divmod(chunk, plan.chunks_per_k)  # one candidate per chunk
        seqs = range(c * plan.per_chunk, min(B, (c + 1) * plan.per_chunk))
        assert len(seqs) >= 1
        p, cyc = min(max(int(periods[k]), 1), p_max), int(cycles[k])
        for dc in range(-rh, rh + 1):
            key = (p, cyc, dc)
            if key not in validity:
                validity[key] = block_validity(plan, Lp, cyc, p, dc, kw)
            valid = validity[key]
            for b in seqs:
                staged = np.zeros((plan.lp_pad + 2 * plan.pad, cin), np.float32)
                staged[plan.pad:plan.pad + Lp] = h[k, b]
                ct_s = np.full((plan.lp_pad, cout), np.nan, np.float32)  # stale beyond Lp
                ct_s[:Lp] = ct[k, b]
                for w in range(kw):
                    shift = plan.pad + dc * p + w - rw
                    for t0 in range(0, plan.lp_pad, ROWS):
                        rows = shift + t0 + np.arange(ROWS)
                        assert 0 <= rows.min() and rows.max() < staged.shape[0]
                        b_frag = np.where(valid[w, t0:t0 + ROWS, None], ct_s[t0:t0 + ROWS], 0.0)
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
    ((2, 4, 900, 128, 128, 7, 7, 899), "shared memory"),
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
