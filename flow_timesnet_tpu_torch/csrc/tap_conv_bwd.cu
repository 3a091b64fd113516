// Backward of the masked dilated-tap fold convolution for Hopper (sm_90a):
// the dh adjoint and the weight gradient dW.
//
// tap_conv_dh replaces flow_timesnet_tpu/ops/pallas_fold.py::
// _tap_conv_pallas_impl with sign=-1 (the TPU kernel of the Pallas
// backward) in float32; in bf16 that is tap_conv_mma.cu's tensor-core
// template, instantiated for sign=-1. tap_conv_dw replaces the XLA contraction
// flow_timesnet_tpu/ops/fold.py::_tap_weight_grad, which the Pallas backward
// keeps in XLA too; on the card its only alternative would be the plain
// version, so it is written by hand beside the adjoint. Both compute the XLA
// form of the JAX package's custom VJP (ops/fold.py::_tap_conv_bwd), as the
// plain versions in flow_timesnet_tpu_torch/ops/fold.py do: the cotangent
// and W arrive rounded to h's type, products of the (possibly bf16) values
// are exact in float32 and are summed in float32. In float32 that equals the
// Pallas backward.
//
// With p = periods[k], cycles = cycles[k], total = cycles * p, and the fold
// coordinates row(x) = x / p, col(x) = x % p:
//
//   dh[k,b,s,:] = [s < total] sum_{dc,dj} [0 <= col(s) - dj < p]
//                 [0 <= t < Lp] ct[k,b,t,:] @ W[dc,dj]^T,
//                 t = (row(s) - dc) * p + col(s) - dj
//   dW[dc,dj]   = sum_{k,b,t} [0 <= row(t) + dc < cycles] [0 <= col(t) + dj < p]
//                 h[k,b,t + dc*p + dj,:]^T ct[k,b,t,:]
//
// The first line is ops/fold.py::_bwd_mask written out: that mask takes
// (s - dj) mod p and floor((s - dj) / p), which in C++ would truncate toward
// zero for s - dj < 0 (row 0 instead of -1). Here every division and
// modulo is of a non-negative s or t, where truncation is the floor: a tap
// is valid iff the column col(s) - dj stays in the period row, and then
// t >= 0 iff row(s) >= dc. The masks do not bound row(s) - dc above by
// cycles: forward outputs at rows [total, Lp) read the grid, so their
// cotangent flows back into it. dh rows [total, Lp) come out exactly 0.
//
// Design of tap_conv_dh (float32 only, on the CUDA cores, whose float32
// FMAs keep the products exact; TF32 tensor cores would keep about three
// digits): it mirrors tap_conv_fwd.cu's float32 kernel: one block per (k, b) sequence and tile of
// rows, the whole cotangent sequence staged in shared memory as float32, one
// kernel row of W staged at a time, transposed to [kw, Cout, Cin] so that the
// lanes of a warp (consecutive ci) read consecutive W words while they share
// one cotangent word. An invalid tap is skipped, not multiplied by zero, and
// no padded copy of ct is made.
//
// dW has two routes, chosen by the caller by dtype (ops/cuda_fold.py
// tap_conv_dw_cuda); neither gives way to the other. Both are a split-K
// reduction over the K*B sequences with no float atomics: pass 1 writes one
// partial dW per chunk of sequences into a scratch buffer the caller
// allocates, [chunks, kh, kw, Cin, Cout], and pass 2 sums every element over
// the chunks in chunk order, so the same inputs give the same bits from run
// to run.
// - float32 (tap_conv_dw): float32 FMAs on the CUDA cores, so the products
//   stay exact (TF32 tensor cores would keep about three digits). Block
//   (dc, chunk) owns one kernel row of dW, [kw, Cin, Cout] accumulators
//   spread over its threads (lane = co, so a warp shares each h word and
//   reads consecutive ct words), and stages h and ct of each sequence of its
//   chunk in shared memory.
// - bf16 (tap_conv_dw_mma): the tensor cores; see the note above
//   tap_conv_dw_mma_kernel.
//
// What bounds them on an H100 SXM (data-sheet figures, not measured): at the
// flagship training shape K=2, B=256, Lp=55, Cin=Cout=32 in bf16, counting
// all kh*kw taps, each is 0.52 / 1.44 / 2.83 GFLOP at 3x3 / 5x5 / 7x7
// (0.5 / 1.5 / 2.9 us at 989 TFLOP/s on the tensor cores); dh moves 5.4 MB
// (ct in, dh out in float32: 1.6 us at 3.35 TB/s), dW 3.6 MB (h and ct in,
// 1.1 us): bytes bound both. chip_smoke.py measures them beside the bounds
// of the taps the selected periods leave valid, and PERF.md keeps the
// numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma_ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOutsPerThread = 8;  // dh: outputs (row, channel) per thread
constexpr int kOutsPerBlock = kThreads * kOutsPerThread;
constexpr int kDwAccPerThread = 32;  // dW float32: accumulators per thread
constexpr int kDwTargetBlocks = 4 * 132;  // dW float32 pass 1: about four blocks per SM
constexpr int kMaxSmemBytes = 232448;  // 227 KB: the most one block may use

// dW bf16 (tensor cores). ops/cuda_fold.py::dw_mma_plan mirrors the plan
// below, constant for constant; a card test holds the two against each other.
constexpr int kMmaRows = 16;     // rows of a sequence per mma k-step
constexpr int kWarpTile = 32;    // a warp's dW tile: 32 ci x 32 co, 2 x 4 mma tiles
constexpr int kRowPad = 8;       // bf16 added to each staged row: conflict-free ldmatrix
constexpr int kMmaMaxWarps = 16;  // one warp per tap of a kernel row: kw <= 16
constexpr int kMmaStages = 4;  // staged sequences in the ring: three loads in flight
constexpr int kMmaTargetWarps = 8 * 132;  // pass 1: about 8 warps per SM in all

__global__ void __launch_bounds__(kThreads)
tap_conv_dh_kernel(const float* __restrict__ ct, const float* __restrict__ w,
                   const int* __restrict__ periods, const int* __restrict__ cycles,
                   float* __restrict__ dh, int B, int Lp, int Cin, int Cout, int kh, int kw,
                   int rows_per_tile) {
  extern __shared__ float smem[];
  float* ct_s = smem;             // [Lp, Cout]: the whole (k, b) cotangent
  float* w_s = smem + Lp * Cout;  // [kw, Cout, Cin]: one kernel row of W, transposed

  const int tiles = (Lp + rows_per_tile - 1) / rows_per_tile;
  const int seq = blockIdx.x / tiles;  // k * B + b
  const int s0 = (blockIdx.x % tiles) * rows_per_tile;
  const int n_out = min(rows_per_tile, Lp - s0) * Cin;
  const int k = seq / B;
  const int p = max(periods[k], 1);
  const int total = cycles[k] * p;
  const int rh = kh / 2, rw = kw / 2;

  const float* ct_seq = ct + static_cast<size_t>(seq) * Lp * Cout;
  for (int i = threadIdx.x; i < Lp * Cout; i += kThreads) ct_s[i] = ct_seq[i];

  float acc[kOutsPerThread];
#pragma unroll
  for (int i = 0; i < kOutsPerThread; ++i) acc[i] = 0.f;

  const int row_elems = kw * Cin * Cout;
  for (int dc = -rh; dc <= rh; ++dc) {
    __syncthreads();  // the previous W row is consumed; ct_s is complete
    const float* w_row = w + static_cast<size_t>(dc + rh) * row_elems;
    for (int i = threadIdx.x; i < row_elems; i += kThreads) {
      const int j = i / (Cin * Cout), ci = (i / Cout) % Cin, co = i % Cout;
      w_s[(j * Cout + co) * Cin + ci] = w_row[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOutsPerThread; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o >= n_out) continue;
      const int s = s0 + o / Cin;
      const int ci = o % Cin;
      if (s >= total) continue;  // outside the fold grid: dh is 0
      const int r = s / p - dc;  // the cotangent's row; s >= 0, so s / p is the floor
      if (r < 0) continue;
      const int cs = s % p;
      float a = acc[i];
      for (int dj = -rw; dj <= rw; ++dj) {
        const int c = cs - dj;
        const int t = r * p + c;  // == s - dc*p - dj
        if (c < 0 || c >= p || t >= Lp) continue;
        const float* cts = ct_s + t * Cout;
        const float* ws = w_s + (dj + rw) * Cout * Cin + ci;
#pragma unroll 4
        for (int co = 0; co < Cout; ++co) a = fmaf(cts[co], ws[co * Cin], a);
      }
      acc[i] = a;
    }
  }

  float* dh_seq = dh + static_cast<size_t>(seq) * Lp * Cin + static_cast<size_t>(s0) * Cin;
#pragma unroll
  for (int i = 0; i < kOutsPerThread; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < n_out) dh_seq[o] = acc[i];
  }
}

// Pass 1 of dW in float32: block (dc + rh, chunk) sums kernel row dc over its
// chunk of sequences. A thread owns the outputs (f, co) with co = threadIdx.x % Cout
// and f = dj_index * Cin + ci = threadIdx.x / Cout + j * (kThreads / Cout);
// the tap (dc, dj) at output row t reads h at (row(t) + dc) * p + col(t) + dj,
// whose index in the staged [Lp, Cin] sequence is base + f with
// base = ((row(t) + dc) * p + col(t) - rw) * Cin, and it is valid iff
// 0 <= col(t) + dj < p, i.e. (rw - col(t)) * Cin <= f < (rw - col(t) + p) * Cin.
__global__ void __launch_bounds__(kThreads)
tap_conv_dw_partial_kernel(const float* __restrict__ h, const float* __restrict__ ct,
                           const int* __restrict__ periods, const int* __restrict__ cycles,
                           float* __restrict__ partial, int n_seq, int B, int Lp, int Cin,
                           int Cout, int kh, int kw, int seqs_per_chunk) {
  extern __shared__ float smem[];
  float* h_s = smem;              // [Lp, Cin]
  float* ct_s = smem + Lp * Cin;  // [Lp, Cout]

  const int row = blockIdx.x;  // dc + rh
  const int dc = row - kh / 2;
  const int rw = kw / 2;
  const int chunk = blockIdx.y;
  const int co = threadIdx.x % Cout;
  const int g = threadIdx.x / Cout;
  const int groups = kThreads / Cout;
  const int n_f = kw * Cin;

  float acc[kDwAccPerThread];
#pragma unroll
  for (int j = 0; j < kDwAccPerThread; ++j) acc[j] = 0.f;

  const int seq_end = min(n_seq, (chunk + 1) * seqs_per_chunk);
  for (int seq = chunk * seqs_per_chunk; seq < seq_end; ++seq) {
    const int k = seq / B;
    const int p = max(periods[k], 1);
    const int cyc = cycles[k];
    __syncthreads();  // the previous sequence is consumed
    const float* h_seq = h + static_cast<size_t>(seq) * Lp * Cin;
    const float* ct_seq = ct + static_cast<size_t>(seq) * Lp * Cout;
    for (int i = threadIdx.x; i < Lp * Cin; i += kThreads) h_s[i] = h_seq[i];
    for (int i = threadIdx.x; i < Lp * Cout; i += kThreads) ct_s[i] = ct_seq[i];
    __syncthreads();
    for (int t = 0; t < Lp; ++t) {
      const int r = t / p + dc;  // the same for every thread of the block
      if (r < 0 || r >= cyc) continue;
      const int c = t % p;
      const float ctv = ct_s[t * Cout + co];
      const int base = (r * p + c - rw) * Cin;  // base + f >= r * p * Cin >= 0 when valid
      const int lo = (rw - c) * Cin, hi = (rw - c + p) * Cin;
#pragma unroll
      for (int j = 0; j < kDwAccPerThread; ++j) {
        const int f = g + j * groups;
        if (f < n_f && f >= lo && f < hi) acc[j] = fmaf(h_s[base + f], ctv, acc[j]);
      }
    }
  }

  // partial: [chunks, kh, kw * Cin, Cout], the layout of dW per chunk
  float* out = partial + (static_cast<size_t>(chunk) * gridDim.x + row) * n_f * Cout;
#pragma unroll
  for (int j = 0; j < kDwAccPerThread; ++j) {
    const int f = g + j * groups;
    if (f < n_f) out[f * Cout + co] = acc[j];
  }
}

// Pass 2 of dW: each element summed over the chunks in chunk order.
__global__ void __launch_bounds__(kThreads)
tap_conv_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                          int n_elems, int chunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_elems) return;
  float a = 0.f;
  for (int c = 0; c < chunks; ++c) a += partial[static_cast<size_t>(c) * n_elems + i];
  dw[i] = a;
}

// wait until at most kMmaStages - 2 groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmaStages - 2) : "memory");
}

// Pass 1 of dW in bf16, on the tensor cores. It replaces the XLA contraction
// flow_timesnet_tpu/ops/fold.py:265 (_tap_weight_grad) in its bf16 form.
// Bytes bound it on an H100 SXM (data-sheet figures): h and ct, 3.6 MB at
// the flagship shape, take 1.1 us at 3.35 TB/s, more than the multiply-adds
// of the taps the fold leaves valid at the training path's periods take at
// 989 TFLOP/s. The kernel multiplies every tap and masks it, 2.83 GFLOP at
// 7x7: 2.9 us at that rate.
//
// Tap (dc, dj) of dW is a product that contracts over the rows t of each
// sequence: dW[dc,dj] += A B with A[ci, t] = h[t + dc*p + dj, ci] and
// B[t, co] = valid(dc, dj, t) * ct[t, co]. Block (kernel row dc, 32 x 32
// channel tile, chunk) has one warp per tap dj of that row, and the warp
// keeps the tap's 32 x 32 tile in 32 float32 registers a thread: 2 x 4
// tiles of mma.sync m16n8k16 (bf16 in, float32 sums). A sequence is
// lp_pad / 16 k-steps of 16 rows (Lp = 55: 4, rows 55-63 masked). wgmma
// would need 64-row tiles of dW and Cin is 32, so mma.sync is the fit.
//
// What the design does about what held the CUDA-core version back:
// - Multiply-adds: one mma does 2,048 of them, on bf16 fragments that
//   ldmatrix.trans loads from shared memory (h and ct stay bf16 there; rows
//   padded by 8 elements so that the 8 rows of a matrix hit distinct banks).
// - Masks are data, not branches: h is staged between `pad` zero rows on
//   each side, pad >= (kh/2) * p_max + kw/2 >= |dc*p + dj|, so every
//   shifted fragment load lies in the buffer and reads h or a zero (never
//   stale bits, which could be Inf or NaN and poison a product with 0).
//   Validity, t < Lp included, is a bitwise AND on the packed pairs of the
//   B fragment: it turns whatever the masked pair held into +0. The AND
//   masks of a thread, per warp (tap) and k-step, are built once per block
//   from a table of row(t) = t / p and col(t) = t % p for t >= 0, so both
//   are the floor (the reasoning of the header, over non-negative t).
// - Staging overlaps compute: a chunk holds sequences of one candidate k
//   (one period per block), staged with cp.async into a ring of kMmaStages
//   buffers: sequences i + 1 to i + 3 load while sequence i multiplies,
//   behind one barrier per sequence. (With two buffers, one load in flight,
//   a sequence's multiply-adds at 3x3 take less time than its load, so a
//   deeper ring keeps more of them in flight.)
// - Scratch: about 8 warps per SM in all, so 104 / 40 / 22 chunks at
//   3x3 / 5x5 / 7x7 (3.8 / 4.1 / 4.4 MB of float32 partials, against
//   6.3 / 10.5 / 14.9 MB for the CUDA-core version's bf16 plan), summed by
//   the same fixed-order pass 2: no float atomics, the same bits every run.
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
tap_conv_dw_mma_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ ct,
                       const int* __restrict__ periods, const int* __restrict__ cycles,
                       float* __restrict__ partial, int B, int Lp, int Cin, int Cout, int kh,
                       int kw, int p_max, int lp_pad, int pad, int co_tiles, int chunks_per_k,
                       int per_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride_in = Cin + kRowPad, stride_out = Cout + kRowPad;
  const int h_elems = (lp_pad + 2 * pad) * stride_in;  // [pad | Lp rows | pad + lp_pad - Lp]
  const int buf_elems = h_elems + lp_pad * stride_out;  // staged h, then staged ct [lp_pad]
  const int ksteps = lp_pad / kMmaRows;
  auto* bufs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // the ring: kMmaStages buffers
  auto* mask_s = reinterpret_cast<uint2*>(bufs + kMmaStages * buf_elems);  // [kw][ksteps][32]
  int* row_s = reinterpret_cast<int*>(mask_s + kw * ksteps * 32);  // [lp_pad]: row(t)
  int* col_s = row_s + lp_pad;  // [lp_pad]: col(t)

  const int rh = kh / 2, rw = kw / 2;
  const int tiles = gridDim.x / kh;
  const int dc = static_cast<int>(blockIdx.x) / tiles - rh;
  const int tile = blockIdx.x % tiles;
  const int ci0 = (tile / co_tiles) * kWarpTile, co0 = (tile % co_tiles) * kWarpTile;
  const int chunk = blockIdx.y;  // k * chunks_per_k + chunk within k
  const int k = chunk / chunks_per_k;
  const int b0 = (chunk % chunks_per_k) * per_chunk;
  const int n_seq = min(per_chunk, B - b0);
  const int p = min(max(periods[k], 1), p_max);  // make_geometry's clamp; the pad assumes it
  const int cyc = cycles[k];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the zero rows around the staged h, in every buffer; cp.async never writes them
  const int vec_row = stride_in / 8, vec_lo = pad * vec_row, vec_hi = (pad + Lp) * vec_row;
  const int vec_zero = vec_lo + h_elems / 8 - vec_hi;
  for (int i = threadIdx.x; i < kMmaStages * vec_zero; i += blockDim.x) {
    const int j = i % vec_zero;
    reinterpret_cast<uint4*>(bufs + (i / vec_zero) * buf_elems)[j < vec_lo ? j : vec_hi + j - vec_lo] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  for (int t = threadIdx.x; t < lp_pad; t += blockDim.x) {
    row_s[t] = t / p;
    col_s[t] = t % p;
  }

  const int vin = Cin / 8, vout = Cout / 8;  // 16-byte vectors of a global row
  auto stage = [&](int i) {  // sequence i of the chunk into its buffer, asynchronously
    const int b = b0 + i, buf = i % kMmaStages;
    const size_t seq = static_cast<size_t>(k) * B + b;
    const __nv_bfloat16* hg = h + seq * Lp * Cin;
    const __nv_bfloat16* cg = ct + seq * Lp * Cout;
    __nv_bfloat16* hs = bufs + buf * buf_elems + pad * stride_in;
    __nv_bfloat16* cs = bufs + buf * buf_elems + h_elems;
    const int nh = Lp * vin, n = nh + Lp * vout;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (i < nh) {
        cp_async16(hs + (i / vin) * stride_in + (i % vin) * 8, hg + static_cast<size_t>(i) * 8);
      } else {
        const int j = i - nh;
        cp_async16(cs + (j / vout) * stride_out + (j % vout) * 8, cg + static_cast<size_t>(j) * 8);
      }
    }
  };
  // one commit group per sequence, empty past the chunk's end, so that
  // group i is complete once at most kMmaStages - 2 newer ones are pending
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (i < n_seq) stage(i);
    cp_async_commit();
  }
  __syncthreads();  // the row/col table

  // B-fragment masks: lane l of warp w holds, at k-step ks, the pairs of rows
  // t0 + {0, 1} (register 0) and t0 + {8, 9} (register 1), t0 = 16 ks + 2 (l % 4)
  for (int i = threadIdx.x; i < kw * ksteps * 32; i += blockDim.x) {
    const int w = i / (ksteps * 32), ks = (i / 32) % ksteps, l = i % 32;
    const int t0 = ks * kMmaRows + 2 * (l % 4);
    uint32_t m[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + (j & 1) + 8 * (j >> 1);
      const int r = row_s[t] + dc, c = col_s[t] + w - rw;
      if (t < Lp && r >= 0 && r < cyc && c >= 0 && c < p) m[j >> 1] |= (j & 1) ? 0xffff0000u : 0xffffu;
    }
    mask_s[i] = make_uint2(m[0], m[1]);
  }

  // m-tile 0 always lies inside Cin (ci0 < Cin); the others as the channels allow
  const bool m_on1 = ci0 + 16 < Cin;
  bool n_on[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) n_on[nt] = co0 + 8 * nt < Cout;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // ldmatrix addresses: A's matrices are (ci 0-7, t 0-7), (ci 8-15, t 0-7),
  // (ci 0-7, t 8-15), (ci 8-15, t 8-15); B's pair of n-tiles (t 0-7, co 0-7),
  // (t 8-15, co 0-7), (t 0-7, co 8-15), (t 8-15, co 8-15)
  const int a_row = (lane & 7) + ((lane >> 4) << 3), a_col = ci0 + ((lane >> 3) & 1) * 8;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_col = co0 + (lane >> 4) * 8;
  const int shift = pad + dc * p + (warp - rw);  // output row t reads staged h row shift + t
  const uint2* my_mask = mask_s + warp * ksteps * 32 + lane;

  for (int i = 0; i < n_seq; ++i) {
    cp_async_wait_ring();
    __syncthreads();  // sequence i is staged everywhere; sequence i - 1's buffer is free
    if (i + kMmaStages - 1 < n_seq) stage(i + kMmaStages - 1);
    cp_async_commit();
    const __nv_bfloat16* hs = bufs + (i % kMmaStages) * buf_elems;
    const __nv_bfloat16* cs = hs + h_elems;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int t0 = ks * kMmaRows;
      uint32_t b[4][2] = {};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!n_on[2 * q]) continue;
        uint32_t r[4];
        ldmatrix_x4_trans(r, cs + (t0 + b_row) * stride_out + b_col + 16 * q);
        b[2 * q][0] = r[0];
        b[2 * q][1] = r[1];
        b[2 * q + 1][0] = r[2];
        b[2 * q + 1][1] = r[3];
      }
      const uint2 m = my_mask[ks * 32];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt][0] &= m.x;
        b[nt][1] &= m.y;
      }
      uint32_t a[2][4] = {};
      const __nv_bfloat16* arow = hs + (shift + t0 + a_row) * stride_in + a_col;
      ldmatrix_x4_trans(a[0], arow);
      if (m_on1) ldmatrix_x4_trans(a[1], arow + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if ((mt == 0 || m_on1) && n_on[nt]) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }

  // partial: [chunks, kh, kw, Cin, Cout]; the accumulator pair (e, e + 1)
  // of tile (mt, nt) is (ci, co + {0, 1}), e = 2 adds 8 to ci
  float* out = partial + ((static_cast<size_t>(chunk) * kh + dc + rh) * kw + warp) * Cin * Cout;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (!((mt == 0 || m_on1) && n_on[nt])) continue;
      const int ci = ci0 + 16 * mt + (lane >> 2), co = co0 + 8 * nt + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + ci * Cout + co) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (ci + 8) * Cout + co) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

bool bad_shape(int K, int B, int Lp, int Cin, int Cout, int kh, int kw) {
  return K <= 0 || B <= 0 || Lp <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 || kw <= 0 ||
         kh % 2 == 0 || kw % 2 == 0;
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel* kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int dw_chunks(int K, int B, int kh) {
  const int n_seq = K * B;
  const int want = std::max(1, std::min(n_seq, (kDwTargetBlocks + kh - 1) / kh));
  const int per_chunk = (n_seq + want - 1) / want;
  return (n_seq + per_chunk - 1) / per_chunk;
}

int launch_dh(const float* ct, const float* w, const int* periods, const int* cycles, float* dh,
              int K, int B, int Lp, int Cin, int Cout, int kh, int kw, cudaStream_t stream) {
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw) || Cin > kOutsPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (static_cast<size_t>(Lp) * Cout +
                                       static_cast<size_t>(kw) * Cin * Cout);
  cudaError_t err = reserve_smem(tap_conv_dh_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_tile = std::min(Lp, kOutsPerBlock / Cin);
  const int tiles = (Lp + rows_per_tile - 1) / rows_per_tile;
  const long long blocks = static_cast<long long>(K) * B * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tap_conv_dh_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      ct, w, periods, cycles, dh, B, Lp, Cin, Cout, kh, kw, rows_per_tile);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_reduce(const float* partial, float* dw, int n_elems, int chunks,
                     cudaStream_t stream) {
  tap_conv_dw_reduce_kernel<<<(n_elems + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, dw, n_elems, chunks);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw(const float* h, const float* ct, const int* periods, const int* cycles,
              float* partial, float* dw, int K, int B, int Lp, int Cin, int Cout, int kh,
              int kw, cudaStream_t stream) {
  // a thread owns kDwAccPerThread outputs of one column co of a kernel row
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw) || kThreads % Cout != 0 ||
      static_cast<long long>(kw) * Cin > static_cast<long long>(kDwAccPerThread) * (kThreads / Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(Lp) * (Cin + Cout);
  cudaError_t err = reserve_smem(tap_conv_dw_partial_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_seq = K * B;
  const int chunks = dw_chunks(K, B, kh);
  const int per_chunk = (n_seq + chunks - 1) / chunks;
  tap_conv_dw_partial_kernel<<<dim3(kh, chunks), kThreads, smem, stream>>>(
      h, ct, periods, cycles, partial, n_seq, B, Lp, Cin, Cout, kh, kw, per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_dw_reduce(partial, dw, kh * kw * Cin * Cout, chunks, stream);
}

// The launch plan of tap_conv_dw_mma_kernel; mirrored by
// ops/cuda_fold.py::dw_mma_plan.
struct DwMmaPlan {
  int lp_pad;        // Lp rounded up to whole k-steps
  int pad;           // zero rows on each side of a staged h sequence
  int tiles;         // 32 x 32 channel tiles of dW
  int chunks_per_k;  // chunks of each candidate's B sequences
  int per_chunk;     // sequences of a chunk (the last one may hold fewer)
  int warps;         // warps of a block: one per tap of a kernel row
  int smem;          // dynamic shared memory of a block, bytes
  int chunks;        // K * chunks_per_k: the scratch holds chunks * kh * kw * Cin * Cout floats
};

// 0, or cudaErrorInvalidValue for a shape the kernel cannot take: Cin not a
// multiple of 16 (an mma's k-depth of A's transpose), Cout not a multiple of
// 8 (an mma's width), more than 16 taps in a kernel row, p_max outside
// [1, Lp], or a block that would need more shared memory than one SM has.
int dw_mma_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw, int p_max,
                DwMmaPlan* plan) {
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw) || Cin % 16 != 0 || Cout % 8 != 0 ||
      kw > kMmaMaxWarps || p_max < 1 || p_max > Lp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DwMmaPlan q;
  q.lp_pad = (Lp + kMmaRows - 1) / kMmaRows * kMmaRows;
  q.pad = (kh / 2) * p_max + kw / 2;
  const long long smem =
      2LL * kMmaStages *
          ((q.lp_pad + 2LL * q.pad) * (Cin + kRowPad) + 1LL * q.lp_pad * (Cout + kRowPad)) +
      8LL * kw * (q.lp_pad / kMmaRows) * 32 + 2LL * 4 * q.lp_pad;
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  q.smem = static_cast<int>(smem);
  q.tiles = ((Cin + kWarpTile - 1) / kWarpTile) * ((Cout + kWarpTile - 1) / kWarpTile);
  q.warps = kw;
  const int want = std::max(1, kMmaTargetWarps / (kh * q.tiles * kw));  // chunks in all
  const int per_k = std::min(B, (want + K - 1) / K);
  q.per_chunk = (B + per_k - 1) / per_k;
  q.chunks_per_k = (B + q.per_chunk - 1) / q.per_chunk;
  const long long chunks = 1LL * K * q.chunks_per_k;
  if (chunks > 65535 || 1LL * kh * q.tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  q.chunks = static_cast<int>(chunks);
  *plan = q;
  return 0;
}

}  // namespace

// The float32 route of dh (bf16 is tap_conv_mma.cu's tap_conv_dh_mma).
// ct: [K, B, Lp, Cout] and w: [kh, kw, Cin, Cout] float32; periods, cycles:
// [K] int32; dh: [K, B, Lp, Cin] float32. All contiguous, on the current
// device. Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tap_conv_dh(const void* ct, const void* w, const void* periods,
                           const void* cycles, void* dh, int K, int B, int Lp, int Cin,
                           int Cout, int kh, int kw, void* stream) {
  return launch_dh(static_cast<const float*>(ct), static_cast<const float*>(w),
                   static_cast<const int*>(periods), static_cast<const int*>(cycles),
                   static_cast<float*>(dh), K, B, Lp, Cin, Cout, kh, kw,
                   static_cast<cudaStream_t>(stream));
}

// The number of chunks tap_conv_dw splits the K*B sequences into: its
// scratch buffer `partial` holds chunks * kh * kw * Cin * Cout floats.
extern "C" int tap_conv_dw_chunks(int K, int B, int kh) {
  if (K <= 0 || B <= 0 || kh <= 0) return 0;
  return dw_chunks(K, B, kh);
}

// The float32 route. h: [K, B, Lp, Cin] and ct: [K, B, Lp, Cout] float32;
// periods, cycles: [K] int32; partial: scratch of tap_conv_dw_chunks(K, B, kh)
// * kh * kw * Cin * Cout float32; dw: [kh, kw, Cin, Cout] float32. All
// contiguous, on the current device. Returns a cudaError_t value: 0 on a
// successful launch of both passes.
extern "C" int tap_conv_dw(const void* h, const void* ct, const void* periods,
                           const void* cycles, void* partial, void* dw, int K, int B, int Lp,
                           int Cin, int Cout, int kh, int kw, void* stream) {
  return launch_dw(static_cast<const float*>(h), static_cast<const float*>(ct),
                   static_cast<const int*>(periods), static_cast<const int*>(cycles),
                   static_cast<float*>(partial), static_cast<float*>(dw), K, B, Lp, Cin, Cout,
                   kh, kw, static_cast<cudaStream_t>(stream));
}

// The plan of the bf16 route at this shape, into out[8] in the order of
// DwMmaPlan: lp_pad, pad, tiles, chunks_per_k, per_chunk, warps, smem,
// chunks. Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int tap_conv_dw_mma_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw,
                                    int p_max, int* out) {
  DwMmaPlan q;
  const int err = dw_mma_plan(K, B, Lp, Cin, Cout, kh, kw, p_max, &q);
  if (err != 0) return err;
  const int fields[8] = {q.lp_pad, q.pad, q.tiles, q.chunks_per_k,
                         q.per_chunk, q.warps, q.smem, q.chunks};
  std::copy(fields, fields + 8, out);
  return 0;
}

// The bf16 route, on the tensor cores. h: [K, B, Lp, Cin] and ct:
// [K, B, Lp, Cout] bf16, 16-byte aligned; periods, cycles: [K] int32, every
// period at most p_max (make_geometry's p_cap); partial: scratch of
// plan.chunks * kh * kw * Cin * Cout float32; dw: [kh, kw, Cin, Cout]
// float32. All contiguous, on the current device. Returns a cudaError_t
// value: 0 on a successful launch of both passes.
extern "C" int tap_conv_dw_mma(const void* h, const void* ct, const void* periods,
                               const void* cycles, void* partial, void* dw, int K, int B, int Lp,
                               int Cin, int Cout, int kh, int kw, int p_max, void* stream) {
  DwMmaPlan q;
  int err = dw_mma_plan(K, B, Lp, Cin, Cout, kh, kw, p_max, &q);
  if (err != 0) return err;
  if ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(ct)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);  // cp.async copies 16 bytes at a time
  }
  err = static_cast<int>(reserve_smem(tap_conv_dw_mma_kernel, q.smem));
  if (err != 0) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  tap_conv_dw_mma_kernel<<<dim3(kh * q.tiles, q.chunks), q.warps * 32, q.smem, s>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(ct),
      static_cast<const int*>(periods), static_cast<const int*>(cycles), part, B, Lp, Cin,
      Cout, kh, kw, p_max, q.lp_pad, q.pad, (Cout + kWarpTile - 1) / kWarpTile, q.chunks_per_k,
      q.per_chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_dw_reduce(part, static_cast<float*>(dw), kh * kw * Cin * Cout, q.chunks, s);
}
