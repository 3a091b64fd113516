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
// Each kernel has two routes, chosen by the caller by dtype
// (ops/cuda_fold.py); neither gives way to the other. bf16 runs the tensor
// cores (dh: tap_conv_mma.cu; dW: tap_conv_dw_mma_kernel and, for long
// sequences, tap_conv_dw_wgmma_kernel below). float32 runs the two kernels
// below on the CUDA cores: their float32 FMAs keep the products exact, and
// sums are float32. TF32 tensor cores would keep about
// three digits of each product, and 3xTF32 drops the low x low term, so
// neither is used. ops/cuda_fold.py::dh_f32_plan and dw_f32_plan mirror
// their C plans constant for constant; a card test holds the pairs together.
//
// What bounds the float32 kernels on an H100 SXM (data-sheet figures: 67
// TFLOP/s float32 outside the tensor cores, 3.35 TB/s): operations. At the
// flagship training shape (K=2, B=256, Lp=55, Cin=Cout=32) and its periods
// [7, 27], the taps the fold leaves valid are 0.14 / 0.27 / 0.40 G
// multiply-adds at 3x3 / 5x5 / 7x7: 4.1 / 7.9 / 12.0 us, against 5.4 MB (dh:
// ct in, dh out) and 3.6 MB (dW: h and ct in), 1.6 and 1.1 us. All kh*kw
// taps are 0.26 / 0.72 / 1.41 G: 7.7 / 21.5 / 42.1 us. chip_smoke.py
// measures both beside these bounds and cuDNN's float32 convolution
// backward (TF32 off), and PERF.md keeps the numbers.
//
// tap_conv_dh (float32). An item is a tile of rt = 64 (where that fits, else
// 32 or 16) rows of one sequence (at the flagship, the whole sequence: Lp =
// 55). What held the first design (one block per sequence, one FMA per two
// shared-memory loads, W restaged by every block through a transposing,
// bank-conflicting copy) back, and what this one does about it:
// - Register micro-tiles. A lane owns 4 output rows x 4 input channels (16
//   float32 sums). Per 4 cotangent channels it loads one float4 of ct for
//   each row and one float4 of W (4 co of one ci) for each channel: 8
//   16-byte loads for 64 FMAs. Lanes are RG rows by CG channels (RG x CG =
//   32, CG = NT / 4 for a block's tile of NT input channels): lane l has
//   rows l % RG + RG i and channels l / RG + CG m, so a warp owns WR = 4 RG
//   consecutive rows, and its lanes read consecutive rows of ct and of W.
// - W once per block, as it lies. Blocks are persistent over a chunk of
//   items and stage their NT-channel tile of W once, its [tap][ci][co] rows
//   by 16-byte cp.async. Every staged row (W and ct) holds an odd number of
//   float4s, so 8 consecutive rows start in distinct bank groups. NT is 32,
//   16 or 8: the plan takes the tile that leaves room for the most warps (at
//   the flagship 7x7, all of W is 226 KB as staged, so 16 channels a tile).
// - Zero rows as the mask. ct rows of an item are staged by cp.async, one
//   window or (long sequences) kh bands. The column mask [0 <= col(s) - dj <
//   p], s < total and the source row's range select which row a lane reads:
//   its source, or one zero row. Nothing is multiplied by a mask (0 * NaN is
//   NaN), and a row whose every tap is masked (rows at and past total) sums
//   +0s.
// - Warp-level tap skip. A tap that masks every row of a warp is skipped by
//   a warp vote; at the flagship's p = 7 the warps of rows 28-63 skip every
//   tap.
// - Balance. Items alternate between the candidates, so every chunk holds
//   as much of each period as the others; and warp w is row tile w / groups
//   of group (w - w / groups) mod groups, so each group's warps, and the
//   first row tiles that a small period leaves live, spread over the 4
//   schedulers.
// - Fixed sum order: each output sums taps in (dc, dj) order, then co in
//   order, in one thread. The same bits come back every run.
// - Groups of warps: each group (rt / WR warps, at least one) stages one
//   item at a time and syncs on its own named barrier, so one group's loads
//   overlap the others' multiply-adds.
//
// tap_conv_dw (float32). What held the first design (one shared-memory load
// and a three-part lane-varying predicate per FMA, staging between
// barriers with no overlap, at most 32 * 256 / Cout taps x channels a
// kernel row) back, and what this one does about it:
// - Warp tiles in registers. A block is (32 x 32 channel tile, group of up
//   to 16 taps dj of a kernel row, chunk of one candidate's items), and a
//   warp owns one tap's 32 x 32 tile of dW: 32 float32 sums a lane, 4 ci x 8
//   co. A row t costs one float4 of h and two of ct for 32 FMAs.
// - Uniform row skip. A warp's validity at row t, [0 <= row(t) + dc <
//   cycles] [0 <= col(t) + dj < p] [t < Lp], is the same in every lane: the
//   warp takes the valid rows from a ballot and multiplies only those, with
//   no predicate per FMA. A valid row reads h inside [0, total), so the h
//   rows a block stages (a band of 64 + taps - 1 rows per item and kernel
//   row) need no zero rows: no masked row is ever read.
// - Every kernel row in every block. A block loops over the kh kernel rows
//   and, for each, over its chunk's items in rounds, staged by 16-byte
//   cp.async into a ring of two rounds (one loads while one multiplies). The
//   valid rows of a kernel row depend on dc (at p = 27 and 7x7, 54 rows for
//   dc = 0 and none for dc = +-2), so blocks that owned one kernel row each
//   would wait on the dc = 0 ones.
// - Splits. splits = min(16 / taps, items of a chunk) warps share each tap;
//   a round stages one item for each, and a warp multiplies every valid row
//   of its item. At the end of a kernel row they sum their tiles in shared
//   memory in split order. (Splitting each item's rows among the warps
//   instead gave each barrier-bounded step a few rows a warp: 8-20 % slower
//   at the flagship.)
// - Split-K over chunks with no float atomics: pass 1 writes one partial dW
//   per chunk into a scratch buffer the caller allocates, [chunks, kh, kw,
//   Cin, Cout], and pass 2 (tap_conv_dw_reduce_kernel, shared with the bf16
//   route) sums every element over the chunks in chunk order. The same
//   inputs give the same bits from run to run. One block an SM: chunks =
//   132 / (tiles * tap groups), 128 at the flagship (4.7 / 13.1 / 25.7 MB of
//   partials at 3x3 / 5x5 / 7x7).
// - Channels: any Cin and Cout, in 32 x 32 tiles; 16-byte copies where a
//   row's channels are a multiple of 4, else 4-byte ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "f32_stage.cuh"
#include "hopper_ptx.cuh"
#include "run_count.cuh"

namespace {

constexpr int kThreads = 256;  // pass 2 of dW

// float32 (CUDA cores). ops/cuda_fold.py mirrors these, f32_stage.cuh's and
// the plans below.
constexpr int kF32Rows = 64;  // dW: rows of an item, a 64-row tile of one sequence
constexpr int kDhTiles[3] = {32, 16, 8};  // dh: input channels of a block's tile
constexpr int kDwTile = 32;  // dW: a warp's tile, 32 ci x 32 co
constexpr int kDwStages = 2;  // dW: staged rounds in the ring, one load in flight

// dW bf16 (tensor cores). ops/cuda_fold.py::dw_mma_plan mirrors the plan
// below, constant for constant; a card test holds the two against each other.
constexpr int kMmaRows = 16;     // rows of a sequence per mma k-step
constexpr int kWarpTile = 32;    // a warp's dW tile: 32 ci x 32 co, 2 x 4 mma tiles
constexpr int kRowPad = 8;       // bf16 added to each staged row: conflict-free ldmatrix
constexpr int kMmaMaxWarps = 16;  // one warp per tap of a kernel row: kw <= 16
constexpr int kMmaStages = 4;  // staged items in the ring: three loads in flight
constexpr int kMmaTargetWarps = 8 * 132;  // pass 1: about 8 warps per SM in all

// The launch plan of tap_conv_dh_kernel; ops/cuda_fold.py::dh_f32_plan mirrors it.
struct DhF32Plan {
  int lp_pad;     // Lp rounded up to whole items
  int pad;        // (kh / 2) * p_max + kw / 2: the largest |dc * p + dj|
  int rt;         // output rows of an item (64, 32 or 16)
  int band;       // 1: an item is staged as kh bands of rt + kw - 1 rows; 0: one window
  int buf_rows;   // rows of a staged item: min(Lp, rt + 2 * pad), or kh * (rt + kw - 1)
  int sc;         // floats of a staged row of ct or W: f32_stride(Cout)
  int nt;         // input channels of a block's tile (32, 16 or 8)
  int tiles;      // channel tiles: ceil(Cin / nt)
  int groups;     // items a block multiplies at once, max(1, rt / WR) warps each
  int warps;      // warps of a block
  int per_chunk;  // items of a chunk (the last one may hold fewer)
  int chunks;     // chunks of the K * B * lp_pad / rt items, candidates interleaved
  int smem;       // dynamic shared memory of a block, bytes
};

// The launch plan of tap_conv_dw_kernel; ops/cuda_fold.py::dw_f32_plan mirrors it.
struct DwF32Plan {
  int tiles;         // 32 x 32 channel tiles of dW
  int tap_groups;    // groups of up to 16 taps of a kernel row, a block each
  int taps;          // taps of a group: ceil(kw / tap_groups)
  int splits;        // warps that share a tap, an item each: min(16 / taps, per_chunk)
  int warps;         // taps * splits
  int chunks_per_k;  // chunks of each candidate's B * ceil(Lp / 64) items
  int per_chunk;     // items of a chunk (the last one may hold fewer)
  int chunks;        // K * chunks_per_k: the scratch holds chunks * kh * kw * Cin * Cout floats
  int smem;          // dynamic shared memory of a block, bytes
};

// Block (input-channel tile blockIdx.x, chunk blockIdx.y). ct: [K, B, Lp,
// Cout], w: [kh, kw, Cin, Cout], dh: [K, B, Lp, Cin], all float32. Item i
// is row tile (i / K) % n_rt of sequence (i % K, i / K / n_rt): candidates
// alternate, so a chunk holds both periods alike.
template <int NT>
__global__ void __launch_bounds__(kF32MaxWarps * 32, 1)
tap_conv_dh_kernel(const float* __restrict__ ct, const float* __restrict__ w,
                   const int* __restrict__ periods, const int* __restrict__ cycles,
                   float* __restrict__ dh, int K, int B, int Lp, int Cin, int Cout, int kh, int kw,
                   int p_max, DhF32Plan q, int* __restrict__ runs) {
  count_run(runs);
  constexpr int CG = NT / 4, RG = 32 / CG, WR = 4 * RG;  // lanes: RG rows x CG channels, 4 each
  extern __shared__ __align__(16) float smem[];
  const int taps = kh * kw, sc = q.sc;
  const int cout4 = (Cout + 3) / 4 * 4;
  float* w_s = smem;  // [tap][NT][sc]: W's tile, its [ci][co] rows as they are in W
  float* bufs = smem + taps * NT * sc;  // groups x buf_rows x sc: the staged items
  float* zero = bufs + q.groups * q.buf_rows * sc;  // one zero row: what a masked lane reads

  const int n0 = blockIdx.x * NT;
  const int rt = q.rt, n_rt = q.lp_pad / rt;
  const int i0 = blockIdx.y * q.per_chunk;
  const int n_items = min(q.per_chunk, K * B * n_rt - i0);
  const int rh = kh / 2, rw = kw / 2;
  const int band_rows = rt + kw - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warp w is row tile wt of group g, w = wt * groups + (g + wt) % groups: a
  // group's warps, and each row tile's warps, spread over the 4 schedulers
  const int tpi = max(1, rt / WR);  // warps of a group: the row tiles of an item
  const int wt = warp / q.groups, group = (warp % q.groups - wt % q.groups + q.groups) % q.groups;
  const int g_threads = tpi * 32, g_tid = wt * 32 + lane;
  const int rg = lane % RG, cg = lane / RG;  // rows rg + RG i, channels n0 + cg + CG m

  // W's tile, once, 16 bytes a copy where Cout allows; the columns of its
  // rows and of the staged ct rows past Cout, and the zero row, are zero:
  // no copy writes them
  const bool vec = Cout % 4 == 0;
  for (int tap = 0; tap < taps; ++tap) {
    stage_rows(w_s + tap * NT * sc, sc, w + static_cast<size_t>(tap) * Cin * Cout, Cin, Cout, n0,
               NT, 0, Cout, vec, threadIdx.x, blockDim.x);
  }
  {
    const int pad_cols = sc - Cout, rows = taps * NT + q.groups * q.buf_rows + 1;
    for (int i = threadIdx.x; i < rows * pad_cols; i += blockDim.x) {
      smem[(i / pad_cols) * sc + Cout + i % pad_cols] = 0.f;
    }
    for (int i = threadIdx.x; i < Cout; i += blockDim.x) zero[i] = 0.f;
  }

  struct Item {
    int k, b, t0, p, total, padw;
  };
  auto item_of = [&](int i) {
    Item it;
    it.k = i % K;
    it.b = i / K / n_rt;
    it.t0 = (i / K % n_rt) * rt;
    it.p = min(max(periods[it.k], 1), p_max);  // the geometry's clamp; the window assumes it
    it.total = cycles[it.k] * it.p;
    it.padw = rh * it.p + rw;  // window rows this period needs on each side
    return it;
  };

  auto stage = [&](const Item& it, float* buf) {  // by the group's threads, asynchronously
    const float* seq = ct + (static_cast<size_t>(it.k) * B + it.b) * Lp * Cout;
    if (q.band) {  // band s: the rows kernel row s - rh reads, t0 - (s - rh) * p - rw on
      for (int s = 0; s < kh; ++s) {
        stage_rows(buf + s * band_rows * sc, sc, seq, Lp, Cout, it.t0 - (s - rh) * it.p - rw,
                   band_rows, 0, Cout, vec, g_tid, g_threads);
      }
    } else {  // one window: rows [max(0, t0 - padw), t0 + rt + padw) of [0, Lp)
      const int w0 = max(0, it.t0 - it.padw);
      stage_rows(buf, sc, seq, Lp, Cout, w0, min(Lp, it.t0 + rt + it.padw) - w0, 0, Cout, vec,
                 g_tid, g_threads);
    }
  };

  auto compute = [&](const Item& it, const float* buf) {
    const int p = it.p, t0 = it.t0;
    const int w0 = max(0, t0 - it.padw);
    const int end = min(t0 + rt, it.total);  // rows past the item or the fold: every tap masked
    int s[4], col[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = t0 + wt * WR + rg + RG * i;  // this lane's rows (past the item where rt < WR)
      col[i] = s[i] % p;  // s >= 0: the floor
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[i][m] = 0.f;

    for (int dci = 0; dci < kh; ++dci) {
      const int dc = dci - rh;
      // staged row of (s, dc, dj): base + (s - t0) - dj
      const int base = q.band ? dci * band_rows + rw : t0 - w0 - dc * p;
      for (int dji = 0; dji < kw; ++dji) {
        const int dj = dji - rw, off = dc * p + dj;
        bool v[4];
        bool any = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = s[i] < end && static_cast<unsigned>(col[i] - dj) < static_cast<unsigned>(p) &&
                 static_cast<unsigned>(s[i] - off) < static_cast<unsigned>(Lp);
          any = any || v[i];
        }
        if (!__any_sync(0xffffffffu, any)) continue;  // every row of the warp masked: adds +0
        const float* c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = v[i] ? buf + (base + s[i] - t0 - dj) * sc : zero;
        const float* wr = w_s + ((dci * kw + dji) * NT + cg) * sc;  // + CG m rows: channel m
#pragma unroll 2
        for (int co = 0; co < cout4; co += 4) {
          float4 a[4], x[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(c[i] + co);
#pragma unroll
          for (int m = 0; m < 4; ++m) x[m] = *reinterpret_cast<const float4*>(wr + CG * m * sc + co);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              acc[i][m] = fmaf(a[i].x, x[m].x, acc[i][m]);
              acc[i][m] = fmaf(a[i].y, x[m].y, acc[i][m]);
              acc[i][m] = fmaf(a[i].z, x[m].z, acc[i][m]);
              acc[i][m] = fmaf(a[i].w, x[m].w, acc[i][m]);
            }
        }
      }
    }

    float* out = dh + (static_cast<size_t>(it.k) * B + it.b) * Lp * Cin;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (s[i] >= min(t0 + rt, Lp)) continue;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ci = n0 + cg + CG * m;
        if (ci < Cin) out[static_cast<size_t>(s[i]) * Cin + ci] = acc[i][m];
      }
    }
  };

  // group g takes items g, g + groups, ... of the chunk, one staged at a time
  const int my_items = n_items > group ? (n_items - group + q.groups - 1) / q.groups : 0;
  float* my_buf = bufs + group * q.buf_rows * sc;
  if (my_items > 0) stage(item_of(i0 + group), my_buf);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // W, the zeros and every group's first item are in place
  for (int j = 0; j < my_items; ++j) {
    const Item it = item_of(i0 + group + j * q.groups);
    if (j > 0) {
      group_barrier(group, g_threads);  // item j - 1 is consumed
      stage(it, my_buf);
      cp_async_commit();
      cp_async_wait_all();
      group_barrier(group, g_threads);  // item j is in place
    }
    compute(it, my_buf);
  }
}

// Pass 1 of dW in float32. Block (channel tile and tap group blockIdx.x,
// chunk blockIdx.y); warp w owns tap jg * taps + w % taps of every kernel
// row, and slot w / taps of each round of `splits` items. h: [K, B, Lp, Cin], ct: [K, B, Lp,
// Cout]; partial: [chunks, kh, kw, Cin, Cout], all float32.
__global__ void __launch_bounds__(kF32MaxWarps * 32, 1)
tap_conv_dw_kernel(const float* __restrict__ h, const float* __restrict__ ct,
                   const int* __restrict__ periods, const int* __restrict__ cycles,
                   float* __restrict__ partial, int B, int Lp, int Cin, int Cout, int kh, int kw,
                   DwF32Plan q, int* __restrict__ runs) {
  count_run(runs);
  extern __shared__ __align__(16) float smem[];
  const int band_rows = kF32Rows + q.taps - 1;  // h rows of the group's taps for 64 output rows
  const int buf = (kF32Rows + band_rows) * kDwTile;  // an item: ct's tile rows, then h's band
  const int round_buf = q.splits * buf;  // a round: one item a split, staged together
  float* red = smem + kDwStages * round_buf;  // (splits - 1) x taps x 1024: the splits' sums
  const int n_rt = (Lp + kF32Rows - 1) / kF32Rows;

  const int co_tiles = (Cout + kDwTile - 1) / kDwTile;
  const int tile = blockIdx.x % q.tiles, jg = blockIdx.x / q.tiles;
  const int ci0 = (tile / co_tiles) * kDwTile, co0 = (tile % co_tiles) * kDwTile;
  const int k = blockIdx.y / q.chunks_per_k;
  const int i0 = (blockIdx.y % q.chunks_per_k) * q.per_chunk;
  const int n_items = min(q.per_chunk, B * n_rt - i0);
  const int p = max(periods[k], 1), cyc = cycles[k];
  const int rh = kh / 2, rw = kw / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tap = warp % q.taps, split = warp / q.taps;
  const int dji = jg * q.taps + tap;  // past kw in a last group that holds fewer taps: idle
  const int dj = dji - rw, dj_lo = jg * q.taps - rw;  // the band starts at the group's first tap
  const int cg = lane >> 2, og = lane & 3;  // this lane's ci 4 cg .. 4 cg + 3, co 8 og .. 8 og + 7

  const float* h_k = h + static_cast<size_t>(k) * B * Lp * Cin;
  const float* ct_k = ct + static_cast<size_t>(k) * B * Lp * Cout;
  const bool vec_h = Cin % 4 == 0, vec_c = Cout % 4 == 0;
  const int n_rounds = (n_items + q.splits - 1) / q.splits;
  const int n_steps = kh * n_rounds;  // (kernel row, round), kernel rows outermost
  auto stage = [&](int step) {  // by the whole block, asynchronously
    const int dci = step / n_rounds, first = i0 + (step % n_rounds) * q.splits;
    for (int slot = 0; slot < q.splits && first + slot < i0 + n_items; ++slot) {
      const int item = first + slot;
      const int b = item / n_rt, t0 = (item % n_rt) * kF32Rows;
      float* cs = smem + (step % kDwStages) * round_buf + slot * buf;
      stage_rows(cs, kDwTile, ct_k + static_cast<size_t>(b) * Lp * Cout, Lp, Cout, t0, kF32Rows,
                 co0, kDwTile, vec_c, threadIdx.x, blockDim.x);
      stage_rows(cs + kF32Rows * kDwTile, kDwTile, h_k + static_cast<size_t>(b) * Lp * Cin, Lp,
                 Cin, t0 + (dci - rh) * p + dj_lo, band_rows, ci0, kDwTile, vec_h, threadIdx.x,
                 blockDim.x);
    }
  };

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  // one commit group per step, empty past the end, so that step s is in
  // place once at most kDwStages - 2 newer groups are pending
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // step s is staged everywhere; step s - 1's buffer is free
    if (s + kDwStages - 1 < n_steps) stage(s + kDwStages - 1);
    cp_async_commit();

    const int dc = s / n_rounds - rh, item = i0 + (s % n_rounds) * q.splits + split;
    const int t0 = (item % n_rt) * kF32Rows;
    const bool mine = item < i0 + n_items;
    // rows t0 + r, r = lane and lane + 32: valid for this warp's tap, the same in every lane
    auto valid = [&](int t) {
      if (!mine || dji >= kw || t >= Lp) return false;
      const int r = t / p, c = t - r * p;  // t >= 0: the floor
      return static_cast<unsigned>(r + dc) < static_cast<unsigned>(cyc) &&
             static_cast<unsigned>(c + dj) < static_cast<unsigned>(p);
    };
    uint32_t m_lo = __ballot_sync(0xffffffffu, valid(t0 + lane));
    uint32_t m_hi = __ballot_sync(0xffffffffu, valid(t0 + 32 + lane));
    const float* cs = smem + (s % kDwStages) * round_buf + split * buf + 8 * og;  // ct row r
    const float* hs = smem + (s % kDwStages) * round_buf + split * buf + kF32Rows * kDwTile +
                      (dj - dj_lo) * kDwTile + 4 * cg;  // h row of output row r: hs + r * 32
    auto row = [&](int r) {
      const float4 x = *reinterpret_cast<const float4*>(hs + r * kDwTile);
      const float4 y0 = *reinterpret_cast<const float4*>(cs + r * kDwTile);
      const float4 y1 = *reinterpret_cast<const float4*>(cs + r * kDwTile + 4);
      const float xv[4] = {x.x, x.y, x.z, x.w};
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(xv[a], yv[c], acc[a][c]);
    };
    while (m_lo) {
      row(__ffs(m_lo) - 1);
      m_lo &= m_lo - 1;
    }
    while (m_hi) {
      row(__ffs(m_hi) + 31);
      m_hi &= m_hi - 1;
    }

    if (s % n_rounds == n_rounds - 1) {  // the kernel row's last round: sum the splits, write
      if (split > 0) {
        float* mine = red + ((split - 1) * q.taps + tap) * kDwTile * kDwTile + lane;
#pragma unroll
        for (int e = 0; e < 32; ++e) mine[32 * e] = acc[e / 8][e % 8];
      }
      __syncthreads();
      if (split == 0 && dji < kw) {
        for (int o = 1; o < q.splits; ++o) {
          const float* theirs = red + ((o - 1) * q.taps + tap) * kDwTile * kDwTile + lane;
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e / 8][e % 8] += theirs[32 * e];
        }
        float* out = partial + ((static_cast<size_t>(blockIdx.y) * kh + dc + rh) * kw + dji) *
                                   Cin * Cout;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ci = ci0 + 4 * cg + a;
          if (ci >= Cin) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int co = co0 + 8 * og + 4 * half;
            float* o = out + static_cast<size_t>(ci) * Cout + co;
            const float* v = acc[a] + 4 * half;
            if (Cout % 4 == 0 && co < Cout) {
              *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (co + c < Cout) o[c] = v[c];
              }
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
    }
  }
}

// Pass 2 of dW, both routes: each element summed over the chunks in chunk order.
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

// The launch plan of band 0 of the bf16 dW, tap_conv_dw_mma_kernel;
// mirrored by ops/cuda_fold.py::DwMmaPlan.
struct DwMmaPlan {
  int lp_pad;        // Lp rounded up to whole 16-row k-steps
  int pad;           // (kh / 2) * p_max + kw / 2: zero rows on each side of a staged sequence
  int rt;            // rows of ct an item multiplies: lp_pad (an item is a whole sequence)
  int band;          // 0
  int buf_rows;      // rows of h an item stages: lp_pad + 2 pad
  int tiles;         // 32 x 32 channel tiles of dW
  int chunks_per_k;  // chunks of each candidate's items
  int per_chunk;     // items of a chunk (the last one may hold fewer)
  int warps;         // warps of a block: one per tap of a kernel row
  int smem;          // dynamic shared memory of a block, bytes
  int chunks;        // K * chunks_per_k: the scratch holds chunks * kh * kw * Cin * Cout floats
};

// The launch plan of band 1, tap_conv_dw_wgmma_kernel; mirrored by
// ops/cuda_fold.py::DwBandPlan.
struct DwBandPlan {
  int lp_pad;       // Lp rounded up to whole items
  int rt;           // rows of ct an item multiplies: 128, 64, 32 or 16
  int band;         // 1
  int buf_rows;     // rows of h a band holds: rt + kw - 1
  int tiles;        // 32 x 32 channel tiles of dW
  int groups;       // kernel-row groups, a block each
  int kr;           // kernel rows of a group (the last one may hold fewer)
  int mtiles;       // 64-row wgmma M tiles of a block: (tap, 16 input channels) slabs, 4 a tile
  int consumers;    // consumer warpgroups of a block; one producer warpgroup beside them
  int warps;        // warps of a block: 4 a warpgroup
  int stages;       // items in a block's ring
  int stage_bytes;  // a stage: ct's rt rows, kr bands of h, the tap table, a header; 1,024-aligned
  int smem;         // dynamic shared memory of a block, bytes
  int cluster;      // blocks of a cluster, which sum their partials in distributed shared memory
  int blocks;       // blocks along the item axis, a whole number of clusters
  int per_chunk;    // items of a block, at most
  int chunks;       // blocks / cluster: the scratch holds chunks * kh * kw * Cin * Cout floats
};

// Band 1 (tap_conv_dw_wgmma_kernel). ops/cuda_fold.py mirrors these.
constexpr int kBandRows[4] = {128, 64, 32, 16};  // rows of an item, tallest first
constexpr int kWgTiles = 5;  // M tiles of a consumer warpgroup, at most: 80 float32 sums a thread
constexpr int kMaxConsumers = 3;  // consumer warpgroups of a block
constexpr int kMaxSlabs = 4 * kWgTiles * kMaxConsumers;  // (tap, 16 channels) slabs a block
constexpr int kTapBits = 32;  // a row's valid taps of a group, one bit each, in one word
constexpr int kMinStages = 4;  // items in the ring, at least
constexpr int kMaxStages = 8;
constexpr int kMinItems = 4;  // items a block takes on average, where an item height gives them
constexpr int kCluster = 2;  // blocks of a cluster
constexpr int kRowBytes = 64;  // a staged row: 32 bf16 channels, the 64-byte swizzle's span
constexpr int kRedStride = 40;  // floats a row of the partial sums: conflict-free float2 stores
constexpr int kAlignSlack = 1024;  // shared memory given up to start the ring on 1,024 bytes
constexpr int kHeaderBytes = 16;  // a stage's header: first row, kernel rows, last-stage flag
constexpr int kBandThreads = (kMaxConsumers + 1) * 128;  // a producer warpgroup, then consumers
constexpr int kProducerRegs = 32;  // setmaxnreg: 128 x 32 + 384 x 160 = 65,536
constexpr int kConsumerRegs = 160;

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
// This kernel stages whole sequences (the plan's band 0), where a ring of
// them fits in shared memory (the flagship: Lp = 55); longer ones take
// tap_conv_dw_wgmma_kernel below (band 1), which is built from Hopper's TMA,
// mbarriers and wgmma.
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
//   3x3 / 5x5 / 7x7 (3.8 / 4.1 / 4.4 MB of float32 partials), summed by
//   the fixed-order pass 2: no float atomics, the same bits every run.
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
tap_conv_dw_mma_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ ct,
                       const int* __restrict__ periods, const int* __restrict__ cycles,
                       float* __restrict__ partial, int B, int Lp, int Cin, int Cout, int kh,
                       int kw, int p_max, int lp_pad, int pad, int co_tiles, int chunks_per_k,
                       int per_chunk, int* __restrict__ runs) {
  count_run(runs);
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
  const int p = min(max(periods[k], 1), p_max);  // the geometry's clamp; the pad assumes it
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

// Band 1 of the bf16 dW, where a ring of whole sequences does not fit in
// shared memory (Lp 1023 at L = 512, and the exact extents 525 and 513 of
// its daily and weekly periods). It replaces the XLA contraction
// flow_timesnet_tpu/ops/fold.py:265 (_tap_weight_grad) in its bf16 form,
// as the whole-sequence kernel above does: dW[dc,dj] = sum over k, b, t of
// valid(dc, dj, t) h[k,b,t + dc*p + dj]^T ct[k,b,t], products exact in
// float32, sums float32.
//
// What bounds it on an H100 SXM (data-sheet figures): bytes. At the long
// recipe's dynamic call (K=4, B=64, Lp=1023, 32 channels) h and ct are 33.5
// MB, 10.0 us at 3.35 TB/s; the taps the fold leaves valid are 2.3 / 5.9
// GFLOP at 3x3 / 5x5, 2.3 / 6.0 us at 989 TFLOP/s (all taps: 4.8 / 13.4
// GFLOP). The design is Hopper's: TMA fills a ring that a producer
// warpgroup keeps ahead, and consumer warpgroups multiply with wgmma.
// Against what held the previous band kernel (a repair, which reused the
// whole-sequence k-step on 64-row items) back:
//
// 1. ct was staged once per kernel row (a block owned one kernel row). Here
//    a block holds every tap of its kernel rows: for each item (rt rows of
//    one sequence) it stages ct's rows once and, for each kernel row dc
//    that reads the item, one band of h of rt + kw - 1 rows from row
//    t0 + dc*p - kw/2 on. ct crosses into shared memory once; h once per
//    kernel row, which a row tiling cannot avoid and which L2 serves.
// 2. Small blocks walked their items behind a block barrier each. Here a
//    persistent block, one an SM, has a producer warpgroup and up to three
//    consumer warpgroups, which meet only on the ring's mbarriers: a
//    consumer waits on a stage's full barrier and each of its warps
//    arrives on the stage's empty one when its products have read it. No
//    block barrier runs per item. Within an item a consumer takes the
//    k-steps two a round: it loads and masks the next round's A fragments
//    while this round's wgmmas run (two rounds of A registers,
//    wgmma.wait_group 1). The producer gives its registers to the consumers
//    (setmaxnreg: 32 a thread, the consumers 160), which hold up to 80
//    float32 sums a thread.
// 3. Address work on the compute threads. TMA computes every address and
//    zero-fills the rows a box has outside [0, Lp) (rows of the band
//    before 0 or past Lp, ct past Lp) in hardware. The producer walks the
//    items and writes each staged one's header (first row, kernel rows)
//    and table: one word a row, a bit for each tap of the group that is
//    valid there, from one division a row, a row a producer thread. A
//    consumer divides nothing; a lane's mask for a tap and a pair of rows
//    is two shifts of a word.
// 4. Masked taps were multiplied. Per item, the kernel rows that no row of
//    the item reaches (at p = 511 and 5x5, dc = +2 everywhere and dc = -2
//    everywhere but at row 1022) are neither loaded nor multiplied, an item
//    that no kernel row reaches is not staged (the rows past each period's
//    extent), and k-steps past Lp are skipped. Skips are uniform over a
//    warpgroup.
// 5. Split-K scratch and a second launch. A block's partial sums go to
//    shared memory at its end, and the blocks of a thread-block cluster
//    sum them through distributed shared memory in rank order, so the
//    scratch holds one partial a cluster (blocks / kCluster, half of what
//    one a block would take), which pass 2 (tap_conv_dw_reduce_kernel, as
//    for band 0) sums in cluster order. No float atomics: the same bits
//    every run.
//
// The products. An M tile of wgmma m64n32k16 is 64 rows of dW: four slabs
// of 16 (tap, input channel) rows, the slabs of the taps in (dc, dj) order
// and, at 32 input channels, two taps a tile. The A operand of a slab,
// A[ci, t] = valid(tap, t) h[t + shift(tap), ci], comes from registers: its
// warp loads it with ldmatrix.trans from the tap's band at the tap's row
// offset, and the mask is an AND on the packed bf16 pairs, which also turns
// whatever masked rows held (zeros, stale bits) into +0. Masking A, not ct,
// lets one staged ct tile be the B operand of every tap: wgmma reads it
// from shared memory through a descriptor (64-byte swizzle, MN-major).
// Each consumer warpgroup holds up to kWgTiles M tiles, 16 float32 sums a
// thread each: 3x3 is 5 tiles (the last half used), 5x5 13, over three
// warpgroups. Rows are staged 64 bytes wide (32 channels) with TMA's
// 64-byte swizzle, so the eight rows of an ldmatrix matrix fall in distinct
// banks wherever a tap's offset starts them (hopper_ptx.cuh).
//
// Work. Items are the row tiles of every sequence, ordered tile by tile
// with the sequences of every candidate fastest, and block x takes items
// x, x + blocks, ...: each block sees every candidate and row tile alike.
// Channel tiles (32 x 32) and kernel-row groups (where a group's taps pass
// kMaxSlabs slabs or kTapBits bits) are the grid's y.
// MT: the M tiles a consumer warpgroup holds (ceil(mtiles / consumers)):
// 16 MT float32 sums a thread. Up to 3, two rounds of A registers let a
// round's loads overlap the previous round's products; at 4 and 5 the
// registers hold one k-step's, and the other warpgroups' products fill the
// gap (two sets there spill: twice the time at 5x5; loading one half of
// the tiles while the other half's wgmmas run took 15 % longer).
//
// What sets its pace on the card (PERF.md): the wgmmas. At N = 32
// (the output channels) an m64n32k16 takes the tensor cores about four
// times its share of the peak rate, with A from registers or from shared
// memory alike; the same tiles on mma.sync m16n8k16 took 1.2-1.8x as long.
template <int MT>
__global__ void __launch_bounds__(kBandThreads, 1)
tap_conv_dw_wgmma_kernel(const __grid_constant__ CUtensorMap h_map,
                         const __grid_constant__ CUtensorMap ct_map,
                         const int* __restrict__ periods, const int* __restrict__ cycles,
                         float* __restrict__ partial, int K, int B, int Lp, int Cin, int Cout,
                         int kh, int kw, int p_max, const DwBandPlan q, int co_tiles,
                         int* __restrict__ runs) {
  count_run(runs);
  __shared__ uint64_t full_bar[kMaxStages], empty_bar[kMaxStages];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring starts on 1,024 bytes: the swizzle is a function of the address
  unsigned char* ring = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int rt = q.rt, S = q.stages, stage_bytes = q.stage_bytes;
  const int ct_bytes = rt * kRowBytes;
  const int band_bytes = (q.buf_rows + 15) / 16 * 16 * kRowBytes;  // 1,024-aligned bands
  const int table_off = ct_bytes + q.kr * band_bytes;  // then rt words, then the header
  const int header_off = table_off + 4 * rt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int consumers = 128 * q.consumers;  // threads of the consumer warpgroups 1 ..
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_bar[s], 128);  // the producer's threads, each after its row of the table
      mbar_init(&empty_bar[s], consumers / 32);  // every consumer warp
    }
    mbar_init_fence();
    tma_prefetch_map(&h_map);
    tma_prefetch_map(&ct_map);
  }
  __syncthreads();  // the barriers, once

  const int group = blockIdx.y % q.groups, tile = blockIdx.y / q.groups;
  const int ci0 = (tile / co_tiles) * 32, co0 = (tile % co_tiles) * 32;
  const int cib = min(2, (Cin - ci0) / 16);  // 16-channel slabs of the channel tile
  const int rh = kh / 2, rw = kw / 2;
  const int kr = min(q.kr, kh - group * q.kr);  // kernel rows of this group
  const int dc0 = group * q.kr - rh;  // the dc of its first
  const int nslabs = kr * kw * cib, mtiles = (nslabs + 3) / 4;

  if (warp < 4) {  // the producer warpgroup: walks the items, a table row a thread
    setmaxnreg_dec<kProducerRegs>();
    const int KB = K * B, items = KB * (q.lp_pad / rt), step = gridDim.x;
    const int dseq = step % KB, dt0 = step / KB * rt;
    // item i: row tile i / (K B) of sequence i % (K B), walked without a division
    int seq = blockIdx.x % KB, t0 = blockIdx.x / KB * rt;
    int j = 0;  // items staged
    for (int i = blockIdx.x; i < items; i += step) {
      const int k = seq / B;
      const int p = min(max(__ldg(periods + k), 1), p_max);  // the geometry's clamp
      const int cyc = __ldg(cycles + k);
      // the group's kernel rows [klo, khi] that some row of the item reaches
      const int r_lo = t0 / p, r_hi = (min(t0 + rt, Lp) - 1) / p;
      const int klo = max(0, -r_hi - dc0), khi = min(kr - 1, cyc - 1 - r_lo - dc0);
      const int item_seq = seq, item_t0 = t0;
      seq += dseq;
      t0 += dt0;
      if (seq >= KB) {
        seq -= KB;
        t0 += rt;
      }
      if (klo > khi) continue;  // no tap reads this tile: not staged
      const int s = j % S;
      mbar_wait(&empty_bar[s], ((j / S) & 1) ^ 1);
      unsigned char* st = ring + s * stage_bytes;
      for (int r = threadIdx.x; r < rt; r += 128) {
        const int t = item_t0 + r;
        uint32_t word = 0;
        if (t < Lp) {  // kernel rows with 0 <= row + dc < cyc, taps with 0 <= col + dj < p
          const int row = t / p, col = t - row * p;
          const int lo = max(klo, -row - dc0), hi = min(khi, cyc - 1 - row - dc0);
          const int wlo = max(0, rw - col), whi = min(kw - 1, p - 1 - col + rw);
          if (wlo <= whi) {
            const uint32_t cols = ((2u << whi) - 1u) & ~((1u << wlo) - 1u);
            for (int kri = lo; kri <= hi; ++kri) word |= cols << (kri * kw);
          }
        }
        reinterpret_cast<uint32_t*>(st + table_off)[r] = word;
      }
      if (threadIdx.x == 0) {
        *reinterpret_cast<int4*>(st + header_off) = make_int4(item_t0, klo, khi, 0);
        mbar_arrive_expect_tx(&full_bar[s], (rt + (khi - klo + 1) * q.buf_rows) * kRowBytes);
        tma_load_3d(st, &ct_map, &full_bar[s], co0, item_t0, item_seq);
        for (int kri = klo; kri <= khi; ++kri) {
          tma_load_3d(st + ct_bytes + kri * band_bytes, &h_map, &full_bar[s], ci0,
                      item_t0 + (dc0 + kri) * p - rw, item_seq);
        }
      } else {
        mbar_arrive(&full_bar[s]);
      }
      ++j;
    }
    // the last stage: a header that ends the consumers' walk
    const int s = j % S;
    mbar_wait(&empty_bar[s], ((j / S) & 1) ^ 1);
    if (threadIdx.x == 0) {
      *reinterpret_cast<int4*>(ring + s * stage_bytes + header_off) = make_int4(0, 0, -1, 1);
    }
    mbar_arrive(&full_bar[s]);
    cluster_sync();  // the consumers' partial sums, then their sum over the cluster
    cluster_sync();
  } else {  // a consumer warpgroup
    setmaxnreg_inc<kConsumerRegs>();
    const int g = warp / 4 - 1, w4 = warp % 4, qq = lane % 4;
    // slab 4 mt + w4 of M tile mt is (tap, 16 channels): tap = slab / cib,
    // kernel row tap / kw, tap dj = tap % kw - kw / 2. ldmatrix.trans rows
    // of the k-step and 8-channel chunk of the lane, as in the whole-sequence kernel
    const int a_row = (lane & 7) + ((lane >> 4) << 3), a_chunk = (lane >> 3) & 1;
    float acc[MT][16];
    bool tile_on[MT];  // this warpgroup holds M tile g + consumers * m
    int tap_bit[MT];  // this warp's slab of it: its tap's bit in a row's word (-1: none)
    int kri_lo[MT], kri_hi[MT];  // the kernel rows the tile's four slabs read
    uint32_t a_off[MT];  // the lane's ldmatrix address in a stage at k-step 0
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[m][e] = 0.f;
      const int mt = g + q.consumers * m, s = 4 * mt + w4;
      tile_on[m] = mt < mtiles;
      kri_lo[m] = tile_on[m] ? 4 * mt / cib / kw : 0;
      kri_hi[m] = tile_on[m] ? min(4 * mt + 3, nslabs - 1) / cib / kw : 0;
      tap_bit[m] = tile_on[m] && s < nslabs ? s / cib : -1;
      const int tap = max(tap_bit[m], 0), row = tap % kw + a_row;
      a_off[m] = ct_bytes + (tap / kw) * band_bytes + swizzle64(row, 2 * (s % cib) + a_chunk);
    }
    for (int j = 0;; ++j) {
      const int s = j % S;
      mbar_wait(&full_bar[s], (j / S) & 1);
      const unsigned char* st = ring + s * stage_bytes;
      const int4 hd = *reinterpret_cast<const int4*>(st + header_off);
      if (hd.w) break;  // the producer's last header
      const uint32_t st_s = smem_addr(st);
      const uint2* tab = reinterpret_cast<const uint2*>(st + table_off);
      bool live[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        live[m] = tile_on[m] && kri_lo[m] <= hd.z && kri_hi[m] >= hd.y;
      }
      // A of k-step ks: the slabs' fragments, masked by the rows' words;
      // the lane's rows 16 ks + 2 q + {0, 1} (registers 0, 1) and + {8, 9} (2, 3)
      auto load_a = [&](uint32_t (&a)[MT][4], int ks) {
        const uint2 w0 = tab[8 * ks + qq], w1 = tab[8 * ks + 4 + qq];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (!live[m]) continue;
          if (tap_bit[m] < 0) {  // the half-used last tile: its missing slabs multiply zeros
            a[m][0] = a[m][1] = a[m][2] = a[m][3] = 0u;
            continue;
          }
          ldmatrix_x4_trans_at(a[m], st_s + a_off[m] + 1024u * ks);
          const int b = tap_bit[m];
          const uint32_t m0 = (0xFFFFu & (0u - ((w0.x >> b) & 1u))) |
                              (0xFFFF0000u & (0u - ((w0.y >> b) & 1u)));
          const uint32_t m1 = (0xFFFFu & (0u - ((w1.x >> b) & 1u))) |
                              (0xFFFF0000u & (0u - ((w1.y >> b) & 1u)));
          a[m][0] &= m0;
          a[m][1] &= m0;
          a[m][2] &= m1;
          a[m][3] &= m1;
        }
      };
      // ct at k-step 0: 8-row groups 512 bytes apart, + 1,024 bytes a k-step
      const uint64_t desc = wgmma_desc_sw64(st_s, 8 * kRowBytes);
      // the wgmmas of k-step ks and, where `two`, of ks + 1: one commit group
      auto mma_round = [&](uint32_t (&x)[MT][4], uint32_t (&y)[MT][4], int ks, bool two) {
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (live[m]) wgmma_m64n32k16(acc[m], x[m], desc + 64u * ks);
        }
        if (two) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (live[m]) wgmma_m64n32k16(acc[m], y[m], desc + 64u * (ks + 1));
          }
        }
        wgmma_commit();
      };
      const int ks_end = min(rt / 16, (Lp - hd.x + 15) / 16);
      uint32_t a0[MT][4], a1[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
      if constexpr (MT <= 3) {
        // two k-steps a round: their fragments load together, and a round's
        // wgmmas run while the next round loads
        uint32_t a2[MT][4], a3[MT][4];
        load_a(a0, 0);
        if (1 < ks_end) load_a(a1, 1);
        for (int ks = 0; ks < ks_end; ks += 4) {
          mma_round(a0, a1, ks, ks + 1 < ks_end);
          if (ks + 2 >= ks_end) break;
          wgmma_wait<1>();  // the round before, which read a2 and a3, is done
          load_a(a2, ks + 2);
          if (ks + 3 < ks_end) load_a(a3, ks + 3);
          mma_round(a2, a3, ks + 2, ks + 3 < ks_end);
          if (ks + 4 >= ks_end) break;
          wgmma_wait<1>();  // round ks, which read a0 and a1, is done
          load_a(a0, ks + 4);
          if (ks + 5 < ks_end) load_a(a1, ks + 5);
        }
      } else {  // one set of fragments: the other warpgroups' products fill the wait
        for (int ks = 0; ks < ks_end; ++ks) {
          load_a(a0, ks);
          mma_round(a0, a1, ks, false);
          wgmma_wait<0>();
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[s]);  // this warp's reads of the stage are done
    }

    group_barrier(0, consumers);  // every warpgroup is done with the ring: it takes the sums
    float* red = reinterpret_cast<float*>(ring);  // [slab][16 channels][kRedStride]
    const int gq = lane / 4;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (tap_bit[m] < 0) continue;
      float* o = red + ((4 * (g + q.consumers * m) + w4) * 16 + gq) * kRedStride + 2 * qq;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[m][4 * n], acc[m][4 * n + 1]);
        *reinterpret_cast<float2*>(o + 8 * kRedStride + 8 * n) =
            make_float2(acc[m][4 * n + 2], acc[m][4 * n + 3]);
      }
    }
    cluster_sync();  // every block of the cluster holds its partial sums
    // block `rank` sums its share of them over the cluster's blocks, in rank order
    const uint32_t cs = q.cluster, rank = cluster_rank();
    const int n4 = nslabs * 16 * 8;  // float4s: slab, channel, 8 of 32 output channels
    const size_t chunk = blockIdx.x / cs;
    for (int e = rank * n4 / cs + threadIdx.x - 128; e < static_cast<int>((rank + 1) * n4 / cs);
         e += consumers) {
      const int s = e >> 7, ch = (e >> 3) & 15, co = co0 + 4 * (e & 7);
      if (co >= Cout) continue;
      const uint32_t off = smem_addr(red + (s * 16 + ch) * kRedStride + 4 * (e & 7));
      float4 sum = ld_cluster_f4(cluster_map(off, 0));
      for (uint32_t r = 1; r < cs; ++r) {
        const float4 v = ld_cluster_f4(cluster_map(off, r));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const int tap = s / cib, ci = ci0 + 16 * (s % cib) + ch;
      const int dci = group * q.kr + tap / kw;
      *reinterpret_cast<float4*>(
          partial + (((chunk * kh + dci) * kw + tap % kw) * Cin + ci) * Cout + co) = sum;
    }
    cluster_sync();  // no block leaves while another reads its shared memory
  }
}

bool bad_shape(int K, int B, int Lp, int Cin, int Cout, int kh, int kw) {
  return K <= 0 || B <= 0 || Lp <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 || kw <= 0 ||
         kh % 2 == 0 || kw % 2 == 0;
}

int launch_dw_reduce(const float* partial, float* dw, int n_elems, int chunks,
                     cudaStream_t stream) {
  tap_conv_dw_reduce_kernel<<<(n_elems + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, dw, n_elems, chunks);
  return static_cast<int>(cudaGetLastError());
}

// 0, or cudaErrorInvalidValue for a shape tap_conv_dh_kernel cannot take:
// p_max outside [1, Lp], W's tile at 8 channels and one staged 16-row item
// above 227 KB, or more items or chunks than it counts (f32_chunks). Of the channel tiles (32,
// 16 or 8 channels; 32 and 16 only where Cin reaches them) it takes the one
// with room for the most warps (ties: the wider), each with the first item
// height and then the most groups that fit; the chunks fill one wave of
// resident blocks, registers counted at the launch bounds' cap.
int dh_f32_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw, int p_max,
                DhF32Plan* plan) {
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw) || p_max < 1 || p_max > Lp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DhF32Plan q{};
  const long long taps = 1LL * kh * kw;
  const long long pad = 1LL * (kh / 2) * p_max + kw / 2;
  const long long sc = f32_stride(Cout);
  long long smem = 0;
  for (int nt : kDhTiles) {
    if (nt > Cin && nt != 8) continue;
    const int wr = 512 / nt;  // a warp's rows: 4 * RG, RG = 32 / (nt / 4)
    bool fits = false;
    for (int rt : kF32RowTiles) {
      if (fits) break;
      const long long window = std::min<long long>(Lp, rt + 2 * pad);
      const long long bands = 1LL * kh * (rt + kw - 1);
      const long long rows = std::min(window, bands);
      const int tpi = std::max(1, rt / wr);
      for (int groups = std::min(kF32MaxGroups, kF32MaxWarps / tpi); groups >= 1; --groups) {
        const long long bytes = 4 * (taps * nt + groups * rows + 1) * sc;
        if (bytes > kMaxSmemBytes) continue;
        fits = true;
        if (groups * tpi > q.warps) {
          q.rt = rt;
          q.band = bands < window ? 1 : 0;
          q.buf_rows = static_cast<int>(rows);
          q.nt = nt;
          q.groups = groups;
          q.warps = groups * tpi;
          smem = bytes;
        }
        break;
      }
    }
  }
  if (q.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  q.lp_pad = (Lp + q.rt - 1) / q.rt * q.rt;
  q.pad = static_cast<int>(pad);
  q.sc = static_cast<int>(sc);
  q.tiles = (Cin + q.nt - 1) / q.nt;
  q.smem = static_cast<int>(smem);
  if (!f32_chunks(1LL * K * B * (q.lp_pad / q.rt), q.warps, smem, q.tiles, &q.per_chunk,
                  &q.chunks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *plan = q;
  return 0;
}

// 0, or cudaErrorInvalidValue for a shape tap_conv_dw_kernel cannot take
// (more chunks or blocks than a grid holds). One block an SM: the chunks
// are 132 / (tiles * tap groups), aligned to K; splits = min(16 / taps,
// items of a chunk), so every split has an item in the first round, or
// fewer where the ring would pass 227 KB.
int dw_f32_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw, DwF32Plan* plan) {
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw)) return static_cast<int>(cudaErrorInvalidValue);
  DwF32Plan q{};
  q.tiles = ((Cin + kDwTile - 1) / kDwTile) * ((Cout + kDwTile - 1) / kDwTile);
  q.tap_groups = (kw + kF32MaxWarps - 1) / kF32MaxWarps;
  q.taps = (kw + q.tap_groups - 1) / q.tap_groups;
  // chunks of a candidate's items (none straddles two), one block an SM in all
  const long long items = 1LL * B * ((Lp + kF32Rows - 1) / kF32Rows);
  const long long blocks = 1LL * q.tiles * q.tap_groups;
  const long long per_k = std::min(items, (std::max(1LL, kSms / blocks) + K - 1) / K);
  const long long per = (items + per_k - 1) / per_k, cpk = (items + per - 1) / per;
  if (blocks > 0x7fffffffLL || 1LL * K * cpk > 65535 || per > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  q.per_chunk = static_cast<int>(per);
  q.chunks_per_k = static_cast<int>(cpk);
  auto smem_of = [&](int splits) {
    return 4 * (kDwStages * splits * (2 * kF32Rows + q.taps - 1) * kDwTile +
                (splits - 1) * q.taps * kDwTile * kDwTile);
  };
  q.splits = std::min(kF32MaxWarps / q.taps, q.per_chunk);
  while (smem_of(q.splits) > kMaxSmemBytes) --q.splits;  // one split always fits
  q.warps = q.taps * q.splits;
  q.smem = smem_of(q.splits);
  q.chunks = K * q.chunks_per_k;
  *plan = q;
  return 0;
}

template <int NT>
int launch_dh_nt(const float* ct, const float* w, const int* periods, const int* cycles,
                 float* dh, int K, int B, int Lp, int Cin, int Cout, int kh, int kw, int p_max,
                 const DhF32Plan& q, int* runs, cudaStream_t stream) {
  auto* kernel = tap_conv_dh_kernel<NT>;
  const cudaError_t err = reserve_smem(kernel, q.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(q.tiles, q.chunks), q.warps * 32, q.smem, stream>>>(
      ct, w, periods, cycles, dh, K, B, Lp, Cin, Cout, kh, kw, p_max, q, runs);
  return static_cast<int>(cudaGetLastError());
}

// Band 1's plan (tap_conv_dw_wgmma_kernel), after band 0's checks. The
// kernel rows of a block: all of them where their slabs fit
// kMaxSlabs and their taps kTapBits, else even groups of them, a block
// each. Blocks: one wave of one block an SM over the channel tiles and
// groups, whole clusters, no more than the items. Items: the tallest of
// kBandRows whose ring of at least kMinStages stages fits and whose count
// gives every block kMinItems, else the shortest that fits. False where a
// grid cannot hold the blocks or the items.
bool dw_band_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw, DwBandPlan* q) {
  const int cib = std::min(2, Cin / 16);  // 16-channel slabs of a 32-channel tile
  const long long tiles = (Cin + 31LL) / 32 * ((Cout + 31LL) / 32);
  q->band = 1;
  q->kr = std::min({kh, kMaxSlabs / (kw * cib), kTapBits / kw});
  q->groups = (kh + q->kr - 1) / q->kr;
  q->kr = (kh + q->groups - 1) / q->groups;
  q->mtiles = (q->kr * kw * cib + 3) / 4;
  q->consumers = std::min(kMaxConsumers, q->mtiles);
  q->warps = 4 * q->consumers + 4;
  q->cluster = kCluster;
  const long long ys = tiles * q->groups;
  if (ys > 65535) return false;
  q->tiles = static_cast<int>(tiles);
  const long long bx = std::max<long long>(kCluster, kSms / ys / kCluster * kCluster);
  const long long avail = kMaxSmemBytes - kAlignSlack - 16LL * kMaxStages;
  const long long red = 1LL * q->kr * kw * cib * 16 * kRedStride * 4;  // the partial sums
  bool fits = false;
  for (int rt : kBandRows) {
    const long long rows = (rt + kw - 1 + 15) / 16 * 16;  // a band, 1,024-aligned
    const long long stage =
        (1LL * (rt + q->kr * rows) * kRowBytes + 4LL * rt + kHeaderBytes + 1023) / 1024 * 1024;
    const long long stages = std::min<long long>(kMaxStages, avail / stage);
    if (stages < kMinStages || red > avail) continue;
    fits = true;
    q->rt = rt;
    q->stages = static_cast<int>(stages);
    q->stage_bytes = static_cast<int>(stage);
    q->smem = static_cast<int>(kAlignSlack + std::max(stages * stage, red));
    if (1LL * K * B * ((Lp + rt - 1) / rt) >= kMinItems * bx) break;
  }
  if (!fits) return false;
  q->lp_pad = (Lp + q->rt - 1) / q->rt * q->rt;
  q->buf_rows = q->rt + kw - 1;
  const long long items = 1LL * K * B * (q->lp_pad / q->rt);
  if (items > 0x7fffffffLL) return false;
  q->blocks = static_cast<int>(std::min(bx, (items + kCluster - 1) / kCluster * kCluster));
  q->per_chunk = static_cast<int>((items + q->blocks - 1) / q->blocks);
  q->chunks = q->blocks / kCluster;
  return true;
}

// 0, or cudaErrorInvalidValue for a shape the kernels cannot take: Cin not a
// multiple of 16 (an mma's k-depth of A's transpose), Cout not a multiple of
// 8 (an mma's width), more than 16 taps in a kernel row, p_max outside
// [1, Lp], or more chunks or blocks than a grid holds. Band 0 (a whole
// sequence an item) where its ring fits, its chunks never straddling two
// candidates and holding as many items as about kMmaTargetWarps warps in
// all leave to each (*band = 0, into plan); else band 1 (*band = 1, into
// band_plan by dw_band_plan).
int dw_mma_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw, int p_max, int* band,
                DwMmaPlan* plan, DwBandPlan* band_plan) {
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw) || Cin % 16 != 0 || Cout % 8 != 0 ||
      kw > kMmaMaxWarps || p_max < 1 || p_max > Lp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DwMmaPlan q{};
  const long long lp16 = (Lp + kMmaRows - 1) / kMmaRows * kMmaRows;
  const long long pad = 1LL * (kh / 2) * p_max + kw / 2;
  const long long si = Cin + kRowPad, so = Cout + kRowPad;
  q.pad = static_cast<int>(pad);
  // band 0: the ring of whole sequences, the masks and the row/col table
  const long long smem = 2LL * kMmaStages * ((lp16 + 2 * pad) * si + lp16 * so) +
                         8LL * kw * (lp16 / kMmaRows) * 32 + 2LL * 4 * lp16;
  if (smem > kMaxSmemBytes) {
    DwBandPlan b{};
    if (!dw_band_plan(K, B, Lp, Cin, Cout, kh, kw, &b)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    *band = 1;
    *band_plan = b;
    return 0;
  }
  q.lp_pad = q.rt = static_cast<int>(lp16);
  q.buf_rows = static_cast<int>(lp16 + 2 * pad);
  q.smem = static_cast<int>(smem);
  q.tiles = ((Cin + kWarpTile - 1) / kWarpTile) * ((Cout + kWarpTile - 1) / kWarpTile);
  q.warps = kw;
  const long long items = B;
  const long long want = std::max(1, kMmaTargetWarps / (kh * q.tiles * kw));  // chunks in all
  const long long per_k = std::min(items, (want + K - 1) / K);
  const long long per = (items + per_k - 1) / per_k, cpk = (items + per - 1) / per;
  const long long chunks = 1LL * K * cpk;
  if (chunks > 65535 || 1LL * kh * q.tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  q.per_chunk = static_cast<int>(per);
  q.chunks_per_k = static_cast<int>(cpk);
  q.chunks = static_cast<int>(chunks);
  *band = 0;
  *plan = q;
  return 0;
}

// cuTensorMapEncodeTiled, looked up through the runtime, so that the
// library needs no -lcuda; null where the installed CUDA lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a [seqs, Lp, C] bf16 tensor whose box is 32 channels of `rows`
// rows of one sequence, written into shared memory with the 64-byte
// swizzle; what a box has outside the tensor arrives as zeros.
bool encode_rows(EncodeTiled encode, CUtensorMap* map, const void* base, int seqs, int Lp, int C,
                 int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(Lp),
                              static_cast<cuuint64_t>(seqs)};
  const cuuint64_t strides[2] = {2ull * C, 2ull * C * Lp};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Pass 1 of band 1: the tensor maps of h and ct, encoded at every launch
// (a CUDA graph keeps the maps, and the pointers in them, that its capture
// saw), and the launch with the plan's clusters.
int launch_dw_band(const __nv_bfloat16* h, const __nv_bfloat16* ct, const int* periods,
                   const int* cycles, float* partial, int K, int B, int Lp, int Cin, int Cout,
                   int kh, int kw, int p_max, const DwBandPlan& q, int* runs,
                   cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap h_map, ct_map;
  if (!encode_rows(encode, &h_map, h, K * B, Lp, Cin, q.buf_rows) ||
      !encode_rows(encode, &ct_map, ct, K * B, Lp, Cout, q.rt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kernel = tap_conv_dw_wgmma_kernel<kWgTiles>;
  switch ((q.mtiles + q.consumers - 1) / q.consumers) {
    case 1: kernel = tap_conv_dw_wgmma_kernel<1>; break;
    case 2: kernel = tap_conv_dw_wgmma_kernel<2>; break;
    case 3: kernel = tap_conv_dw_wgmma_kernel<3>; break;
    case 4: kernel = tap_conv_dw_wgmma_kernel<4>; break;
    default: break;
  }
  const cudaError_t err = reserve_smem(kernel, q.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int co_tiles = (Cout + 31) / 32;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(q.blocks, q.tiles * q.groups);
  cfg.blockDim = dim3(q.warps * 32);
  cfg.dynamicSmemBytes = q.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&h_map, &ct_map, &periods, &cycles, &partial, &K,  &B,        &Lp,
                  &Cin,   &Cout,   &kh,      &kw,     &p_max,   const_cast<DwBandPlan*>(&q),
                  &co_tiles, &runs};
  return static_cast<int>(cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args));
}

}  // namespace

// The plan of the float32 dh route at this shape, into out[13] in the order
// of DhF32Plan. Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int tap_conv_dh_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw,
                                int p_max, int* out) {
  DhF32Plan q;
  const int err = dh_f32_plan(K, B, Lp, Cin, Cout, kh, kw, p_max, &q);
  if (err != 0) return err;
  const int fields[13] = {q.lp_pad, q.pad, q.rt, q.band, q.buf_rows, q.sc, q.nt, q.tiles,
                          q.groups, q.warps, q.per_chunk, q.chunks, q.smem};
  std::copy(fields, fields + 13, out);
  return 0;
}

// The float32 route of dh (bf16 is tap_conv_mma.cu's tap_conv_dh_mma).
// ct: [K, B, Lp, Cout] and w: [kh, kw, Cin, Cout] float32, 16-byte aligned; periods, cycles: [K] int32, every period at most p_max
// (p_cap, or a dense geometry's period); dh: [K, B, Lp, Cin] float32; runs: the
// int32 cell this launch adds 1 to when it runs (or null). All contiguous, on
// the current device. Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tap_conv_dh(const void* ct, const void* w, const void* periods,
                           const void* cycles, void* dh, int K, int B, int Lp, int Cin,
                           int Cout, int kh, int kw, int p_max, void* runs, void* stream) {
  DhF32Plan q;
  const int err = dh_f32_plan(K, B, Lp, Cin, Cout, kh, kw, p_max, &q);
  if (err != 0) return err;
  if (!aligned16(ct) || !aligned16(w)) {
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte copies
  }
  const auto* c = static_cast<const float*>(ct);
  const auto* wp = static_cast<const float*>(w);
  const auto* per = static_cast<const int*>(periods);
  const auto* cyc = static_cast<const int*>(cycles);
  auto* o = static_cast<float*>(dh);
  auto* r = static_cast<int*>(runs);
  auto s = static_cast<cudaStream_t>(stream);
  switch (q.nt) {
    case 32:
      return launch_dh_nt<32>(c, wp, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, p_max, q, r, s);
    case 16:
      return launch_dh_nt<16>(c, wp, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, p_max, q, r, s);
    default:
      return launch_dh_nt<8>(c, wp, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, p_max, q, r, s);
  }
}

// The plan of the float32 dW route at this shape, into out[9] in the order
// of DwF32Plan. Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int tap_conv_dw_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw,
                                int* out) {
  DwF32Plan q;
  const int err = dw_f32_plan(K, B, Lp, Cin, Cout, kh, kw, &q);
  if (err != 0) return err;
  const int fields[9] = {q.tiles, q.tap_groups, q.taps, q.splits, q.warps,
                         q.chunks_per_k, q.per_chunk, q.chunks, q.smem};
  std::copy(fields, fields + 9, out);
  return 0;
}

// The float32 route. h: [K, B, Lp, Cin] and ct: [K, B, Lp, Cout] float32,
// 16-byte aligned; periods, cycles: [K] int32; partial: scratch of
// plan.chunks * kh * kw * Cin * Cout float32; dw: [kh, kw, Cin, Cout]
// float32; runs: the int32 cell pass 1 adds 1 to when it runs (or null). All
// contiguous, on the current device. Returns a cudaError_t value: 0 on a
// successful launch of both passes.
extern "C" int tap_conv_dw(const void* h, const void* ct, const void* periods,
                           const void* cycles, void* partial, void* dw, int K, int B, int Lp,
                           int Cin, int Cout, int kh, int kw, void* runs, void* stream) {
  DwF32Plan q;
  int err = dw_f32_plan(K, B, Lp, Cin, Cout, kh, kw, &q);
  if (err != 0) return err;
  if (!aligned16(h) || !aligned16(ct) || !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte copies and stores
  }
  err = static_cast<int>(reserve_smem(tap_conv_dw_kernel, q.smem));
  if (err != 0) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  tap_conv_dw_kernel<<<dim3(q.tiles * q.tap_groups, q.chunks), q.warps * 32, q.smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(ct),
      static_cast<const int*>(periods), static_cast<const int*>(cycles), part, B, Lp, Cin, Cout,
      kh, kw, q, static_cast<int*>(runs));
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_dw_reduce(part, static_cast<float*>(dw), kh * kw * Cin * Cout, q.chunks, s);
}

// The plan of the bf16 route at this shape: *band (0 or 1), and out[11] in
// the order of DwMmaPlan (band 0) or out[17] in that of DwBandPlan (band 1).
// Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int tap_conv_dw_mma_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw,
                                    int p_max, int* band, int* out) {
  DwMmaPlan q;
  DwBandPlan b;
  const int err = dw_mma_plan(K, B, Lp, Cin, Cout, kh, kw, p_max, band, &q, &b);
  if (err != 0) return err;
  if (*band) {
    const int fields[17] = {b.lp_pad,  b.rt,        b.band,      b.buf_rows, b.tiles, b.groups,
                            b.kr,      b.mtiles,    b.consumers, b.warps,    b.stages,
                            b.stage_bytes, b.smem,  b.cluster,   b.blocks,   b.per_chunk,
                            b.chunks};
    std::copy(fields, fields + 17, out);
  } else {
    const int fields[11] = {q.lp_pad, q.pad,      q.rt,    q.band, q.buf_rows, q.tiles,
                            q.chunks_per_k, q.per_chunk, q.warps, q.smem, q.chunks};
    std::copy(fields, fields + 11, out);
  }
  return 0;
}

// The bf16 route, on the tensor cores. h: [K, B, Lp, Cin] and ct:
// [K, B, Lp, Cout] bf16, 16-byte aligned; periods, cycles: [K] int32, every
// period at most p_max (p_cap, or a dense geometry's period); partial: scratch of
// plan.chunks * kh * kw * Cin * Cout float32; dw: [kh, kw, Cin, Cout]
// float32; runs as for the float32 route. All contiguous, on the current
// device. Returns a cudaError_t value: 0 on a successful launch of both passes.
extern "C" int tap_conv_dw_mma(const void* h, const void* ct, const void* periods,
                               const void* cycles, void* partial, void* dw, int K, int B, int Lp,
                               int Cin, int Cout, int kh, int kw, int p_max, void* runs,
                               void* stream) {
  DwMmaPlan q;
  DwBandPlan b;
  int band = 0;
  int err = dw_mma_plan(K, B, Lp, Cin, Cout, kh, kw, p_max, &band, &q, &b);
  if (err != 0) return err;
  if ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(ct)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte copies; TMA's global address
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  const auto* hp = static_cast<const __nv_bfloat16*>(h);
  const auto* cp = static_cast<const __nv_bfloat16*>(ct);
  const auto* per = static_cast<const int*>(periods);
  const auto* cyc = static_cast<const int*>(cycles);
  const int n_elems = kh * kw * Cin * Cout;
  if (band) {
    err = launch_dw_band(hp, cp, per, cyc, part, K, B, Lp, Cin, Cout, kh, kw, p_max, b,
                         static_cast<int*>(runs), s);
  } else {
    err = static_cast<int>(reserve_smem(tap_conv_dw_mma_kernel, q.smem));
    if (err != 0) return err;
    const int co_tiles = (Cout + kWarpTile - 1) / kWarpTile;
    tap_conv_dw_mma_kernel<<<dim3(kh * q.tiles, q.chunks), q.warps * 32, q.smem, s>>>(
        hp, cp, per, cyc, part, B, Lp, Cin, Cout, kh, kw, p_max, q.lp_pad, q.pad, co_tiles,
        q.chunks_per_k, q.per_chunk, static_cast<int*>(runs));
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
  return launch_dw_reduce(part, static_cast<float*>(dw), n_elems, band ? b.chunks : q.chunks, s);
}
