// The fold convolution and its dh adjoint in bf16 on Hopper's tensor cores
// (sm_90a): one kernel template, instantiated for sign = +1 (the forward)
// and sign = -1 (dh).
//
// It replaces flow_timesnet_tpu/ops/pallas_fold.py::_tap_conv_pallas_impl
// (77-184, pl.pallas_call at 174) for sign = +1 and sign = -1, which runs
// both directions with one body, as this template does. For each (k, b)
// sequence of candidate k, with p = periods[k], cycles = cycles[k] and
// total = cycles * p:
//
//   out[t, :] = sum_{dc,dj} mask(t; dc, dj) * X[t + sign * (dc * p + dj), :] @ M[dc, dj]
//
// - sign = +1: X = h, M = W[dc, dj] (Cin x Cout), and mask is
//   ops/fold.py::_fwd_mask: [0 <= row(t) + dc < cycles] [0 <= col(t) + dj < p].
//   The output is the XLA form of tap_conv (tap_conv_fwd.cu's header) plus
//   the float32 bias, added last, over all Lp rows.
// - sign = -1: X = ct, M = W[dc, dj]^T (Cout x Cin), and mask is
//   ops/fold.py::_bwd_mask: [s < total] [0 <= col(s) - dj < p], the same for
//   every dc, with X zero outside [0, Lp) (tap_conv_bwd.cu's header gives the
//   floor-against-truncation reasoning). Rows at or past total come out 0.
//
// row(t) = t / p and col(t) = t % p are taken of non-negative t only, where
// truncation is the floor. bf16 products are exact in float32 and are summed
// in float32 (mma.sync's float32 accumulators), as the plain versions of
// flow_timesnet_tpu_torch/ops/fold.py do. The output is [K, B, Lp, Cout]
// (forward) or [K, B, Lp, Cin] (dh) float32.
//
// What bounds it on an H100 SXM (data-sheet figures): bytes. At the flagship
// shape (K=2, Lp=55, Cin=Cout=32), the forward at B=192 moves 4.1-4.3 MB
// (h and W in bf16, the float32 output): 1.2 us at 3.35 TB/s; dh at B=256
// moves 5.4 MB: 1.6 us. All kh*kw taps at 7x7 are 2.1 / 2.8 GFLOP, 2.1 / 2.9
// us at 989 TFLOP/s, and the taps the fold leaves valid at the path's periods
// far fewer.
//
// Design. An item is a tile of rt output rows (16, 32 or 64) of one
// sequence; at the flagship it is the whole sequence (Lp = 55 padded to 64).
// ops/cuda_fold.py::fold_mma_plan mirrors the plan below constant for
// constant, and a card test holds the two together. What the design does
// about what held the CUDA-core kernels (tap_conv_fwd.cu, tap_conv_bwd.cu's
// tap_conv_dh) back:
//
// 1. Tensor cores in place of one float32 FMA per two shared-memory reads.
//    A warp owns a 16-row x nt-column tile of one item's output in float32
//    registers and runs, per tap, mma.sync m16n8k16 over Cx / 16 k-steps.
//    A is the shifted X rows, loaded with ldmatrix from the staged item. B
//    comes from W staged as [ci][co] rows: ldmatrix.trans for sign = +1 and
//    plain ldmatrix for sign = -1, since W^T stored [ci][co] is B in column
//    order. The one staged layout serves both signs, so the transposed copy
//    of tap_conv_dh and its 32-way bank conflict are gone. A sequence is 64
//    rows, so wgmma m64nNk16 would fit one warpgroup per item, but its tap
//    skip would then be per 64 rows, not per 16 (a tap is skipped by a warp
//    only where all its rows are masked, and at the flagship's periods that
//    is about half the taps of a 16-row tile); mma.sync keeps the warp-level
//    skip and the fragment code proven by the dW kernel.
// 2. W staged once per block, not once per sequence. A block is persistent
//    over a chunk of items of one candidate k (chunks never straddle two
//    candidates, so a block has one period) and stages its channel tile of
//    W once, in bf16, beside a ring of staged items. The plan picks the
//    tile (32, 16 or 8 output channels) so that the slice fits; the grid
//    covers the other tiles. Staged rows are padded so that the 8 rows an
//    ldmatrix matrix reads start in 8 distinct 16-byte bank groups (an odd
//    number of 16-byte vectors a row).
// 3. Masks as data, skipped taps as whole warps. X is staged between zero
//    rows: cp.async zero-fills every row outside [0, Lp), so a shifted read
//    lies in the buffer and reads X or 0, which is what the old kernels'
//    `continue`s gave. The items of short sequences are staged as one
//    window of rt + 2 * pad rows, pad = (kh / 2) * p_max + kw / 2 (as staged,
//    rt + 2 * ((kh / 2) * p + kw / 2) of them at the block's period p); long
//    ones, where that window would not fit, as kh bands of rt + kw - 1 rows,
//    one per kernel row. The mask is by output row, so it applies to A:
//    registers a0/a2 hold row g and a1/a3 row g + 8, ANDed with 0 or
//    0xffffffff, never multiplied (a masked row may hold any bits, and
//    0 * NaN is NaN). dh's mask also clears a row whose source lies outside
//    [0, Lp), which reads a zero row anyway. A tap whose 16 rows are all
//    masked for a warp is skipped by a warp-uniform branch: exact, since a
//    masked product adds +0.
// 4. Overlap. Each group of rt / 16 warps takes every groups-th item of the
//    block's chunk. Where the chunks leave each group one item (the
//    flagship), a group stages one item and as many groups as fit load and
//    multiply side by side; else each group keeps a two-buffer cp.async
//    ring: item i + 1 loads while item i multiplies, behind one named
//    barrier of the group. Blocks are sized for one wave, counting
//    registers at the launch bounds' cap.
// 5. No scratch and no reduction: each output belongs to one warp, which
//    writes float32 pairs straight from its accumulators (forward: + bias),
//    so the result is the same from run to run.
//
// The PTX helpers are shared with tap_conv_bwd.cu's dW kernel (mma_ptx.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma_ptx.cuh"

namespace {

constexpr int kMmaRows = 16;  // rows of an m-tile: one warp's share of an item
constexpr int kMaxWarps = 16;  // warps of a block
constexpr int kMaxGroups = 15;  // a group syncs on named barrier group + 1, of 1-15
constexpr int kStages = 2;  // a ring of staged items per group: one loads while one multiplies
constexpr int kMaxSmemBytes = 232448;  // 227 KB: the most one block may use
constexpr int kSmemPerSm = 233472;  // 228 KB a streaming multiprocessor
constexpr int kSmemReserved = 1024;  // what the runtime keeps of it per block
constexpr int kWarpsPerSm = 64;
constexpr int kRegsPerSm = 65536;
constexpr int kRegsCap = kRegsPerSm / (kMaxWarps * 32);  // __launch_bounds__(kMaxWarps * 32, 1)
constexpr int kSms = 132;  // an H100 SXM: the chunks fill one wave of blocks
constexpr int kTiles[3] = {32, 16, 8};  // channel tiles, preferred first
constexpr int kRowTiles[3] = {64, 32, 16};  // rows of an item, preferred first

// bf16 elements of a staged row of `cols` channels: 8 more when the row holds
// an even number of 16-byte vectors, so that 8 consecutive rows start in 8
// distinct 16-byte bank groups (conflict-free ldmatrix)
__host__ __device__ constexpr int row_stride(int cols) {
  return cols + ((cols / 8) % 2 == 0 ? 8 : 0);
}

__device__ __forceinline__ void group_barrier(int group, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(threads) : "memory");
}

// The launch plan; ops/cuda_fold.py::fold_mma_plan mirrors it.
struct FoldMmaPlan {
  int lp_pad;        // Lp rounded up to whole items
  int pad;           // (kh / 2) * p_max + kw / 2: the largest |dc * p + dj|
  int rt;            // output rows of an item (16, 32 or 64)
  int band;          // 1: an item is staged as kh bands of rt + kw - 1 rows; 0: one window
  int buf_rows;      // rows of a staged item: rt + 2 * pad, or kh * (rt + kw - 1)
  int nt;            // output channels of a block's tile (32, 16 or 8)
  int tiles;         // channel tiles: ceil(Cy / nt)
  int groups;        // items a block multiplies at once, rt / 16 warps each
  int warps;         // warps of a block: groups * rt / 16
  int stages;        // staged items per group: 1 only where every group has at most one
                     // item (per_chunk <= groups), else a ring of kStages
  int chunks_per_k;  // chunks of each candidate's B * lp_pad / rt items
  int per_chunk;     // items of a chunk (the last one may hold fewer)
  int chunks;        // K * chunks_per_k
  int smem;          // dynamic shared memory of a block, bytes
};

bool bad_shape(int sign, int K, int B, int Lp, int Cin, int Cout, int kh, int kw, int p_max) {
  return (sign != 1 && sign != -1) || K <= 0 || B <= 0 || Lp <= 0 || Cin <= 0 || Cout <= 0 ||
         kh <= 0 || kw <= 0 || kh % 2 == 0 || kw % 2 == 0 || p_max < 1 || p_max > Lp;
}

// The plan with `stages` staged items per group: the first channel tile,
// then item height, then the most groups that fit in 227 KB, and chunks that
// fill one wave of resident blocks. False where nothing fits.
bool plan_with(int stages, int sign, int K, int B, int Lp, int Cin, int Cout, int kh, int kw,
               int p_max, FoldMmaPlan* plan) {
  const int cx = sign > 0 ? Cin : Cout, cy = sign > 0 ? Cout : Cin;
  const long long taps = 1LL * kh * kw;
  const long long pad = 1LL * (kh / 2) * p_max + kw / 2;
  const int lp16 = (Lp + kMmaRows - 1) / kMmaRows * kMmaRows;
  FoldMmaPlan q{};
  bool found = false;
  for (int nt : kTiles) {
    if (found) break;
    if (nt > cy) continue;
    const long long w_bytes =
        2 * taps * (sign > 0 ? 1LL * cx * row_stride(nt) : 1LL * nt * row_stride(cx));
    for (int rt : kRowTiles) {
      if (found) break;
      if (rt > lp16) continue;
      const long long window = rt + 2 * pad, bands = 1LL * kh * (rt + kw - 1);
      const long long rows = std::min(window, bands);
      const long long buf_bytes = 2 * rows * row_stride(cx);
      for (int groups = std::min(kMaxGroups, kMaxWarps / (rt / kMmaRows)); groups >= 1; --groups) {
        const long long smem = w_bytes + 1LL * groups * stages * buf_bytes;
        if (smem > kMaxSmemBytes) continue;
        q.pad = static_cast<int>(pad);
        q.rt = rt;
        q.band = bands < window ? 1 : 0;
        q.buf_rows = static_cast<int>(rows);
        q.nt = nt;
        q.groups = groups;
        q.smem = static_cast<int>(smem);
        found = true;
        break;
      }
    }
  }
  if (!found) return false;
  q.lp_pad = (Lp + q.rt - 1) / q.rt * q.rt;
  q.tiles = (cy + q.nt - 1) / q.nt;
  q.warps = q.groups * q.rt / kMmaRows;
  q.stages = stages;
  // blocks an SM surely holds: by warps, shared memory and registers at the
  // launch bounds' cap (fewer registers in use only leave room to spare)
  const int resident = std::max(1, std::min({kWarpsPerSm / q.warps,
                                             kSmemPerSm / (q.smem + kSmemReserved),
                                             kRegsPerSm / (q.warps * 32 * kRegsCap)}));
  const int want = std::max(1, (kSms * resident + q.tiles - 1) / q.tiles);  // chunks in all
  const long long items = 1LL * B * (q.lp_pad / q.rt);
  const long long per_k = std::min<long long>(items, (want + K - 1) / K);
  const long long per_chunk = (items + per_k - 1) / per_k;
  const long long chunks_per_k = (items + per_chunk - 1) / per_chunk;
  if (1LL * K * chunks_per_k > 65535 || q.tiles > 65535) return false;
  q.per_chunk = static_cast<int>(per_chunk);
  q.chunks_per_k = static_cast<int>(chunks_per_k);
  q.chunks = static_cast<int>(K * chunks_per_k);
  *plan = q;
  return true;
}

// 0, or cudaErrorInvalidValue for a shape the kernel cannot take: Cin or
// Cout not a multiple of 16 (an mma's k-depth, and the channel pairs of an
// ldmatrix), p_max outside [1, Lp], W's slice and one staged item per group
// above 227 KB at every tile, or more chunks than a grid holds. One staged
// item per group where that leaves every group at most one item (the whole
// call in one pass, as many groups as fit); else a ring of kStages.
int fold_mma_plan(int sign, int K, int B, int Lp, int Cin, int Cout, int kh, int kw, int p_max,
                  FoldMmaPlan* plan) {
  if (bad_shape(sign, K, B, Lp, Cin, Cout, kh, kw, p_max) || Cin % 16 != 0 || Cout % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FoldMmaPlan q;
  if (plan_with(1, sign, K, B, Lp, Cin, Cout, kh, kw, p_max, &q) && q.per_chunk <= q.groups) {
    *plan = q;
    return 0;
  }
  if (!plan_with(kStages, sign, K, B, Lp, Cin, Cout, kh, kw, p_max, &q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *plan = q;
  return 0;
}

// Block (channel tile blockIdx.x, chunk blockIdx.y). X: [K, B, Lp, Cx] bf16
// (h or ct); W: [kh, kw, Cin, Cout] bf16; out: [K, B, Lp, Cy] float32.
template <int SIGN, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)  // up to kRegsCap registers a thread
tap_conv_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, const int* __restrict__ periods,
                    const int* __restrict__ cycles, float* __restrict__ out, int B, int Lp,
                    int Cin, int Cout, int kh, int kw, int p_max, FoldMmaPlan q) {
  constexpr bool kFwd = SIGN > 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cx = kFwd ? Cin : Cout, cy = kFwd ? Cout : Cin;
  const int taps = kh * kw;
  const int sx = row_stride(cx);  // staged X row
  // a tap's W slice, [ci][co] rows: forward Cin rows of the tile's nt
  // columns, dh the tile's nt rows (ci) of Cout columns
  const int w_rows = kFwd ? cx : NT;
  const int sw = kFwd ? row_stride(NT) : sx;
  const int w_tap = w_rows * sw;
  auto* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  auto* bufs = w_s + taps * w_tap;  // groups x stages staged items
  const int buf_elems = q.buf_rows * sx;

  const int n0 = blockIdx.x * NT;
  const int k = blockIdx.y / q.chunks_per_k;
  const int n_rt = q.lp_pad / q.rt;
  const int i0 = (blockIdx.y % q.chunks_per_k) * q.per_chunk;
  const int n_items = min(q.per_chunk, B * n_rt - i0);
  const int p = min(max(periods[k], 1), p_max);  // make_geometry's clamp; the window assumes it
  const int cyc = cycles[k];
  const int total = cyc * p;
  const int rh = kh / 2, rw = kw / 2;
  const int padw = rh * p + rw;  // window rows this period needs on each side
  const int band_rows = q.rt + kw - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mts = q.rt / kMmaRows;  // warps of a group
  const int group = warp / mts, mt = warp % mts;
  const int g_threads = mts * 32, g_tid = threadIdx.x - group * g_threads;

  // W's slice, once: the block's first commit group
  {
    const int vrow = (kFwd ? NT : cx) / 8;  // 16-byte vectors of a staged row
    const int n = taps * w_rows * vrow;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int v = i % vrow, r = (i / vrow) % w_rows, tap = i / (vrow * w_rows);
      const int ci = kFwd ? r : n0 + r, co = kFwd ? n0 + 8 * v : 8 * v;
      // columns (forward) or rows (dh) past the channels stay unset: no mma reads them
      if (ci < Cin && co < Cout) {
        cp_async16(w_s + tap * w_tap + r * sw + 8 * v,
                   w + (static_cast<size_t>(tap) * Cin + ci) * Cout + co);
      }
    }
  }

  const __nv_bfloat16* x_k = x + static_cast<size_t>(k) * B * Lp * cx;
  auto stage = [&](int item, __nv_bfloat16* buf) {  // by the group's threads, asynchronously
    const int b = item / n_rt, t0 = (item % n_rt) * q.rt;
    const __nv_bfloat16* xs = x_k + static_cast<size_t>(b) * Lp * cx;
    const int vrow = cx / 8;
    const int seg_rows = q.band ? band_rows : q.rt + 2 * padw;
    const int n = (q.band ? kh : 1) * seg_rows * vrow;
    for (int i = g_tid; i < n; i += g_threads) {
      const int v = i % vrow, r = (i / vrow) % seg_rows, s = i / (vrow * seg_rows);
      // global row of staged row r of band s (kernel row s - rh), or of the window
      const int g_row = q.band ? t0 + SIGN * (s - rh) * p - rw + r : t0 - padw + r;
      const int b_row = q.band ? s * band_rows + r : q.pad - padw + r;
      const bool in = g_row >= 0 && g_row < Lp;
      cp_async16_zfill(buf + b_row * sx + 8 * v, in ? xs + static_cast<size_t>(g_row) * cx + 8 * v : xs,
                       in);
    }
  };

  // lane addresses: A's matrices are (rows 0-7, k 0-7), (rows 8-15, k 0-7),
  // (rows 0-7, k 8-15), (rows 8-15, k 8-15), the order of its registers
  const int a_row = mt * kMmaRows + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  // B: forward (ldmatrix.trans of [k][n] rows) (k 0-7, n 0-7), (k 8-15, n 0-7),
  // (k 0-7, n 8-15), (k 8-15, n 8-15); dh (ldmatrix of [n][k] rows) (n 0-7,
  // k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15); x2 takes the
  // first two
  const int b_off = kFwd ? ((lane & 7) + ((lane >> 3) & 1) * 8) * sw + (lane >> 4) * 8
                         : ((lane & 7) + (lane >> 4) * 8) * sw + ((lane >> 3) & 1) * 8;
  const int b_kstep = kFwd ? kMmaRows * sw : kMmaRows;  // elements from one k-step to the next
  const int b_pair = kFwd ? 16 : 16 * sw;  // from one pair of n-tiles to the next

  auto compute = [&](int item, const __nv_bfloat16* buf) {
    const int b = item / n_rt, t0 = (item % n_rt) * q.rt;
    const int t_lo = t0 + mt * kMmaRows + (lane >> 2), t_hi = t_lo + 8;  // this lane's rows
    const int r_lo = t_lo / p, c_lo = t_lo - r_lo * p;  // t >= 0: the floor
    const int r_hi = t_hi / p, c_hi = t_hi - r_hi * p;
    float acc[NT / 8][4];
#pragma unroll
    for (int nt = 0; nt < NT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

    for (int dci = 0; dci < kh; ++dci) {
      const int dc = dci - rh;
      const int base = q.band ? dci * band_rows + rw : q.pad + SIGN * dc * p;
      for (int dji = 0; dji < kw; ++dji) {
        const int dj = dji - rw;
        bool v_lo, v_hi;
        if (kFwd) {
          v_lo = t_lo < Lp && static_cast<unsigned>(r_lo + dc) < static_cast<unsigned>(cyc) &&
                 static_cast<unsigned>(c_lo + dj) < static_cast<unsigned>(p);
          v_hi = t_hi < Lp && static_cast<unsigned>(r_hi + dc) < static_cast<unsigned>(cyc) &&
                 static_cast<unsigned>(c_hi + dj) < static_cast<unsigned>(p);
        } else {
          const int off = dc * p + dj;
          v_lo = t_lo < total && static_cast<unsigned>(c_lo - dj) < static_cast<unsigned>(p) &&
                 static_cast<unsigned>(t_lo - off) < static_cast<unsigned>(Lp);
          v_hi = t_hi < total && static_cast<unsigned>(c_hi - dj) < static_cast<unsigned>(p) &&
                 static_cast<unsigned>(t_hi - off) < static_cast<unsigned>(Lp);
        }
        if (!__any_sync(0xffffffffu, v_lo || v_hi)) continue;  // all 16 rows masked: adds +0
        const uint32_t m_lo = v_lo ? 0xffffffffu : 0u, m_hi = v_hi ? 0xffffffffu : 0u;
        const __nv_bfloat16* arow = buf + (base + a_row + SIGN * dj) * sx + a_col;
        const __nv_bfloat16* wt = w_s + (dci * kw + dji) * w_tap + b_off;
        for (int ks = 0; ks < cx / kMmaRows; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, arow + ks * kMmaRows);
          a[0] &= m_lo;
          a[1] &= m_hi;
          a[2] &= m_lo;
          a[3] &= m_hi;
          const __nv_bfloat16* wk = wt + ks * b_kstep;
          if constexpr (NT == 8) {
            uint32_t r[2];
            if constexpr (kFwd) {
              ldmatrix_x2_trans(r, wk);
            } else {
              ldmatrix_x2(r, wk);
            }
            mma_bf16(acc[0], a, r[0], r[1]);
          } else {
#pragma unroll
            for (int np = 0; np < NT / 16; ++np) {
              if (n0 + 16 * np >= cy) continue;  // past the channels: the same for the block
              uint32_t r[4];
              if constexpr (kFwd) {
                ldmatrix_x4_trans(r, wk + np * b_pair);
              } else {
                ldmatrix_x4(r, wk + np * b_pair);
              }
              mma_bf16(acc[2 * np], a, r[0], r[1]);
              mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
            }
          }
        }
      }
    }

    // accumulators (e, e + 1) are (row t_lo, columns col + {0, 1}); e = 2 is row t_hi
    float* out_seq = out + (static_cast<size_t>(k) * B + b) * Lp * cy;
#pragma unroll
    for (int nt = 0; nt < NT / 8; ++nt) {
      const int col = n0 + 8 * nt + 2 * (lane & 3);
      if (col >= cy) continue;
      const float b0 = kFwd ? bias[col] : 0.f, b1 = kFwd ? bias[col + 1] : 0.f;
      if (t_lo < Lp) {
        *reinterpret_cast<float2*>(out_seq + static_cast<size_t>(t_lo) * cy + col) =
            make_float2(acc[nt][0] + b0, acc[nt][1] + b1);
      }
      if (t_hi < Lp) {
        *reinterpret_cast<float2*>(out_seq + static_cast<size_t>(t_hi) * cy + col) =
            make_float2(acc[nt][2] + b0, acc[nt][3] + b1);
      }
    }
  };

  // group g takes items g, g + groups, ... of the chunk; a one-stage plan
  // leaves each group at most one item (fold_mma_plan), staged here
  const int my_items = n_items > group ? (n_items - group + q.groups - 1) / q.groups : 0;
  __nv_bfloat16* my_bufs = bufs + group * q.stages * buf_elems;
  if (my_items > 0) stage(i0 + group, my_bufs);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // W and every group's first item are in place

  for (int j = 0; j < my_items; ++j) {
    if (j + 1 < my_items) {  // the ring: item j + 1 loads while item j multiplies
      stage(i0 + group + (j + 1) * q.groups, my_bufs + ((j + 1) % q.stages) * buf_elems);
    }
    cp_async_commit();
    compute(i0 + group + j * q.groups, my_bufs + (j % q.stages) * buf_elems);
    cp_async_wait_all();
    group_barrier(group, g_threads);  // item j + 1 is in place; item j's buffer is free
  }
}

template <int SIGN, int NT>
int launch_nt(const void* x, const void* w, const float* bias, const int* periods,
              const int* cycles, float* out, int B, int Lp, int Cin, int Cout, int kh, int kw,
              int p_max, const FoldMmaPlan& q, cudaStream_t stream) {
  auto* kernel = tap_conv_mma_kernel<SIGN, NT>;
  if (q.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(q.tiles, q.chunks), q.warps * 32, q.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias, periods,
      cycles, out, B, Lp, Cin, Cout, kh, kw, p_max, q);
  return static_cast<int>(cudaGetLastError());
}

template <int SIGN>
int launch(const void* x, const void* w, const void* bias, const void* periods,
           const void* cycles, void* out, int K, int B, int Lp, int Cin, int Cout, int kh,
           int kw, int p_max, void* stream) {
  FoldMmaPlan q;
  const int err = fold_mma_plan(SIGN, K, B, Lp, Cin, Cout, kh, kw, p_max, &q);
  if (err != 0) return err;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);  // cp.async copies 16 bytes at a time
  }
  const auto* b = static_cast<const float*>(bias);
  const auto* per = static_cast<const int*>(periods);
  const auto* cyc = static_cast<const int*>(cycles);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (q.nt) {
    case 32: return launch_nt<SIGN, 32>(x, w, b, per, cyc, o, B, Lp, Cin, Cout, kh, kw, p_max, q, s);
    case 16: return launch_nt<SIGN, 16>(x, w, b, per, cyc, o, B, Lp, Cin, Cout, kh, kw, p_max, q, s);
    default: return launch_nt<SIGN, 8>(x, w, b, per, cyc, o, B, Lp, Cin, Cout, kh, kw, p_max, q, s);
  }
}

}  // namespace

// The plan at this shape for sign = +1 (forward) or -1 (dh), into out[14] in
// the order of FoldMmaPlan. Returns 0, or cudaErrorInvalidValue for a shape
// the kernel cannot take.
extern "C" int tap_conv_mma_plan(int sign, int K, int B, int Lp, int Cin, int Cout, int kh,
                                 int kw, int p_max, int* out) {
  FoldMmaPlan q;
  const int err = fold_mma_plan(sign, K, B, Lp, Cin, Cout, kh, kw, p_max, &q);
  if (err != 0) return err;
  const int fields[14] = {q.lp_pad, q.pad, q.rt, q.band, q.buf_rows, q.nt, q.tiles,
                          q.groups, q.warps, q.stages, q.chunks_per_k, q.per_chunk, q.chunks,
                          q.smem};
  std::copy(fields, fields + 14, out);
  return 0;
}

// The bf16 forward. h: [K, B, Lp, Cin] and w: [kh, kw, Cin, Cout] bf16,
// 16-byte aligned; bias: [Cout] float32; periods, cycles: [K] int32, every
// period at most p_max (make_geometry's p_cap); out: [K, B, Lp, Cout]
// float32. All contiguous, on the current device. Returns a cudaError_t
// value: 0 on a successful launch.
extern "C" int tap_conv_fwd_mma(const void* h, const void* w, const void* bias,
                                const void* periods, const void* cycles, void* out, int K, int B,
                                int Lp, int Cin, int Cout, int kh, int kw, int p_max,
                                void* stream) {
  return launch<1>(h, w, bias, periods, cycles, out, K, B, Lp, Cin, Cout, kh, kw, p_max, stream);
}

// The bf16 dh adjoint. ct: [K, B, Lp, Cout] and w: [kh, kw, Cin, Cout] bf16,
// 16-byte aligned; periods, cycles as for the forward; dh: [K, B, Lp, Cin]
// float32. All contiguous, on the current device. Returns a cudaError_t
// value: 0 on a successful launch.
extern "C" int tap_conv_dh_mma(const void* ct, const void* w, const void* periods,
                               const void* cycles, void* dh, int K, int B, int Lp, int Cin,
                               int Cout, int kh, int kw, int p_max, void* stream) {
  return launch<-1>(ct, w, nullptr, periods, cycles, dh, K, B, Lp, Cin, Cout, kh, kw, p_max,
                    stream);
}
