// Forward masked dilated-tap fold convolution for Hopper (sm_90a), float32.
//
// Replaces flow_timesnet_tpu/ops/pallas_fold.py::_tap_conv_pallas_impl with
// sign=+1 (77-184, pl.pallas_call at 174; the TPU kernel behind
// model.use_pallas) in float32; in bf16 that is tap_conv_mma.cu's
// tensor-core template, instantiated for sign=+1. It computes the XLA form
// of the JAX package's tap_conv, as the plain version in
// flow_timesnet_tpu_torch/ops/fold.py::tap_conv does; in float32 that equals
// the Pallas kernel:
//
//   out[k,b,t,:] = bias + sum_{dc,dj} [0 <= t/p + dc < cycles] [0 <= t%p + dj < p]
//                                     * h[k,b,t + dc*p + dj,:] @ W[dc,dj]
//
// with p = periods[k], cycles = cycles[k]: Conv2d with 'same' zero padding
// over the [cycles, p] fold of each candidate period, written over the flat
// time axis so that the shapes do not depend on the periods. A valid tap
// reads h at t + dc*p + dj = (t/p + dc)*p + (t%p + dj), inside
// [0, cycles*p), so no padded copy of h is needed. The mask belongs to the
// output row t and is not bounded by the fold: rows [cycles*p, Lp) read the
// grid through taps with dc < 0, and later convs read them as data.
//
// On the CUDA cores, whose float32 FMAs keep the products exact: TF32 tensor
// cores would keep about three digits of each product, and 3xTF32 drops the
// low x low term, so neither is used. Products are summed in float32; the
// float32 bias is added last. The kernel launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().
//
// What bounds it on an H100 SXM (data-sheet figures: 67 TFLOP/s float32
// outside the tensor cores, 3.35 TB/s): operations. At the flagship serving
// shape (K=2, B=192, Lp=55, Cin=Cout=32) and its periods [7, 27], the taps
// the fold leaves valid take 3.1 / 6.0 / 9.0 us at 3x3 / 5x5 / 7x7, against
// 5.4 MB of h and output, 1.6 us. chip_smoke.py measures it beside these
// bounds and cuDNN's float32 convolution (TF32 off); PERF.md keeps the
// numbers.
//
// Design: tap_conv_bwd.cu's float32 dh, with the roles of the operands
// turned round. An item is a tile of rt = 64 (where that fits, else 32 or
// 16) output rows of one sequence (at the flagship, the whole sequence:
// Lp = 55). What held the first design (one block per sequence and row
// tile, the sequence and each kernel row of W restaged behind two block
// barriers, one FMA per two shared-memory loads, a mask tested per output)
// back, and what this one does about it:
// - Register micro-tiles. A lane owns 4 output rows x 4 consecutive output
//   channels (16 float32 sums). Per 4 input channels ci it loads one float4
//   of h for each row and one float4 of W (4 co of one ci) for each ci: 8
//   16-byte loads for 64 FMAs. W is read as it lies: its rows are [ci][co],
//   and the forward reduces over ci, W's outer axis, so a lane takes its 4
//   co of each ci, and no transpose is needed on the host or in shared
//   memory. Lanes are RG rows by CG channel groups (CG = NT / 4 for a
//   block's tile of NT output channels, RG = 32 / CG): lane l has rows
//   l % RG + RG i and channels 4 (l / RG) .. + 3, so a warp owns WR = 4 RG
//   consecutive rows, the RG lanes of an h load read consecutive staged rows
//   and every lane of a W load reads one row of W.
// - W once per block, as it lies. Blocks are persistent over a chunk of
//   items and stage their NT-column slice of every [tap][ci] row of W once,
//   by 16-byte cp.async. A warp's W loads read one staged row, so W's rows
//   are NT floats with no padding; h's staged rows hold an odd number of
//   float4s (f32_stride), so 8 consecutive rows start in distinct bank
//   groups. NT is 32, 16 or 8: the plan takes the tile that leaves room
//   for the most warps (at the flagship 7x7, W's 32 columns are 196 KB, so
//   16 channels a tile).
// - Zero row as the mask. h rows of an item are staged by cp.async, one
//   window or (long sequences) kh bands. The mask of the output row, its
//   range and the source row's range select which row a lane reads: its
//   source, or one zero row. Nothing is multiplied by a mask (0 * NaN is
//   NaN), and the rows of h the fold never reads may hold anything.
// - Warp-level tap skip. A tap that masks every row of a warp is skipped by
//   a warp vote; at the flagship's p = 7 the warps of rows 48-63 skip every
//   tap at 3x3.
// - Balance. Items alternate between the candidates, so every chunk holds
//   as much of each period as the others; and warp w is row tile w / groups
//   of group (w - w / groups) mod groups, so each group's warps, and the
//   first row tiles, spread over the 4 schedulers.
// - Groups of warps: each group (rt / WR warps, at least one) stages one
//   item at a time and syncs on its own named barrier, so one group's loads
//   overlap the others' multiply-adds.
// - Fixed sum order: each output sums taps in (dc, dj) order, then ci in
//   order, in one thread, and adds the bias last. The same bits come back
//   every run. One launch, no scratch: each output is written by one lane.
// - Passes. Where W's slice and one staged item would pass 227 KB at every
//   tile, the plan cuts the kernel rows into slices of kr rows and then Cin
//   into slices of kc channels (a multiple of 4), the fewest that fit, and
//   the block makes one pass over its items for each (rows, channels)
//   slice, W's slice staged once a pass and an item's bands only for its kr
//   rows. A lane adds each pass's sum to what it wrote in the pass before
//   (its own outputs, so no other thread's write is awaited) and adds the
//   bias in the last. So every shape the first kernel took (4 (Lp Cin + kw
//   Cin Cout) bytes within 227 KB, Cout up to 2048) has a plan; the
//   flagship's shapes take one pass.
//
// ops/cuda_fold.py::fwd_f32_plan mirrors the plan constant for constant; a
// card test holds the two together, and tests/test_torch_fwd_f32_tiles.py
// models the cuts in numpy on the CPU.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "f32_stage.cuh"
#include "run_count.cuh"

namespace {

constexpr int kFwdTiles[3] = {32, 16, 8};  // output channels of a block's tile, widest first

// The launch plan of tap_conv_fwd_kernel; ops/cuda_fold.py::fwd_f32_plan mirrors it.
struct FwdF32Plan {
  int lp_pad;     // Lp rounded up to whole items
  int pad;        // (kh / 2) * p_max + kw / 2: the largest |dc * p + dj|
  int rt;         // output rows of an item (64, 32 or 16)
  int band;       // 1: an item is staged as kr bands of rt + kw - 1 rows; 0: one window
  int buf_rows;   // rows of a staged item: min(Lp, rt + 2 * pad), or kr * (rt + kw - 1)
  int kr;         // kernel rows of a pass: kh, or fewer where all of W's taps do not fit
  int kc;         // input channels of a pass: Cin, or a multiple of 4 where Cin takes passes
  int passes;     // passes of a block over its items: ceil(kh / kr) * ceil(Cin / kc)
  int sx;         // floats of a staged row of h: f32_stride(kc)
  int nt;         // output channels of a block's tile (32, 16 or 8)
  int tiles;      // channel tiles: ceil(Cout / nt)
  int groups;     // items a block multiplies at once, max(1, rt / WR) warps each
  int warps;      // warps of a block
  int per_chunk;  // items of a chunk (the last one may hold fewer)
  int chunks;     // chunks of the K * B * lp_pad / rt items, candidates interleaved
  int smem;       // dynamic shared memory of a block, bytes
};

// Block (output-channel tile blockIdx.x, chunk blockIdx.y). h: [K, B, Lp,
// Cin], w: [kh, kw, Cin, Cout], bias: [Cout], out: [K, B, Lp, Cout], all
// float32. Item i is row tile (i / K) % n_rt of sequence (i % K, i / K /
// n_rt): candidates alternate, so a chunk holds both periods alike.
template <int NT>
__global__ void __launch_bounds__(kF32MaxWarps * 32, 1)
tap_conv_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ bias, const int* __restrict__ periods,
                    const int* __restrict__ cycles, float* __restrict__ out, int K, int B,
                    int Lp, int Cin, int Cout, int kh, int kw, int p_max, FwdF32Plan q,
                    int* __restrict__ runs) {
  count_run(runs);
  constexpr int CG = NT / 4, RG = 32 / CG, WR = 4 * RG;  // lanes: RG rows x CG groups of 4 co
  extern __shared__ __align__(16) float smem[];
  const int sx = q.sx;
  const int kc4 = (q.kc + 3) / 4 * 4;
  float* w_s = smem;  // [tap][kc4][NT]: W's slice, its [ci][co] rows as they are in W
  float* bufs = smem + q.kr * kw * kc4 * NT;  // groups x buf_rows x sx: the staged items
  float* zero = bufs + q.groups * q.buf_rows * sx;  // one zero row: what a masked lane reads

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
  const int rg = lane % RG, co = n0 + 4 * (lane / RG);  // rows rg + RG i, channels co .. co + 3
  // 16-byte copies of h's rows, and of W's rows and 16-byte outputs
  const bool vec_h = Cin % 4 == 0, vec_co = Cout % 4 == 0;

  float b[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) b[m] = co + m < Cout ? bias[co + m] : 0.f;
  for (int i = threadIdx.x; i < sx; i += blockDim.x) zero[i] = 0.f;

  struct Item {
    int k, b, t0, p, cyc, padw;
  };
  auto item_of = [&](int i) {
    Item it;
    it.k = i % K;
    it.b = i / K / n_rt;
    it.t0 = (i / K % n_rt) * rt;
    it.p = min(max(periods[it.k], 1), p_max);  // the geometry's clamp; the window assumes it
    it.cyc = cycles[it.k];
    it.padw = rh * it.p + rw;  // window rows this period needs on each side
    return it;
  };

  // the item's rows of h that kernel rows [r0, r1) read, columns [ci0, ci0 +
  // kc), by the group's threads, asynchronously
  auto stage = [&](const Item& it, int r0, int r1, int ci0, float* buf) {
    const float* seq = h + (static_cast<size_t>(it.k) * B + it.b) * Lp * Cin;
    if (q.band) {  // band s: the rows kernel row r0 + s - rh reads, t0 + (r0 + s - rh) * p - rw on
      for (int s = 0; s < r1 - r0; ++s) {
        stage_rows(buf + s * band_rows * sx, sx, seq, Lp, Cin, it.t0 + (r0 + s - rh) * it.p - rw,
                   band_rows, ci0, q.kc, vec_h, g_tid, g_threads);
      }
    } else {  // one window: rows [max(0, t0 - padw), t0 + rt + padw) of [0, Lp)
      const int w0 = max(0, it.t0 - it.padw);
      stage_rows(buf, sx, seq, Lp, Cin, w0, min(Lp, it.t0 + rt + it.padw) - w0, ci0, q.kc,
                 vec_h, g_tid, g_threads);
    }
  };

  auto compute = [&](const Item& it, const float* buf, int r0, int r1, int cw4, bool first,
                     bool last) {
    const int p = it.p, t0 = it.t0;
    const int w0 = max(0, t0 - it.padw);
    const int end = min(t0 + rt, Lp);  // rows past the item or the sequence: not computed
    int t[4], row[4], col[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[i] = t0 + wt * WR + rg + RG * i;  // this lane's rows (past the item where rt < WR)
      row[i] = t[i] / p;  // t >= 0: the floor
      col[i] = t[i] - row[i] * p;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[i][m] = 0.f;

    for (int dci = r0; dci < r1; ++dci) {
      const int dc = dci - rh;
      // staged row of (t, dc, dj): base + (t - t0) + dj
      const int base = q.band ? (dci - r0) * band_rows + rw : t0 - w0 + dc * p;
      for (int dji = 0; dji < kw; ++dji) {
        const int dj = dji - rw, off = dc * p + dj;
        bool v[4];
        bool any = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = t[i] < end && static_cast<unsigned>(row[i] + dc) < static_cast<unsigned>(it.cyc) &&
                 static_cast<unsigned>(col[i] + dj) < static_cast<unsigned>(p) &&
                 static_cast<unsigned>(t[i] + off) < static_cast<unsigned>(Lp);
          any = any || v[i];
        }
        if (!__any_sync(0xffffffffu, any)) continue;  // every row of the warp masked: adds +0
        const float* a_row[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a_row[i] = v[i] ? buf + (base + t[i] - t0 + dj) * sx : zero;
        const float* wr = w_s + ((dci - r0) * kw + dji) * kc4 * NT + (co - n0);  // + ci * NT: ci
#pragma unroll 2
        for (int ci = 0; ci < cw4; ci += 4) {
          float4 a[4], x[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(a_row[i] + ci);
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] = *reinterpret_cast<const float4*>(wr + (ci + j) * NT);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][0] = fmaf(av[j], x[j].x, acc[i][0]);
              acc[i][1] = fmaf(av[j], x[j].y, acc[i][1]);
              acc[i][2] = fmaf(av[j], x[j].z, acc[i][2]);
              acc[i][3] = fmaf(av[j], x[j].w, acc[i][3]);
            }
          }
        }
      }
    }

    // a later pass adds its sum to what this lane wrote in the pass before
    float* o = out + (static_cast<size_t>(it.k) * B + it.b) * Lp * Cout;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (t[i] >= end || co >= Cout) continue;
      float* dst = o + static_cast<size_t>(t[i]) * Cout + co;
      float r[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      if (vec_co) {
        if (!first) {
          const float4 prev = *reinterpret_cast<const float4*>(dst);
          r[0] = prev.x + r[0];
          r[1] = prev.y + r[1];
          r[2] = prev.z + r[2];
          r[3] = prev.w + r[3];
        }
        if (last) {
#pragma unroll
          for (int m = 0; m < 4; ++m) r[m] += b[m];
        }
        *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (co + m >= Cout) continue;
          float v = first ? r[m] : dst[m] + r[m];
          dst[m] = last ? v + b[m] : v;
        }
      }
    }
  };

  // group g takes items g, g + groups, ... of the chunk, one staged at a time,
  // once a pass
  const int my_items = n_items > group ? (n_items - group + q.groups - 1) / q.groups : 0;
  float* my_buf = bufs + group * q.buf_rows * sx;
  const int ci_passes = (Cin + q.kc - 1) / q.kc;
  for (int pass = 0; pass < q.passes; ++pass) {
    // this pass's kernel rows [r0, r1) and input channels [ci0, ci0 + cw)
    const int r0 = pass / ci_passes * q.kr, r1 = min(kh, r0 + q.kr);
    const int ci0 = pass % ci_passes * q.kc;
    const int cw = min(q.kc, Cin - ci0), cw4 = (cw + 3) / 4 * 4;
    const int taps = (r1 - r0) * kw;
    if (pass > 0) __syncthreads();  // every group is done with the last pass's W and items
    // W's slice, 16 bytes a copy where Cout allows; its rows [cw, cw4) and the
    // staged h columns [cw, cw4) are zero (no copy writes them), and the loop
    // over ci stops at cw4
    for (int tap = 0; tap < taps; ++tap) {
      stage_rows(w_s + tap * kc4 * NT, NT, w + static_cast<size_t>(r0 * kw + tap) * Cin * Cout,
                 Cin, Cout, ci0, q.kc, n0, NT, vec_co, threadIdx.x, blockDim.x);
    }
    if (cw4 > cw) {
      const int pads = cw4 - cw;
      for (int i = threadIdx.x; i < taps * pads * NT; i += blockDim.x) {
        w_s[((i / NT) / pads * kc4 + cw + (i / NT) % pads) * NT + i % NT] = 0.f;
      }
      for (int i = threadIdx.x; i < q.groups * q.buf_rows * pads; i += blockDim.x) {
        bufs[(i / pads) * sx + cw + i % pads] = 0.f;
      }
    }
    if (my_items > 0) stage(item_of(i0 + group), r0, r1, ci0, my_buf);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // W, the zeros and every group's first item are in place
    for (int j = 0; j < my_items; ++j) {
      const Item it = item_of(i0 + group + j * q.groups);
      if (j > 0) {
        group_barrier(group, g_threads);  // item j - 1 is consumed
        stage(it, r0, r1, ci0, my_buf);
        cp_async_commit();
        cp_async_wait_all();
        group_barrier(group, g_threads);  // item j is in place
      }
      compute(it, my_buf, r0, r1, cw4, pass == 0, pass == q.passes - 1);
    }
  }
}

bool bad_shape(int K, int B, int Lp, int Cin, int Cout, int kh, int kw, int p_max) {
  return K <= 0 || B <= 0 || Lp <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 || kw <= 0 ||
         kh % 2 == 0 || kw % 2 == 0 || p_max < 1 || p_max > Lp;
}

// 0, or cudaErrorInvalidValue for a shape tap_conv_fwd_kernel cannot take:
// p_max outside [1, Lp], W's 8-column slice of one kernel row at 4 input
// channels and one staged 16-row item above 227 KB, or more items or chunks
// (f32_chunks), or a larger tap offset, than it counts. It takes the fewest
// passes over the kernel rows, then over Cin, at which a tile fits (one
// pass where it can). Of the channel tiles (32 and 16 only where Cout
// reaches them, 8 always) it takes the one with room for the most warps
// (ties: the wider), each with the first item height and then the most
// groups that fit.
int fwd_f32_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw, int p_max,
                 FwdF32Plan* plan) {
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw, p_max)) return static_cast<int>(cudaErrorInvalidValue);
  FwdF32Plan q{};
  const long long pad = 1LL * (kh / 2) * p_max + kw / 2;
  long long smem = 0;
  for (int row_passes = 1; q.warps == 0 && row_passes <= kh; ++row_passes) {
    const int kr = (kh + row_passes - 1) / row_passes;
    for (int ci_passes = 1; q.warps == 0 && ci_passes <= (Cin + 3) / 4; ++ci_passes) {
      // a slice of kc channels: all of Cin, else a multiple of 4 (16-byte copies)
      const int kc = ci_passes == 1 ? Cin : ((Cin + ci_passes - 1) / ci_passes + 3) / 4 * 4;
      const long long w_floats = 1LL * kr * kw * ((kc + 3) / 4 * 4), sx = f32_stride(kc);
      for (int nt : kFwdTiles) {
        if (nt > Cout && nt != 8) continue;
        const int wr = 512 / nt;  // a warp's rows: 4 * RG, RG = 32 / (nt / 4)
        bool fits = false;
        for (int rt : kF32RowTiles) {
          if (fits) break;
          const long long window = std::min<long long>(Lp, rt + 2 * pad);
          const long long bands = 1LL * kr * (rt + kw - 1);
          const long long rows = std::min(window, bands);
          const int tpi = std::max(1, rt / wr);
          for (int groups = std::min(kF32MaxGroups, kF32MaxWarps / tpi); groups >= 1; --groups) {
            const long long bytes = 4 * (w_floats * nt + (groups * rows + 1) * sx);
            if (bytes > kMaxSmemBytes) continue;
            fits = true;
            if (groups * tpi > q.warps) {
              q.rt = rt;
              q.band = bands < window ? 1 : 0;
              q.buf_rows = static_cast<int>(rows);
              q.kr = kr;
              q.kc = kc;
              q.passes = (kh + kr - 1) / kr * ((Cin + kc - 1) / kc);
              q.sx = static_cast<int>(sx);
              q.nt = nt;
              q.groups = groups;
              q.warps = groups * tpi;
              smem = bytes;
            }
            break;
          }
        }
      }
    }
  }
  if (q.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  q.lp_pad = (Lp + q.rt - 1) / q.rt * q.rt;
  q.pad = static_cast<int>(pad);
  q.tiles = (Cout + q.nt - 1) / q.nt;
  q.smem = static_cast<int>(smem);
  if (pad > 0x7fffffffLL || !f32_chunks(1LL * K * B * (q.lp_pad / q.rt), q.warps, smem, q.tiles,
                                         &q.per_chunk, &q.chunks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *plan = q;
  return 0;
}

template <int NT>
int launch_nt(const float* h, const float* w, const float* bias, const int* periods,
              const int* cycles, float* out, int K, int B, int Lp, int Cin, int Cout, int kh,
              int kw, int p_max, const FwdF32Plan& q, int* runs, cudaStream_t stream) {
  auto* kernel = tap_conv_fwd_kernel<NT>;
  const cudaError_t err = reserve_smem(kernel, q.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(q.tiles, q.chunks), q.warps * 32, q.smem, stream>>>(
      h, w, bias, periods, cycles, out, K, B, Lp, Cin, Cout, kh, kw, p_max, q, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan of the float32 forward at this shape, into out[16] in the order
// of FwdF32Plan. Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int tap_conv_fwd_plan(int K, int B, int Lp, int Cin, int Cout, int kh, int kw,
                                 int p_max, int* out) {
  FwdF32Plan q;
  const int err = fwd_f32_plan(K, B, Lp, Cin, Cout, kh, kw, p_max, &q);
  if (err != 0) return err;
  const int fields[16] = {q.lp_pad, q.pad, q.rt, q.band, q.buf_rows, q.kr, q.kc, q.passes,
                          q.sx, q.nt, q.tiles, q.groups, q.warps, q.per_chunk, q.chunks, q.smem};
  std::copy(fields, fields + 16, out);
  return 0;
}

// The float32 route (bf16 is tap_conv_mma.cu's tap_conv_fwd_mma). h:
// [K, B, Lp, Cin] and w: [kh, kw, Cin, Cout] float32, 16-byte aligned; bias:
// [Cout] float32; periods, cycles: [K] int32, every period at most p_max
// (p_cap, or a dense geometry's period); out: [K, B, Lp, Cout] float32; runs:
// the int32 cell this launch adds 1 to when it runs (or null). All contiguous,
// on the current device. Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tap_conv_fwd(const void* h, const void* w, const void* bias, const void* periods,
                            const void* cycles, void* out, int K, int B, int Lp, int Cin,
                            int Cout, int kh, int kw, int p_max, void* runs, void* stream) {
  FwdF32Plan q;
  const int err = fwd_f32_plan(K, B, Lp, Cin, Cout, kh, kw, p_max, &q);
  if (err != 0) return err;
  if (!aligned16(h) || !aligned16(w)) {
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte copies
  }
  const auto* x = static_cast<const float*>(h);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto* per = static_cast<const int*>(periods);
  const auto* cyc = static_cast<const int*>(cycles);
  auto* o = static_cast<float*>(out);
  auto* r = static_cast<int*>(runs);
  auto s = static_cast<cudaStream_t>(stream);
  switch (q.nt) {
    case 32:
      return launch_nt<32>(x, wp, bp, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, p_max, q, r, s);
    case 16:
      return launch_nt<16>(x, wp, bp, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, p_max, q, r, s);
    default:
      return launch_nt<8>(x, wp, bp, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, p_max, q, r, s);
  }
}
