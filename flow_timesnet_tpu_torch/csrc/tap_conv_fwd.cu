// Forward masked dilated-tap fold convolution for Hopper (sm_90a).
//
// Replaces flow_timesnet_tpu/ops/pallas_fold.py::_tap_conv_pallas_impl with
// sign=+1 (the TPU kernel behind model.use_pallas). It computes the XLA form
// of the JAX package's tap_conv, with W rounded to h's type, as the plain
// version in flow_timesnet_tpu_torch/ops/fold.py::tap_conv does. In float32
// that equals the Pallas kernel; in bf16 the Pallas kernel keeps W in
// float32, and the XLA form is the one the flagship serves (use_pallas off):
//
//   out[k,b,t,:] = bias + sum_{dc,dj} [0 <= t%p + dj < p] [0 <= t/p + dc < cycles]
//                                     * h[k,b,t + dc*p + dj,:] @ W[dc,dj]
//
// with p = periods[k], cycles = cycles[k]: Conv2d with 'same' zero padding
// over the [cycles, p] fold of each candidate period, written over the flat
// time axis so that the shapes do not depend on the periods.
//
// Design (a simple first version; no wgmma or TMA yet):
// - One block per (k, b) sequence and tile of output rows. Each block reads
//   its own periods[k] and cycles[k] from device memory, in place of the TPU
//   kernel's scalar prefetch, so the host never learns the periods.
// - The block stages the whole sequence h[k,b,:,:] in shared memory as
//   float32, then loops over the kernel rows dc and stages one row of W,
//   [kw, Cin, Cout] (28 KB in float32 at 7x7 and Cin = Cout = 32), as the
//   TPU kernel's rolled dc loop does. Staging all of W would take 200 KB.
// - A thread owns up to kOutsPerThread outputs (row, channel); with
//   Cout = 32 a warp owns one row, so every lane takes the same branch and
//   reads the same h element (a shared-memory broadcast) while the lanes
//   read consecutive W elements.
// - A tap whose mask is false is skipped, not multiplied by zero: a valid
//   tap reads h at t + dc*p + dj = (t/p + dc)*p + (t%p + dj), inside
//   [0, cycles*p), so no padded copy of h is needed (the jnp.pad of the TPU
//   kernel is an artifact of its fixed-size block slices). At small periods
//   most of the kh*kw taps of a row fall outside the grid.
// - Products are of float32 values upcast from h's type (bf16 x bf16 is
//   exact in float32) and are summed in float32; the float32 bias is added
//   last. The kernel launches on the caller's stream, allocates nothing and
//   returns cudaGetLastError().
//
// What bounds it on an H100 SXM (data-sheet figures, not measured): at the
// flagship serving shape K=2, B=192, Lp=55, Cin=Cout=32 in bf16, counting
// all kh*kw taps, 3x3 is 0.39 GFLOP over about 4.1 MB (memory-bound, about
// 1.2 us at 3.35 TB/s), 5x5 is 1.08 GFLOP over about 4.2 MB (about 1.2 us)
// and 7x7 is 2.12 GFLOP over about 4.3 MB (compute-bound, about 2.1 us at
// 989 TFLOP/s on the tensor cores). This version multiplies on the CUDA
// cores (67 TFLOP/s float32) and reads every operand from shared memory,
// so it sits far above those bounds; the tensor cores are later work.
// chip_smoke.py measures it beside its bound; PERF.md keeps the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kOutsPerThread = 8;
constexpr int kOutsPerBlock = kThreads * kOutsPerThread;
constexpr int kMaxSmemBytes = 232448;  // 227 KB: the most one block may use

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
tap_conv_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const float* __restrict__ bias, const int* __restrict__ periods,
                    const int* __restrict__ cycles, float* __restrict__ out,
                    int B, int Lp, int Cin, int Cout, int kh, int kw, int rows_per_tile) {
  extern __shared__ float smem[];
  float* h_s = smem;              // [Lp, Cin]: the whole (k, b) sequence
  float* w_s = smem + Lp * Cin;   // [kw, Cin, Cout]: one kernel row of W

  const int tiles = (Lp + rows_per_tile - 1) / rows_per_tile;
  const int seq = blockIdx.x / tiles;  // k * B + b
  const int t0 = (blockIdx.x % tiles) * rows_per_tile;
  const int n_out = min(rows_per_tile, Lp - t0) * Cout;
  const int k = seq / B;
  const int p = max(periods[k], 1);
  const int cyc = cycles[k];
  const int rh = kh / 2, rw = kw / 2;

  const T* h_seq = h + static_cast<size_t>(seq) * Lp * Cin;
  for (int i = threadIdx.x; i < Lp * Cin; i += kThreads) h_s[i] = to_float(h_seq[i]);

  float acc[kOutsPerThread];
#pragma unroll
  for (int i = 0; i < kOutsPerThread; ++i) acc[i] = 0.f;

  const int row_elems = kw * Cin * Cout;
  for (int dc = -rh; dc <= rh; ++dc) {
    __syncthreads();  // the previous W row is consumed; h_s is complete
    const T* w_row = w + static_cast<size_t>(dc + rh) * row_elems;
    for (int i = threadIdx.x; i < row_elems; i += kThreads) w_s[i] = to_float(w_row[i]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOutsPerThread; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o >= n_out) continue;
      const int t = t0 + o / Cout;
      const int co = o % Cout;
      const int r = t / p + dc;
      if (r < 0 || r >= cyc) continue;
      const int c = t % p;
      float a = acc[i];
      for (int dj = -rw; dj <= rw; ++dj) {
        const int cc = c + dj;
        const int s = r * p + cc;  // == t + dc*p + dj
        if (cc < 0 || cc >= p || s >= Lp) continue;
        const float* hs = h_s + s * Cin;
        const float* ws = w_s + (dj + rw) * Cin * Cout + co;
#pragma unroll 4
        for (int ci = 0; ci < Cin; ++ci) a = fmaf(hs[ci], ws[ci * Cout], a);
      }
      acc[i] = a;
    }
  }

  float* out_seq = out + static_cast<size_t>(seq) * Lp * Cout + static_cast<size_t>(t0) * Cout;
#pragma unroll
  for (int i = 0; i < kOutsPerThread; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < n_out) out_seq[o] = acc[i] + bias[o % Cout];
  }
}

template <typename T>
int launch(const void* h, const void* w, const float* bias, const int* periods,
           const int* cycles, float* out, int K, int B, int Lp, int Cin, int Cout,
           int kh, int kw, cudaStream_t stream) {
  if (K <= 0 || B <= 0 || Lp <= 0 || Cin <= 0 || Cout <= 0 || Cout > kOutsPerBlock ||
      kh <= 0 || kw <= 0 || kh % 2 == 0 || kw % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (static_cast<size_t>(Lp) * Cin +
                                       static_cast<size_t>(kw) * Cin * Cout);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tap_conv_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows_per_tile = std::min(Lp, kOutsPerBlock / Cout);
  const int tiles = (Lp + rows_per_tile - 1) / rows_per_tile;
  const long long blocks = static_cast<long long>(K) * B * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tap_conv_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), bias, periods, cycles, out,
      B, Lp, Cin, Cout, kh, kw, rows_per_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: [K, B, Lp, Cin] and w: [kh, kw, Cin, Cout], both bf16 (h_is_bf16 != 0)
// or both float32; bias: [Cout] float32; periods, cycles: [K] int32;
// out: [K, B, Lp, Cout] float32. All contiguous, on the current device.
// Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tap_conv_fwd(const void* h, int h_is_bf16, const void* w, const void* bias,
                            const void* periods, const void* cycles, void* out, int K, int B,
                            int Lp, int Cin, int Cout, int kh, int kw, void* stream) {
  const auto* b = static_cast<const float*>(bias);
  const auto* per = static_cast<const int*>(periods);
  const auto* cyc = static_cast<const int*>(cycles);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (h_is_bf16) {
    return launch<__nv_bfloat16>(h, w, b, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, s);
  }
  return launch<float>(h, w, b, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, s);
}
