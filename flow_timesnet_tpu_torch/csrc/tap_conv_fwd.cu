// Forward masked dilated-tap fold convolution for Hopper (sm_90a), float32.
//
// Replaces flow_timesnet_tpu/ops/pallas_fold.py::_tap_conv_pallas_impl with
// sign=+1 (the TPU kernel behind model.use_pallas) in float32; in bf16 that
// is tap_conv_mma.cu's tensor-core template, instantiated for sign=+1. It
// computes the XLA form
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
// Design (float32 only, on the CUDA cores, whose float32 FMAs keep the
// products exact; TF32 tensor cores would keep about three digits):
// - One block per (k, b) sequence and tile of output rows. Each block reads
//   its own periods[k] and cycles[k] from device memory, in place of the TPU
//   kernel's scalar prefetch, so the host never learns the periods.
// - The block stages the whole sequence h[k,b,:,:] in shared memory, then
//   loops over the kernel rows dc and stages one row of W,
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
// - Products are summed in float32; the float32 bias is added last. The kernel launches on the caller's stream, allocates nothing and
//   returns cudaGetLastError().
//
// What bounds it on an H100 SXM (data-sheet figures, not measured): at the
// flagship serving shape K=2, B=192, Lp=55, Cin=Cout=32 in float32, h and
// the output are 5.4 MB (1.6 us at 3.35 TB/s), and the multiply-adds of the
// taps the serving periods leave valid take a few us at 67 TFLOP/s. This
// version reads every operand from shared memory, so it sits far above
// those bounds. chip_smoke.py measures it beside its bound; PERF.md keeps
// the numbers.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kOutsPerThread = 8;
constexpr int kOutsPerBlock = kThreads * kOutsPerThread;
constexpr int kMaxSmemBytes = 232448;  // 227 KB: the most one block may use

__global__ void __launch_bounds__(kThreads)
tap_conv_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
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

  const float* h_seq = h + static_cast<size_t>(seq) * Lp * Cin;
  for (int i = threadIdx.x; i < Lp * Cin; i += kThreads) h_s[i] = h_seq[i];

  float acc[kOutsPerThread];
#pragma unroll
  for (int i = 0; i < kOutsPerThread; ++i) acc[i] = 0.f;

  const int row_elems = kw * Cin * Cout;
  for (int dc = -rh; dc <= rh; ++dc) {
    __syncthreads();  // the previous W row is consumed; h_s is complete
    const float* w_row = w + static_cast<size_t>(dc + rh) * row_elems;
    for (int i = threadIdx.x; i < row_elems; i += kThreads) w_s[i] = w_row[i];
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

int launch(const float* h, const float* w, const float* bias, const int* periods,
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
        tap_conv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows_per_tile = std::min(Lp, kOutsPerBlock / Cout);
  const int tiles = (Lp + rows_per_tile - 1) / rows_per_tile;
  const long long blocks = static_cast<long long>(K) * B * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tap_conv_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      h, w, bias, periods, cycles, out, B, Lp, Cin, Cout, kh, kw, rows_per_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 route (bf16 is tap_conv_mma.cu's tap_conv_fwd_mma). h:
// [K, B, Lp, Cin], w: [kh, kw, Cin, Cout] and bias: [Cout] float32; periods,
// cycles: [K] int32; out: [K, B, Lp, Cout] float32. All contiguous, on the
// current device. Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tap_conv_fwd(const void* h, const void* w, const void* bias, const void* periods,
                            const void* cycles, void* out, int K, int B, int Lp, int Cin,
                            int Cout, int kh, int kw, void* stream) {
  return launch(static_cast<const float*>(h), static_cast<const float*>(w),
                static_cast<const float*>(bias), static_cast<const int*>(periods),
                static_cast<const int*>(cycles), static_cast<float*>(out), K, B, Lp, Cin, Cout,
                kh, kw, static_cast<cudaStream_t>(stream));
}
