// Backward of the masked dilated-tap fold convolution for Hopper (sm_90a):
// the dh adjoint and the weight gradient dW.
//
// tap_conv_dh replaces flow_timesnet_tpu/ops/pallas_fold.py::
// _tap_conv_pallas_impl with sign=-1 (the TPU kernel of the Pallas
// backward). tap_conv_dw replaces the XLA contraction
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
// Design (a simple first version; no wgmma or TMA yet):
// - tap_conv_dh mirrors the forward kernel: one block per (k, b) sequence
//   and tile of rows, the whole cotangent sequence staged in shared memory
//   as float32, one kernel row of W staged at a time, transposed to
//   [kw, Cout, Cin] so that the lanes of a warp (consecutive ci) read
//   consecutive W words while they share one cotangent word. An invalid
//   tap is skipped, not multiplied by zero, and no padded copy of ct is
//   made.
// - tap_conv_dw is a split-K reduction over the K*B sequences with no float
//   atomics, so the gradient is the same from run to run. Pass 1: block
//   (dc, chunk) owns one kernel row of dW, [kw, Cin, Cout] accumulators
//   spread over its threads (lane = co, so a warp shares each h word and
//   reads consecutive ct words), walks its chunk of sequences, stages h and
//   ct of each in shared memory and writes its partial row to a scratch
//   buffer that the caller allocates. Pass 2 sums the partials of every
//   element over the chunks in a fixed order.
//
// What bounds them on an H100 SXM (data-sheet figures, not measured): at the
// flagship training shape K=2, B=256, Lp=55, Cin=Cout=32 in bf16, counting
// all kh*kw taps, each is 0.52 / 1.44 / 2.83 GFLOP at 3x3 / 5x5 / 7x7
// (0.5 / 1.5 / 2.9 us at 989 TFLOP/s on the tensor cores); dh moves 5.4 MB
// (ct in, dh out in float32: 1.6 us at 3.35 TB/s), dW 3.6 MB (1.1 us). Both
// multiply on the CUDA cores from shared memory, so they sit far above those
// bounds; chip_smoke.py measures them beside the bounds of the taps the
// selected periods leave valid, and PERF.md keeps the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kOutsPerThread = 8;  // dh: outputs (row, channel) per thread
constexpr int kOutsPerBlock = kThreads * kOutsPerThread;
constexpr int kDwAccPerThread = 32;  // dW: accumulators per thread
constexpr int kDwTargetBlocks = 4 * 132;  // pass 1: about four blocks per SM
constexpr int kMaxSmemBytes = 232448;  // 227 KB: the most one block may use

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
tap_conv_dh_kernel(const T* __restrict__ ct, const T* __restrict__ w,
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

  const T* ct_seq = ct + static_cast<size_t>(seq) * Lp * Cout;
  for (int i = threadIdx.x; i < Lp * Cout; i += kThreads) ct_s[i] = to_float(ct_seq[i]);

  float acc[kOutsPerThread];
#pragma unroll
  for (int i = 0; i < kOutsPerThread; ++i) acc[i] = 0.f;

  const int row_elems = kw * Cin * Cout;
  for (int dc = -rh; dc <= rh; ++dc) {
    __syncthreads();  // the previous W row is consumed; ct_s is complete
    const T* w_row = w + static_cast<size_t>(dc + rh) * row_elems;
    for (int i = threadIdx.x; i < row_elems; i += kThreads) {
      const int j = i / (Cin * Cout), ci = (i / Cout) % Cin, co = i % Cout;
      w_s[(j * Cout + co) * Cin + ci] = to_float(w_row[i]);
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

// Pass 1 of dW: block (dc + rh, chunk) sums kernel row dc over its chunk of
// sequences. A thread owns the outputs (f, co) with co = threadIdx.x % Cout
// and f = dj_index * Cin + ci = threadIdx.x / Cout + j * (kThreads / Cout);
// the tap (dc, dj) at output row t reads h at (row(t) + dc) * p + col(t) + dj,
// whose index in the staged [Lp, Cin] sequence is base + f with
// base = ((row(t) + dc) * p + col(t) - rw) * Cin, and it is valid iff
// 0 <= col(t) + dj < p, i.e. (rw - col(t)) * Cin <= f < (rw - col(t) + p) * Cin.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tap_conv_dw_partial_kernel(const T* __restrict__ h, const T* __restrict__ ct,
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
    const T* h_seq = h + static_cast<size_t>(seq) * Lp * Cin;
    const T* ct_seq = ct + static_cast<size_t>(seq) * Lp * Cout;
    for (int i = threadIdx.x; i < Lp * Cin; i += kThreads) h_s[i] = to_float(h_seq[i]);
    for (int i = threadIdx.x; i < Lp * Cout; i += kThreads) ct_s[i] = to_float(ct_seq[i]);
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

template <typename T>
int launch_dh(const void* ct, const void* w, const int* periods, const int* cycles, float* dh,
              int K, int B, int Lp, int Cin, int Cout, int kh, int kw, cudaStream_t stream) {
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw) || Cin > kOutsPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (static_cast<size_t>(Lp) * Cout +
                                       static_cast<size_t>(kw) * Cin * Cout);
  cudaError_t err = reserve_smem(tap_conv_dh_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_tile = std::min(Lp, kOutsPerBlock / Cin);
  const int tiles = (Lp + rows_per_tile - 1) / rows_per_tile;
  const long long blocks = static_cast<long long>(K) * B * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tap_conv_dh_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(ct), static_cast<const T*>(w), periods, cycles, dh, B, Lp, Cin,
      Cout, kh, kw, rows_per_tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* h, const void* ct, const int* periods, const int* cycles,
              float* partial, float* dw, int K, int B, int Lp, int Cin, int Cout, int kh,
              int kw, cudaStream_t stream) {
  // a thread owns kDwAccPerThread outputs of one column co of a kernel row
  if (bad_shape(K, B, Lp, Cin, Cout, kh, kw) || kThreads % Cout != 0 ||
      static_cast<long long>(kw) * Cin > static_cast<long long>(kDwAccPerThread) * (kThreads / Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(Lp) * (Cin + Cout);
  cudaError_t err = reserve_smem(tap_conv_dw_partial_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_seq = K * B;
  const int chunks = dw_chunks(K, B, kh);
  const int per_chunk = (n_seq + chunks - 1) / chunks;
  tap_conv_dw_partial_kernel<T><<<dim3(kh, chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(ct), periods, cycles, partial, n_seq, B,
      Lp, Cin, Cout, kh, kw, per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_elems = kh * kw * Cin * Cout;
  tap_conv_dw_reduce_kernel<<<(n_elems + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, dw, n_elems, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ct: [K, B, Lp, Cout] and w: [kh, kw, Cin, Cout], both bf16 (is_bf16 != 0)
// or both float32; periods, cycles: [K] int32; dh: [K, B, Lp, Cin] float32.
// All contiguous, on the current device. Returns a cudaError_t value: 0 on a
// successful launch.
extern "C" int tap_conv_dh(const void* ct, int is_bf16, const void* w, const void* periods,
                           const void* cycles, void* dh, int K, int B, int Lp, int Cin,
                           int Cout, int kh, int kw, void* stream) {
  const auto* per = static_cast<const int*>(periods);
  const auto* cyc = static_cast<const int*>(cycles);
  auto* o = static_cast<float*>(dh);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dh<__nv_bfloat16>(ct, w, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, s);
  }
  return launch_dh<float>(ct, w, per, cyc, o, K, B, Lp, Cin, Cout, kh, kw, s);
}

// The number of chunks tap_conv_dw splits the K*B sequences into: its
// scratch buffer `partial` holds chunks * kh * kw * Cin * Cout floats.
extern "C" int tap_conv_dw_chunks(int K, int B, int kh) {
  if (K <= 0 || B <= 0 || kh <= 0) return 0;
  return dw_chunks(K, B, kh);
}

// h: [K, B, Lp, Cin] and ct: [K, B, Lp, Cout], both bf16 (is_bf16 != 0) or
// both float32; periods, cycles: [K] int32; partial: scratch of
// tap_conv_dw_chunks(K, B, kh) * kh * kw * Cin * Cout float32; dw:
// [kh, kw, Cin, Cout] float32. All contiguous, on the current device.
// Returns a cudaError_t value: 0 on a successful launch of both passes.
extern "C" int tap_conv_dw(const void* h, int is_bf16, const void* ct, const void* periods,
                           const void* cycles, void* partial, void* dw, int K, int B, int Lp,
                           int Cin, int Cout, int kh, int kw, void* stream) {
  const auto* per = static_cast<const int*>(periods);
  const auto* cyc = static_cast<const int*>(cycles);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<float*>(dw);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dw<__nv_bfloat16>(h, ct, per, cyc, part, o, K, B, Lp, Cin, Cout, kh, kw, s);
  }
  return launch_dw<float>(h, ct, per, cyc, part, o, K, B, Lp, Cin, Cout, kh, kw, s);
}
