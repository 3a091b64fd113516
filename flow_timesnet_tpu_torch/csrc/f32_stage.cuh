// What the float32 fold-conv kernels on the CUDA cores share
// (tap_conv_fwd.cu's forward, tap_conv_bwd.cu's dh and dW): the card's
// limits their plans size blocks by, the staged-row stride and the cp.async
// stager. The PTX wrappers themselves are in mma_ptx.cuh. ops/_build.py
// hashes every csrc/*.cuh into each library's name, so an edit here rebuilds
// every library.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma_ptx.cuh"

// an H100 SXM; ops/cuda_fold.py mirrors these
constexpr int kMaxSmemBytes = 232448;  // 227 KB: the most one block may use
constexpr int kSmemPerSm = 233472;     // 228 KB a streaming multiprocessor
constexpr int kSmemReserved = 1024;    // what the runtime keeps of it per block
constexpr int kSms = 132;

// the float32 kernels' blocks
constexpr int kF32MaxWarps = 16;                           // warps of a block
constexpr int kF32RegsCap = 65536 / (kF32MaxWarps * 32);  // __launch_bounds__(512, 1)
constexpr int kF32MaxGroups = 15;  // a group syncs on named barrier group + 1, of 1-15
constexpr int kF32RowTiles[3] = {64, 32, 16};  // output rows of an item, preferred first

// floats of a staged float32 row of `cols` channels: whole float4s, an odd
// number of them, so that 8 consecutive rows start in 8 distinct bank groups
__host__ __device__ constexpr int f32_stride(int cols) { return ((cols + 3) / 4 | 1) * 4; }

// Rows [g0, g0 + n) of a [Lp, C] float32 sequence, columns [c0, c0 + cols)
// that lie inside C, into dst rows of `stride` floats, asynchronously; rows
// outside [0, Lp) are left as they are. vec: C % 4 == 0 and the sequence
// starts on 16 bytes, so whole 16-byte vectors (c0 is a multiple of 4);
// else 4-byte copies.
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* seq, int Lp,
                                           int C, int g0, int n, int c0, int cols, bool vec,
                                           int tid, int nthr) {
  const int lo = max(0, -g0), hi = min(n, Lp - g0);
  const int w = min(cols, C - c0);
  if (hi <= lo || w <= 0) return;
  const float* src = seq + static_cast<size_t>(g0 + lo) * C + c0;
  dst += lo * stride;
  const int per_row = vec ? w / 4 : w;
  // copy tid + j * nthr of (hi - lo) rows x per_row, its (row, unit) walked without a division
  const int dr = nthr / per_row, du = nthr % per_row;
  int r = tid / per_row, u = tid % per_row;
  while (r < hi - lo) {
    if (vec) {
      cp_async16(dst + r * stride + 4 * u, src + static_cast<size_t>(r) * C + 4 * u);
    } else {
      cp_async4(dst + r * stride + u, src + static_cast<size_t>(r) * C + u);
    }
    r += dr;
    u += du;
    if (u >= per_row) {
      u -= per_row;
      ++r;
    }
  }
}

// The chunks of a float32 plan (the forward's or dh's): `items` items cut
// into chunks, a persistent block each, that fill one wave of resident
// blocks of `warps` warps and `smem` bytes over `tiles` channel tiles,
// registers counted at the launch bounds' cap. False where a grid, or the
// kernels' int item count, cannot hold them.
inline bool f32_chunks(long long items, int warps, long long smem, int tiles, int* per_chunk,
                       int* chunks) {
  const int resident = std::max(1, std::min({kF32MaxWarps * 4 / warps,
                                             static_cast<int>(kSmemPerSm / (smem + kSmemReserved)),
                                             65536 / (warps * 32 * kF32RegsCap)}));
  const long long want = std::max(1, (kSms * resident + tiles - 1) / tiles);
  const long long per = (items + std::min(items, want) - 1) / std::min(items, want);
  const long long n = (items + per - 1) / per;
  if (items > 0x7fffffffLL || n > 65535 || tiles > 65535) return false;
  *per_chunk = static_cast<int>(per);
  *chunks = static_cast<int>(n);
  return true;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: cudaSuccess, or
// cudaErrorInvalidValue above what a block may use.
template <typename Kernel>
inline cudaError_t reserve_smem(Kernel* kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// what a 16-byte cp.async needs of its source
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
