// PTX helpers shared by the staged kernels (tap_conv_fwd.cu's forward,
// tap_conv_bwd.cu's dh and dW, tap_conv_mma.cu's forward and dh): cp.async
// copies into shared memory, named barriers, ldmatrix fragment loads and the
// bf16 mma.sync m16n8k16 with float32 sums. ops/_build.py hashes every
// csrc/*.cuh into each library's name, so an edit here rebuilds every
// library.
//
// Fragment conventions (PTX ISA, mma.m16n8k16 with .bf16): lane l has
// g = l / 4 and q = l % 4. A (16 x 16, row-major) sits in 4 registers of
// packed bf16 pairs: (row g, k 2q..2q+1), (row g + 8, same k), (row g,
// k 8 + 2q..), (row g + 8, k 8 + 2q..). B (16 x 8) in 2: (k 2q..2q+1, n g),
// (k 8 + 2q.., n g). The float32 accumulators: (row g, n 2q..2q+1) and
// (row g + 8, n 2q..2q+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes (one float): for rows whose channels are not a multiple of 4
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 16 bytes from src, or 16 zero bytes when !in (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N commit groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the `threads` threads of a group of warps meet at named barrier group + 1
// (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_barrier(int group, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(threads) : "memory");
}

// Four 8x8 bf16 matrices: lane l names row l % 8 of matrix l / 8 and
// receives r[j] = the pair (row l / 4, columns 2 * (l % 4) + {0, 1}) of
// matrix j, low half first.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldmatrix_x4 for two matrices, named by lanes 0-15.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Four 8x8 bf16 matrices, transposed: lane l names row l % 8 of matrix l / 8
// and receives r[j] = the pair (row 2 * (l % 4) + {0, 1}, column l / 4) of
// matrix j, low half first.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldmatrix_x4_trans for two matrices, named by lanes 0-15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += A B: m16n8k16, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
