// Hopper's own parts (sm_90a), as inline PTX beside mma_ptx.cuh's
// mma.sync / ldmatrix / cp.async helpers: mbarriers, TMA tensor loads, the
// wgmma shared-memory matrix descriptor, wgmma.mma_async with A from
// registers and its fences, and the thread-block cluster's barrier and
// distributed shared memory. tap_conv_bwd.cu's band dW kernel is built from
// them. ops/_build.py hashes every csrc/*.cuh into each library's name.
//
// The 64-byte swizzle. A TMA load with CU_TENSOR_MAP_SWIZZLE_64B, and a
// wgmma descriptor of layout type 2, place the 16-byte chunk c of a 64-byte
// row at chunk c ^ ((address >> 7) & 3): bits 4-5 of the shared-memory
// address take an XOR with bits 7-8 (CUTLASS's Swizzle<2,4,3>), a pattern
// that repeats every 512 bytes. A buffer that starts on 1,024 bytes and
// holds dense 64-byte rows therefore holds row r's chunk c at byte
// 64 r + 16 (c ^ ((r >> 1) & 3)) (swizzle64). Eight consecutive rows of one
// logical chunk, the rows of an ldmatrix matrix, then fall in the eight
// distinct 16-byte bank groups of a 128-byte line, wherever the eight start.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing links against libcuda
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_ptx.cuh"

// byte offset of chunk c (16 bytes) of row r in a 1,024-byte-aligned
// buffer of 64-byte rows that TMA wrote with the 64-byte swizzle
__host__ __device__ constexpr uint32_t swizzle64(uint32_t r, uint32_t c) {
  return 64u * r + 16u * (c ^ ((r >> 1) & 3u));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and the cluster
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// arrive, and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that has
// not ended after 2^33 clocks (seconds) traps: a launch that cannot finish
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  long long start = -1;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > (1ll << 33)) {
      __trap();
    }
  }
}

// --- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box of `map` at coordinates (c0, c1, c2), innermost first, into dst;
// elements outside the tensor arrive as zeros. Completion adds the box's
// bytes to the transactions of `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------

// The shared-memory matrix descriptor of an operand that TMA wrote with the
// 64-byte swizzle (layout type 2), MN-major: rows of 64 bytes along the
// contraction, 8-row groups `sbo` bytes apart. Its 64 bytes span the
// operand's whole N = 32, so the leading offset (between 64-byte atoms
// along N) is never used. `start` lies on 512 bytes (base offset 0).
__device__ __forceinline__ uint64_t wgmma_desc_sw64(uint32_t start, uint32_t sbo) {
  return static_cast<uint64_t>((start & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator across an asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B on the warpgroup, m64n32k16: bf16 operands, float32 sums. A
// (64 x 16) from registers, each warp its 16 rows in the mma.m16n8k16 A
// layout (mma_ptx.cuh); B (16 x 32) in shared memory through `desc_b`,
// MN-major (imm-trans-b 1). d: each warp's 16 rows, d[4j + e] at row
// g + 8 (e / 2), column 8 j + 2 q + e % 2.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// ldmatrix_x4_trans of mma_ptx.cuh at a shared-memory address
__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// --- warp specialisation -----------------------------------------------------

// the registers a thread of this warpgroup may use, lowered or raised to N
// (within the block's allocation); every warp of the warpgroup runs it
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- thread-block clusters ---------------------------------------------------

// every thread of every block of the cluster meets here; what each wrote to
// its shared memory before is visible to the others after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the address of this block's shared-memory address `addr` in block `rank`
// of the cluster
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
