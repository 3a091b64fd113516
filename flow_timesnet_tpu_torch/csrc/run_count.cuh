// A launch's count of itself, on the card. A CUDA graph's replay runs no
// host code, so the wrappers' host counters never see it: each fold-conv
// kernel adds 1 at `runs` (one int32 cell per kernel, route and kernel size,
// kept by ops/cuda_fold.py; null counts nothing) from the first thread of
// block (0, 0), once for every launch that runs.
#pragma once

__device__ __forceinline__ void count_run(int* runs) {
  if (runs != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    atomicAdd(runs, 1);
  }
}
