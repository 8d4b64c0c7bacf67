// The group that runs one window in the POA kernels: a warp (kWarp, several
// windows a block) or the whole block (one window).  A warp's window syncs
// with __syncwarp and votes with __any_sync only, so the windows of one block
// never wait for each other: each leaves its loops at its own step.
#pragma once

#include <climits>

#include "common.cuh"

namespace cga {

template <bool kWarp>
__device__ __forceinline__ void group_sync() {
  if constexpr (kWarp)
    __syncwarp();
  else
    __syncthreads();
}

// a barrier that also tells every thread whether any thread's v was non-zero
template <bool kWarp>
__device__ __forceinline__ int group_or(int v) {
  if constexpr (kWarp) {
    __syncwarp();
    return __any_sync(kFull, v);
  } else {
    return __syncthreads_or(v);
  }
}

}  // namespace cga
