// A band of DP slots held by one warp, K contiguous slots a lane: lane l
// holds slots l K .. l K + K - 1 in registers.  A cell that reads a
// neighbouring slot of the previous step needs at most one value from the
// next or the previous lane, one shuffle, and no barrier.  nw_diag.cu's warp
// plan uses these; the row-layout NW computes the same function and can take
// the same mapping.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace cga {

// the first slot this lane holds
template <int K>
__device__ __forceinline__ int lane_slot0() {
  return (int)(threadIdx.x & 31) * K;
}

// slot l K + K of the previous step (the next lane's first), `edge` on the
// last lane
template <int K>
__device__ __forceinline__ int from_next_lane(const int (&v)[K], int edge) {
  const int x = __shfl_down_sync(kFull, v[0], 1);
  return (threadIdx.x & 31) == 31 ? edge : x;
}

// slot l K - 1 of the previous step (the previous lane's last), `edge` on
// lane 0
template <int K>
__device__ __forceinline__ int from_prev_lane(const int (&v)[K], int edge) {
  const int x = __shfl_up_sync(kFull, v[K - 1], 1);
  return (threadIdx.x & 31) == 0 ? edge : x;
}

// the lane's K bytes as one word: byte k is slot l K + k's
template <int K>
struct LaneBytes {
  using T = typename std::conditional<(K > 4), unsigned long long,
                                      unsigned int>::type;
};

// the lane's K bytes at p: one store where K is a power of two (p aligned
// to K bytes, every slot real), else one a byte, the first n only
template <int K>
__device__ __forceinline__ void store_lane_bytes(uint8_t* p,
                                                 typename LaneBytes<K>::T v,
                                                 int n) {
  if constexpr (K == 8) {
    *reinterpret_cast<unsigned long long*>(p) = v;
  } else if constexpr (K == 4) {
    *reinterpret_cast<unsigned int*>(p) = v;
  } else if constexpr (K == 2) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)v;
  } else if constexpr (K == 1) {
    *p = (uint8_t)v;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < n) p[k] = (uint8_t)(v >> (8 * k));
  }
}

}  // namespace cga
