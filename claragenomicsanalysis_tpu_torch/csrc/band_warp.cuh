// A band of DP slots held by one warp, K contiguous slots a lane: lane l
// holds slots l K .. l K + K - 1 in registers.  A cell that reads a
// neighbouring slot of the previous step needs at most one value from the
// next or the previous lane, one shuffle, and no barrier.  The warp plans of
// nw_diag.cu (a slot a half-band cell of an anti-diagonal) and nw_row.cu (a
// slot a band lane of a query row) use these, and the warp's copy of q and t
// and the codes in flight below.
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

// shared memory of a warp's copy of q and t (ops/nw_diag.py
// nw_diag_stage_bytes): each rounded up to 16 bytes, at least 16; t's copy
// starts at q's rounded length
__host__ __device__ __forceinline__ int stage_len(int L) {
  return L > 16 ? (L + 15) & ~15 : 16;
}

// a code of q (row i, base i - 1) or t (column j, base j - 1) in flight:
// loaded at a clamped index, with whether the index lies in the sequence;
// the two meet only where the code is used, so no load stalls the step it is
// issued in
struct Fetch {
  int raw;
  bool ok;
};

template <bool kStaged>
__device__ __forceinline__ Fetch fetch(const int8_t* s, int pos, int len) {
  Fetch f;
  f.ok = pos >= 1 && pos <= len;
  const int p = max(min(pos - 1, len - 1), 0);
  if constexpr (kStaged)
    f.raw = s[p];
  else
    f.raw = __ldg(s + p);
  return f;
}

// an unknown base (N, code -1) never matches, not even another N: q's
// unknown codes read -1 and t's -2, so a match is one compare
__device__ __forceinline__ int q_code(Fetch f) {
  return f.ok && f.raw >= 0 ? f.raw : -1;
}
__device__ __forceinline__ int t_code(Fetch f) {
  return f.ok && f.raw >= 0 ? f.raw : -2;
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
