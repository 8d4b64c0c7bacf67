// Device function of the MSA, shared by poa_msa.cu (one launch per launch of
// windows of the lockstep route, a block a window) and poa_window.cu (the
// whole POA of a window in one kernel, a warp or a block a window).  The
// rules are described in poa_msa.cu.
#pragma once

#include "poa_group.cuh"

namespace cga {

// MSA of the group's window (thread tid of nt).  order, npred, nalig, base
// (N), pred (N * P) and alig (N * A) are the final graph, in shared or
// device memory; paths is (S, L) in device memory; col is N ints of shared
// or device scratch.  Writes rows (S, N) and *n_cols_out.  Every thread of
// the group calls it.
template <bool kWarp>
__device__ inline void msa_group(const int32_t* order, const int32_t* npred,
                                 const int32_t* nalig, const int32_t* base,
                                 const int32_t* pred, const int32_t* alig,
                                 const int32_t* paths, int nc, int32_t* rows,
                                 int32_t* n_cols_out, int N, int P, int A,
                                 int S, int L, int32_t* col, int tid,
                                 int nt) {
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nwarps = nt >> 5;
  const int nce = min(max(nc, 0), N);

  for (int u = tid; u < N; u += nt) col[u] = -1;
  for (int i = tid; i < S * N; i += nt) rows[i] = -1;
  group_sync<kWarp>();

  // columns, warp 0: the nodes in rank order; a lane per (member, pred slot)
  if (wid == 0) {
    const int pairs = (A + 1) * P;
    for (int r = 0; r < nce; ++r) {
      const int u = min(max(order[r], 0), N - 1);
      if (col[u] >= 0) continue;  // its clique gave it a column already
      const int nal = nalig[u];
      int c = -1;
      for (int i = lane; i < pairs; i += 32) {
        const int mi = i / P;
        const int p = i - mi * P;
        const int mem = mi == 0 ? u : (mi - 1 < nal ? alig[u * A + mi - 1] : -1);
        if (mem >= 0 && mem < N && p < npred[mem]) {
          const int q = pred[mem * P + p];
          if (q >= 0 && q < N) c = max(c, col[q]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        c = max(c, __shfl_xor_sync(kFull, c, o));
      c += 1;
      __syncwarp();  // every lane has read col before any lane writes it
      for (int mi = lane; mi <= A; mi += 32) {
        const int mem = mi == 0 ? u : (mi - 1 < nal ? alig[u * A + mi - 1] : -1);
        if (mem >= 0 && mem < N) col[mem] = c;
      }
      __syncwarp();
    }
  }
  group_sync<kWarp>();

  int m = -1;
  for (int u = tid; u < nce; u += nt) m = max(m, col[u]);
  int maxcol;
  if constexpr (kWarp) {
    maxcol = __reduce_max_sync(kFull, m);
  } else {
    __shared__ int s_maxcol;
    if (tid == 0) s_maxcol = -1;
    __syncthreads();
    atomicMax(&s_maxcol, m);
    __syncthreads();
    maxcol = s_maxcol;
  }

  // rows, a warp per sequence, 32 positions at a time in position order;
  // of the lanes that land on one column the last one writes, and a later
  // chunk overwrites an earlier one, so the later position wins
  for (int s = wid; s < S; s += nwarps) {
    const int32_t* path = paths + (size_t)s * L;
    int32_t* row = rows + (size_t)s * N;
    for (int j0 = 0; j0 < L; j0 += 32) {
      const int j = j0 + lane;
      const int u = j < L ? path[j] : -1;
      int c = -1;
      if (u >= 0 && u < N) c = col[u];
      const bool put = c >= 0 && c < N;
      const unsigned same = __match_any_sync(kFull, put ? c : N + lane);
      if (put && lane == 31 - __clz(same)) row[c] = base[u];
      __syncwarp();
    }
  }
  if (tid == 0) *n_cols_out = maxcol + 1;
}

}  // namespace cga
