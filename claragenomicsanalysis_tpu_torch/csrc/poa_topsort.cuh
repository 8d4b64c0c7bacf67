// Device functions of the topological sort, shared by poa_topsort.cu (one
// launch per step of the lockstep route, a block a window) and poa_window.cu
// (the whole POA of a window in one kernel, a warp or a block a window).
// The rules are described in poa_topsort.cu.  Each function runs on a
// window's group (poa_group.cuh): thread gt of gn.
#pragma once

#include "poa_group.cuh"

namespace cga {

// Jacobi sweeps over the group's window.  `la` holds the starting levels
// (max(level, 0) on active nodes, 0 on the others), complete and visible to
// the group; `lb` is a second buffer of N.  npred (N) and pred (N * P) may
// lie in shared or device memory.  Returns the buffer that holds the final
// levels; *changed is 0 when the last sweep changed nothing.  Every thread
// of the group calls it.  An inactive node's level never changes, so it is
// copied into lb once and the sweeps visit the active nodes only.
template <bool kWarp>
__device__ inline int32_t* topsort_levels(int32_t* la, int32_t* lb,
                                          const int32_t* npred,
                                          const int32_t* pred, int nc, int N,
                                          int P, int* changed_out, int tid,
                                          int nt) {
  const int nce = min(max(nc, 0), N);
  for (int u = nce + tid; u < N; u += nt) lb[u] = la[u];
  int changed = 1;
  for (int it = 0; changed && it < N + 2; ++it) {
    int local = 0;
    for (int u = tid; u < nce; u += nt) {
      const int v = la[u];
      int m = -1;  // an empty slot reads -1
      const int k = min(npred[u], P);
      for (int p = 0; p < k; ++p) {
        const int q = pred[u * P + p];
        m = max(m, (q >= 0 && q < N) ? la[q] : -1);
      }
      const int nv = max(m + 1, 0);
      lb[u] = nv;
      local |= nv != v;
    }
    changed = group_or<kWarp>(local);
    int32_t* t = la;
    la = lb;
    lb = t;
  }
  *changed_out = changed;
  return la;
}

// Order and rank from the final levels `lv` (N, visible to the group):
// an inactive node keeps its id as rank, an active one takes the count of
// active keys level * N + id below its own.  Writes level_out, order and
// rank (N each; the caller makes them visible before they are read).
__device__ inline void topsort_place(const int32_t* lv, int nc, int N,
                                     int32_t* level_out, int32_t* order,
                                     int32_t* rank, int tid, int nt) {
  const int nce = min(max(nc, 0), N);
  for (int u = tid; u < N; u += nt) {
    level_out[u] = lv[u];
    int r = u;  // inactive nodes keep id order after all active ones
    if (u < nce) {
      const int ku = (int)((unsigned)lv[u] * (unsigned)N + (unsigned)u);
      r = 0;
      for (int v = 0; v < nce; ++v)
        r += (int)((unsigned)lv[v] * (unsigned)N + (unsigned)v) < ku;
    }
    rank[u] = r;
    order[r] = u;
  }
}

}  // namespace cga
