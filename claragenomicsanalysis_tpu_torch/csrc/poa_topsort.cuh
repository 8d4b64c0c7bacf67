// Device functions of the topological sort, shared by poa_topsort.cu (one
// launch per step of the lockstep route, a warp a window) and poa_window.cu
// (the whole POA of a window in one kernel, a warp or a block a window,
// whose first warp runs the sort).  The rules are described in
// poa_topsort.cu.
#pragma once

#include "poa_group.cuh"

namespace cga {

// a window's record in the split build (CGA_TOPSORT_SPLIT): sweeps run,
// cycles of the visit order, of the sweeps and of the rank, Jacobi sweeps,
// active nodes, ordered sweeps
constexpr int kTopsortSplitSlots = 8;

// ordered sweeps (each checked by a confirming sweep) before a window runs
// the Jacobi sweeps from its starting levels
constexpr int kOrderedSweeps = 3;

// int32 of a window's tables: the levels and a second level buffer, each
// active node's visit position and the node at each visit position (N
// each), and a histogram of N + 2 bins
__host__ __device__ inline long long topsort_table_ints(int N) {
  return 5LL * N + 2;
}

// Jacobi sweeps over a warp's window (lane tid of nt = 32).  `la` holds the
// starting levels (max(level, 0) on active nodes, 0 on the others),
// complete and visible to the warp; `lb` is a second buffer of N.  npred
// (N) and pred (N * P) may lie in shared or device memory.  Returns the
// buffer that holds the final levels; *changed is 0 when the last sweep
// changed nothing; *sweeps counts the sweeps run.  An inactive node's level
// never changes, so it is copied into lb once and the sweeps visit the
// active nodes only.
__device__ inline int32_t* topsort_levels(int32_t* la, int32_t* lb,
                                          const int32_t* npred,
                                          const int32_t* pred, int nc, int N,
                                          int P, int* changed_out,
                                          int* sweeps, int tid, int nt) {
  const int nce = min(max(nc, 0), N);
  for (int u = nce + tid; u < N; u += nt) lb[u] = la[u];
  int changed = 1;
  int it = 0;
  for (; changed && it < N + 2; ++it) {
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
    changed = group_or<true>(local);
    int32_t* t = la;
    la = lb;
    lb = t;
  }
  *changed_out = changed;
  *sweeps += it;
  return la;
}

// Order and rank from the final levels `lv` (N, visible to the group) by a
// count: an inactive node keeps its id as rank, an active one takes the
// count of active keys level * N + id below its own.  The rule of a window
// whose levels did not converge (a cycle), whose levels have no bound.
// Writes level_out, order and rank (N each; the caller makes them visible
// before they are read).
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

// ------------------------------------------------ a warp's sort of a window

// exclusive prefix sum of a[0, n) in place, 32 at a time; returns the total
__device__ inline int warp_exclusive_sum(int32_t* a, int n, int lane) {
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int i = c0 + lane;
    const int v = i < n ? a[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (i < n) a[i] = carry + x - v;
    carry += __shfl_sync(kFull, x, 31);
  }
  __syncwarp();
  return carry;
}

// A stable counting sort of the ids u in [0, n) with `take(u)` by
// `bin(u)` in [0, bins): the histogram `hist` (bins ints) counted, its
// exclusive sum, then each taken id placed in id order, 32 at a time (the
// peers of one bin found by __match_any_sync, each after its lower peers);
// place(u, position) receives each position.
template <typename Take, typename Bin, typename Place>
__device__ inline void warp_counting_sort(int32_t* hist, int n, int bins,
                                          Take take, Bin bin, Place place,
                                          int lane) {
  for (int b = lane; b < bins; b += 32) hist[b] = 0;
  __syncwarp();
  for (int u = lane; u < n; u += 32)
    if (take(u)) atomicAdd(hist + bin(u), 1);
  __syncwarp();
  warp_exclusive_sum(hist, bins, lane);
  const unsigned below = (1u << lane) - 1;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int u = c0 + lane;
    const bool on = u < n && take(u);
    const int key = on ? bin(u) : -1 - lane;  // an idle lane has no peer
    const unsigned peers = __match_any_sync(kFull, key);
    const int base = on ? hist[key] : 0;
    __syncwarp();
    if (on) {
      place(u, base + __popc(peers & below));
      if (lane == 31 - __clz(peers)) hist[key] = base + __popc(peers);
    }
    __syncwarp();
  }
}

// The pull rule of one node against the levels lv: max over its filled
// pred slots of the pred's level + 1 (an empty or out-of-range slot reads
// -1), at least 0.
__device__ __forceinline__ int pulled_level(const int32_t* lv,
                                            const int32_t* npred,
                                            const int32_t* pred, int u,
                                            int N, int P) {
  int m = -1;
  const int k = min(npred[u], P);
  for (int p = 0; p < k; ++p) {
    const int q = pred[u * P + p];
    m = max(m, (q >= 0 && q < N) ? lv[q] : -1);
  }
  return max(m + 1, 0);
}

// One window's levels, order and rank, by the group's first warp (lane =
// its thread, 0-31).  level_in (N): the starting levels, read where they
// lie; nc: the node count; nc_pre: the node count of the graph level_in
// was computed for (the old nodes are u < nc_pre; a value past nc counts
// as nc).  T: the window's topsort_table_ints(N) ints of scratch.  Writes
// level_out, order and rank (N each) and returns ok (the levels
// converged).  The caller syncs the group afterwards.  In the split build
// (CGA_TOPSORT_SPLIT) lane 0 writes the window's record into `split` where
// it is given.
__device__ inline int topsort_warp(const int32_t* level_in,
                                   const int32_t* npred, const int32_t* pred,
                                   int nc, int nc_pre, int N, int P,
                                   int32_t* T, int32_t* level_out,
                                   int32_t* order, int32_t* rank, int lane,
                                   long long* split = nullptr) {
  int32_t* lv = T;           // levels
  int32_t* lb = lv + N;      // Jacobi's second buffer; a chain's start
  int32_t* vpos = lb + N;    // visit position of an active node
  int32_t* vis = vpos + N;   // node at a visit position; old ranks' weights
  int32_t* hist = vis + N;   // N + 2 bins
  const int nce = min(max(nc, 0), N);
  const int nold = min(max(nc_pre, 0), nce);
#ifdef CGA_TOPSORT_SPLIT
  const long long t_start = clock64();
#endif
  for (int u = lane; u < N; u += 32)
    lv[u] = u < nce ? max(level_in[u], 0) : 0;
  __syncwarp();

  // the visit order: old nodes by their (level, id), each new node right
  // after its anchor, the old node its chain hangs from, in chain order;
  // new nodes whose chain has no old anchor first, in id order.  1. the old
  // nodes' rank into vpos
  warp_counting_sort(
      hist, nold, nce + 1, [](int) { return true; },
      [&](int u) { return min(lv[u], nce); },
      [&](int u, int r) { vpos[u] = r; }, lane);
  // 2. a new node's chain: the run of ids whose first pred is the id
  // before (the add makes a chain's nodes in path order); its start into
  // lb, a weight of 1 + its chain's nodes for each old node by rank
  for (int r = lane; r < nold; r += 32) vis[r] = 1;
  __syncwarp();
  int carry = -1, roots = 0;
  for (int c0 = nold; c0 < nce; c0 += 32) {
    const int u = c0 + lane;
    const bool on = u < nce;
    const int p0 = on && P > 0 && npred[u] > 0 ? pred[u * P] : -1;
    const bool head = on && !(p0 == u - 1 && u - 1 >= nold);
    int s = head ? u : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s = max(s, y);
    }
    s = max(s, carry);
    carry = __shfl_sync(kFull, s, 31);
    if (on) lb[u] = s;
    const int a0 = on && P > 0 && npred[s] > 0 ? pred[s * P] : -1;
    const bool anchored = on && a0 >= 0 && a0 < nold;
    if (anchored) atomicAdd(vis + vpos[a0], 1);
    const unsigned root = __ballot_sync(kFull, on && !anchored);
    if (on && !anchored) vpos[u] = roots + __popc(root & ((1u << lane) - 1));
    roots += __popc(root);
  }
  __syncwarp();
  // 3. the old nodes' visit positions from the weights' prefix sum, then
  // the new ones' from their anchors'
  warp_exclusive_sum(vis, nold, lane);
  for (int u = lane; u < nold; u += 32) vpos[u] = roots + vis[vpos[u]];
  __syncwarp();
  for (int u = nold + lane; u < nce; u += 32) {
    const int s = lb[u];
    const int a0 = P > 0 && npred[s] > 0 ? pred[s * P] : -1;
    if (a0 >= 0 && a0 < nold) vpos[u] = vpos[a0] + u - s + 1;
  }
  __syncwarp();
  // 4. the node at each position (a wrong hint may leave holes, -1)
  for (int i = lane; i < nce; i += 32) vis[i] = -1;
  __syncwarp();
  for (int u = lane; u < nce; u += 32)
    if (vpos[u] >= 0 && vpos[u] < nce) vis[vpos[u]] = u;
  __syncwarp();
#ifdef CGA_TOPSORT_SPLIT
  const long long t_order = clock64();
  int n_ordered = 0, n_sweeps = 0;
#endif

  // ordered sweeps: 32 positions at a time, a node pulls its preds'
  // levels; a pred earlier in the same 32 is resolved in position order by
  // one shuffle a position, so a visit order that is topological for the
  // graph converges in one sweep.  Then a confirming sweep (parallel over
  // the nodes, nothing written) checks the fixpoint.
  int changed = 1;
  for (int pass = 0; changed && pass < kOrderedSweeps; ++pass) {
    for (int c0 = 0; c0 < nce; c0 += 32) {
      const int i = c0 + lane;
      const int u = i < nce ? vis[i] : -1;
      int m = -1;
      unsigned mask = 0;  // lanes of this 32 holding an earlier pred
      if (u >= 0) {
        const int k = min(npred[u], P);
        for (int p = 0; p < k; ++p) {
          const int q = pred[u * P + p];
          if (q < 0 || q >= N) continue;  // reads -1
          const int vq = q < nce ? vpos[q] : INT_MAX;
          if (vq >= c0 && vq < i)
            mask |= 1u << (vq - c0);
          else
            m = max(m, lv[q]);
        }
      }
      int val = max(m + 1, 0);
      unsigned todo = __reduce_or_sync(kFull, mask);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int vj = __shfl_sync(kFull, val, j);
        if ((mask >> j) & 1u) val = max(val, vj + 1);
      }
      if (u >= 0) lv[u] = val;
      __syncwarp();
    }
    int bad = 0;
    for (int u = lane; u < nce; u += 32)
      bad |= pulled_level(lv, npred, pred, u, N, P) != lv[u];
    changed = __any_sync(kFull, bad);
#ifdef CGA_TOPSORT_SPLIT
    ++n_ordered;
    n_sweeps += 2;
#endif
  }
  // not a fixpoint: a cycle, or a hint that was wrong; the Jacobi sweeps
  // from the starting levels decide, as the plain version does
  const int32_t* fin = lv;
  if (changed) {
    for (int u = lane; u < N; u += 32)
      lv[u] = u < nce ? max(level_in[u], 0) : 0;
    __syncwarp();
    int jacobi = 0;
    fin = topsort_levels(lv, lb, npred, pred, nc, N, P, &changed,
                         &jacobi, lane, 32);
#ifdef CGA_TOPSORT_SPLIT
    n_sweeps += jacobi;
    if (lane == 0 && split != nullptr) split[4] = jacobi;
#endif
  }
#ifdef CGA_TOPSORT_SPLIT
  const long long t_levels = clock64();
#endif

  // the rank: a counting sort on (level, id) of the active nodes (a
  // fixpoint's levels lie in 0..nce); the inactive nodes after them in id
  // order
  for (int u = lane; u < N; u += 32) {
    level_out[u] = fin[u];
    if (u >= nce) {
      rank[u] = u;
      order[u] = u;
    }
  }
  if (changed) {
    topsort_place(fin, nc, N, level_out, order, rank, lane, 32);
  } else {
    warp_counting_sort(
        hist, nce, nce + 1, [](int) { return true; },
        [&](int u) { return fin[u]; },
        [&](int u, int r) {
          rank[u] = r;
          order[r] = u;
        },
        lane);
  }
#ifdef CGA_TOPSORT_SPLIT
  __syncwarp();
  if (lane == 0 && split != nullptr) {
    split[0] = n_sweeps;
    split[1] = t_order - t_start;
    split[2] = t_levels - t_order;
    split[3] = clock64() - t_levels;
    split[5] = nce;
    split[6] = n_ordered;
  }
#else
  (void)split;
#endif
  return !changed;
}

}  // namespace cga
