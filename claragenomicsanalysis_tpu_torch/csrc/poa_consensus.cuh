// Device function of the heaviest-bundle consensus, shared by
// poa_consensus.cu (one launch per launch of windows of the lockstep route,
// a warp a window) and poa_window.cu (the whole POA of a window in one
// kernel, whose group's first warp runs it).  The rules are described in
// poa_consensus.cu.
#pragma once

#include <climits>

#include "poa_group.cuh"

namespace cga {

// a window's record in the split build (CGA_CONSENSUS_SPLIT): cycles of the
// table pass, the score sweeps, the end node, the walk back and the
// writes; the sweeps run, the Jacobi sweeps among them, the active nodes
constexpr int kConsensusSplitSlots = 8;

// int32 of a window's tables: the scores, a second buffer (the visit
// order, then Jacobi's second score buffer, then the best preds), the
// heaviest in-edge weights, the first tied preds, the tie counts and
// flags, the ranks (N each) and the walk back (MC)
__host__ __device__ inline long long consensus_table_ints(int N, int MC) {
  return 6LL * N + MC;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);  // int32 arithmetic, as in JAX
}

// The best score among u's tied preds (its in-edges of weight wm, the
// heaviest), a masked slot counting as NEG, and into *best (where given)
// the first tied pred reaching it, pred slot 0's where none does (argmax
// over no hit).  n: u's tied slots; first: its first tied pred.  A node
// with one tied slot reads nothing more; one with several reads its pred
// and predw slots where they lie.
__device__ __forceinline__ int tied_max(const int32_t* score,
                                        const int32_t* npred,
                                        const int32_t* pred,
                                        const int32_t* predw, int u, int wm,
                                        int n, int first, int N, int P,
                                        int* best) {
  const int32_t* pr = pred + (size_t)u * P;
  int m = n < P ? kNeg : INT_MIN;
  int b = 0, found = 0;
  if (n == 1) {
    const int s = score[min(max(first, 0), N - 1)];
    m = max(m, s);
    found = s == m;
    b = first;
  } else if (n > 1) {
    const int32_t* pw = predw + (size_t)u * P;
    const int k = min(max(npred[u], 0), P);
    for (int p = 0; p < k; ++p)
      if (pw[p] == wm) m = max(m, score[min(max(pr[p], 0), N - 1)]);
    if (best != nullptr)
      for (int p = 0; p < k && !found; ++p)
        if (pw[p] == wm && score[min(max(pr[p], 0), N - 1)] == m) {
          b = pr[p];
          found = 1;
        }
  }
  if (best != nullptr) *best = found ? b : pr[0];
  return m;
}

// Consensus of one window by one warp (lane 0-31): npred, base, cov, rank
// (N) and pred, predw (N * P) in device memory; T, the window's
// consensus_table_ints(N, MC) ints of shared or device memory.  Writes
// codes, covs (MC) and *length_out.  In the split build
// (CGA_CONSENSUS_SPLIT) lane 0 writes the window's record into `split`
// where it is given.
__device__ inline void consensus_warp(
    const int32_t* npred, const int32_t* pred, const int32_t* predw,
    const int32_t* base, const int32_t* cov, const int32_t* rank, int nc,
    int32_t* codes, int32_t* covs, int32_t* length_out, int N, int P, int MC,
    int32_t* T, int lane, long long* split = nullptr) {
  int32_t* sc = T;          // scores
  int32_t* alt = sc + N;    // visit order; Jacobi's second buffer; best preds
  int32_t* wmx = alt + N;   // heaviest in-edge weight
  int32_t* tie = wmx + N;   // the first tied pred (raw id)
  int32_t* meta = tie + N;  // tied slots << 1 | (npred > 0)
  int32_t* rk = meta + N;   // rank
  int32_t* buf = rk + N;    // the walk back, MC
  const int nce = min(max(nc, 0), N);
#ifdef CGA_CONSENSUS_SPLIT
  const long long t0 = clock64();
  int n_sweeps = 0, n_jacobi = 0;
#endif

  // the table pass, a lane an active node: the heaviest in-edge, its ties
  // and the first tied pred in one pass over the slots, each slot's weight
  // and pred loaded whether it is filled or not, so that no load waits on
  // npred; an inactive node only scores NEG
  for (int u = nce + lane; u < N; u += 32) {
    sc[u] = kNeg;
    alt[u] = -1;
  }
  for (int u = lane; u < nce; u += 32) {
    const int np = npred[u];
    const int k = min(max(np, 0), P);  // slots in use
    const int32_t* pw = predw + (size_t)u * P;
    const int32_t* pr = pred + (size_t)u * P;
    int wm = k < P ? kNeg : INT_MIN;
    int n = 0, first = -1;
#pragma unroll 8
    for (int p = 0; p < P; ++p) {
      const int w = pw[p], q = pr[p];
      if (p < k && w > wm) {
        wm = w;
        n = 1;
        first = q;
      } else if (p < k && w == wm) {
        first = n == 0 ? q : first;
        ++n;
      }
    }
    wmx[u] = wm;
    tie[u] = first;
    meta[u] = n << 1 | (np > 0);
    sc[u] = np <= 0 ? 0 : kNeg;
    rk[u] = rank[u];
    alt[u] = -1;
  }
  __syncwarp();
#ifdef CGA_CONSENSUS_SPLIT
  const long long t1 = clock64();
#endif

  // the visit order, rank's inverse; a hole means rank is not a
  // permutation of the active nodes
  for (int u = lane; u < nce; u += 32) {
    const int r = rk[u];
    if (r >= 0 && r < nce) alt[r] = u;
  }
  __syncwarp();
  int bad = 0;
  for (int i = lane; i < nce; i += 32) bad |= alt[i] < 0;
  bad = __any_sync(kFull, bad);

  // the scores in one pass in rank order, 32 positions at a time, a lane a
  // node: a tied pred earlier in the order is final; one earlier among the
  // same 32 is resolved in position order, one shuffle a position.  A tied
  // pred at or after its node's position (a cycle, or ranks that are not
  // topological) marks the window.
  if (!bad) {
    for (int c0 = 0; c0 < nce; c0 += 32) {
      const int i = c0 + lane;
      const int u = i < nce ? alt[i] : -1;
      int m = 0, wm = 0, hs = 0;
      unsigned mask = 0;  // lanes of this 32 holding a tied pred
      if (u >= 0) {
        const int mt = meta[u];
        const int n = mt >> 1;
        hs = mt & 1;
        wm = wmx[u];
        m = n < P ? kNeg : INT_MIN;
        auto pull = [&](int q) {
          const int qc = min(max(q, 0), N - 1);
          const int vq = qc < nce ? rk[qc] : -1;  // inactive: NEG, final
          if (vq >= c0 && vq < i) {
            mask |= 1u << (vq - c0);
          } else {
            m = max(m, sc[qc]);
            bad |= vq >= i;
          }
        };
        if (hs && n == 1) {
          pull(tie[u]);
        } else if (hs && n > 1) {
          const int32_t* pw = predw + (size_t)u * P;
          const int32_t* pr = pred + (size_t)u * P;
          const int k = min(max(npred[u], 0), P);
          for (int p = 0; p < k; ++p)
            if (pw[p] == wm) pull(pr[p]);
        }
      }
      int val = hs ? wrap_add(wm, m) : 0;
      unsigned todo = __reduce_or_sync(kFull, mask);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int vj = __shfl_sync(kFull, val, j);
        if ((mask >> j) & 1u) {
          m = max(m, vj);
          val = wrap_add(wm, m);
        }
      }
      if (u >= 0) sc[u] = val;
      __syncwarp();
    }
    // the confirming sweep, parallel over the nodes: each score against
    // its rule, and each best pred into alt
    for (int u = lane; u < nce; u += 32) {
      const int mt = meta[u];
      int b = -1;
      if (mt & 1) {
        const int m = tied_max(sc, npred, pred, predw, u, wmx[u], mt >> 1,
                               tie[u], N, P, &b);
        bad |= wrap_add(wmx[u], m) != sc[u];
      }
      alt[u] = b;
    }
    bad = __any_sync(kFull, bad);
#ifdef CGA_CONSENSUS_SPLIT
    n_sweeps = 2;
#endif
  }

  // not confirmed: the Jacobi sweeps from the starting scores decide, as
  // the plain version does (at most N + 2, the inactive nodes NEG in both
  // buffers)
  const int32_t* fin = sc;
  const int32_t* bp = alt;
  if (bad) {
    for (int u = lane; u < N; u += 32) {
      sc[u] = (u < nce && !(meta[u] & 1)) ? 0 : kNeg;
      alt[u] = kNeg;
    }
    __syncwarp();
    int32_t* sa = sc;
    int32_t* sb = alt;
    int changed = 1;
    for (int it = 0; changed && it < N + 2; ++it) {
      int local = 0;
      for (int u = lane; u < nce; u += 32) {
        const int mt = meta[u];
        const int nv =
            (mt & 1) ? wrap_add(wmx[u], tied_max(sa, npred, pred, predw, u,
                                                 wmx[u], mt >> 1, tie[u],
                                                 N, P, nullptr))
                     : 0;
        sb[u] = nv;
        local |= nv != sa[u];
      }
      changed = group_or<true>(local);
      int32_t* t = sa;
      sa = sb;
      sb = t;
#ifdef CGA_CONSENSUS_SPLIT
      ++n_sweeps;
      ++n_jacobi;
#endif
    }
    for (int u = lane; u < N; u += 32) {
      int b = -1;
      if (u < nce && (meta[u] & 1))
        tied_max(sa, npred, pred, predw, u, wmx[u], meta[u] >> 1, tie[u], N,
                 P, &b);
      sb[u] = b;
    }
    __syncwarp();
    fin = sa;
    bp = sb;
  }
#ifdef CGA_CONSENSUS_SPLIT
  const long long t2 = clock64();
#endif

  // the end node: the best score, ties to the smallest rank, then the
  // smallest id (a masked node counting as NEG, a masked rank as 2^30)
  int m = nc < N ? kNeg : INT_MIN;
  for (int u = lane; u < nce; u += 32) m = max(m, fin[u]);
  const int smax = __reduce_max_sync(kFull, m);
  int rmin = INT_MAX;
  for (int u = lane; u < N; u += 32)
    rmin = min(rmin, (u < nce && fin[u] == smax) ? rk[u] : 1 << 30);
  const int s_rank = __reduce_min_sync(kFull, rmin);
  int e = INT_MAX;
  for (int u = lane; u < N; u += 32)
    if (((u < nce && fin[u] == smax) ? rk[u] : 1 << 30) == s_rank)
      e = min(e, u);
  const int s_end = __reduce_min_sync(kFull, e);
#ifdef CGA_CONSENSUS_SPLIT
  const long long t3 = clock64();
#endif

  // the walk back, serial on lane 0, from the end of the buffer
  int k = MC;
  if (lane == 0) {
    int u = nc > 0 ? s_end : -1;
    while (u >= 0 && k > 0) {
      buf[k - 1] = u;
      u = u < N ? bp[u] : -1;
      --k;
    }
    *length_out = MC - k;
  }
  k = __shfl_sync(kFull, k, 0);
  __syncwarp();  // buf is written
#ifdef CGA_CONSENSUS_SPLIT
  const long long t4 = clock64();
#endif
#pragma unroll 8
  for (int i = lane; i < MC; i += 32) {
    int c = -1, v = 0;
    if (i < MC - k) {
      const int node = buf[i + k];
      if (node >= 0 && node < N) {
        c = base[node];
        v = cov[node];
      }
    }
    codes[i] = c;
    covs[i] = v;
  }
#ifdef CGA_CONSENSUS_SPLIT
  if (lane == 0 && split != nullptr) {
    split[0] = t1 - t0;
    split[1] = t2 - t1;
    split[2] = t3 - t2;
    split[3] = t4 - t3;
    split[4] = clock64() - t4;
    split[5] = n_sweeps;
    split[6] = n_jacobi;
    split[7] = nce;
  }
#else
  (void)split;
#endif
}

}  // namespace cga
