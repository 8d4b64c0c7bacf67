// Device function of the heaviest-bundle consensus, shared by
// poa_consensus.cu (one launch per launch of windows of the lockstep route,
// a block a window) and poa_window.cu (the whole POA of a window in one
// kernel, a warp or a block a window).  The rules are described in
// poa_consensus.cu.
#pragma once

#include <climits>

#include "poa_group.cuh"

namespace cga {

// ints of shared scratch consensus_block needs
__host__ __device__ inline long long consensus_scratch_ints(int N, int P,
                                                            int MC) {
  return 6LL * N + (long long)N * P + MC;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);  // int32 arithmetic, as in JAX
}

// Consensus of the group's window (thread tid of nt): npred, base, cov,
// rank (N) and pred, predw (N * P), in shared or device memory; scratch is
// consensus_scratch_ints of shared or device memory.  Writes codes, covs
// (MC) and *length_out.  Every thread of the group calls it.  A block's
// reductions go through shared words and atomics, a warp's through
// shuffles.
template <bool kWarp>
__device__ inline void consensus_group(
    const int32_t* npred, const int32_t* pred, const int32_t* predw,
    const int32_t* base, const int32_t* cov, const int32_t* rank, int nc,
    int32_t* codes, int32_t* covs, int32_t* length_out, int N, int P, int MC,
    int32_t* scratch, int tid, int nt) {
  int32_t* sa = scratch;       // scores read by this sweep
  int32_t* sb = sa + N;     // scores written by this sweep
  int32_t* wmx = sb + N;    // heaviest in-edge weight
  int32_t* ntie = wmx + N;  // tied slots per node
  int32_t* has = ntie + N;  // npred > 0
  int32_t* bp = has + N;    // best_pred
  int32_t* tie = bp + N;    // tied preds (raw ids) in slot order, N * P
  int32_t* buf = tie + N * P;  // the walk back, MC

  for (int u = tid; u < N; u += nt) {
    const bool act = u < nc;
    const int np = npred[u];
    const int k = act ? min(max(np, 0), P) : 0;  // slots in use
    const int32_t* pw = predw + u * P;
    int wm = k < P ? kNeg : INT_MIN;
    for (int p = 0; p < k; ++p) wm = max(wm, pw[p]);
    int n = 0;
    for (int p = 0; p < k; ++p)
      if (pw[p] == wm) tie[u * P + n++] = pred[u * P + p];
    wmx[u] = wm;
    ntie[u] = n;
    has[u] = np > 0;
    sa[u] = (act && np <= 0) ? 0 : kNeg;
  }
  group_sync<kWarp>();

  // the best score among u's tied preds, a masked slot counting as NEG
  auto best_tied = [&](const int32_t* score, int u) {
    int m = ntie[u] < P ? kNeg : INT_MIN;
    for (int t = 0; t < ntie[u]; ++t)
      m = max(m, score[min(max(tie[u * P + t], 0), N - 1)]);
    return m;
  };

  int changed = 1;
  for (int it = 0; changed && it < N + 2; ++it) {
    int local = 0;
    for (int u = tid; u < N; u += nt) {
      int nv = kNeg;
      if (u < nc) nv = has[u] ? wrap_add(wmx[u], best_tied(sa, u)) : 0;
      sb[u] = nv;
      local |= nv != sa[u];
    }
    changed = group_or<kWarp>(local);
    int32_t* t = sa;
    sa = sb;
    sb = t;
  }

  int k;
  if constexpr (kWarp) {
    for (int u = tid; u < N; u += nt) {
      int b = -1;
      if (u < nc && has[u]) {
        const int m = best_tied(sa, u);
        b = pred[u * P];  // no tied slot reaches m: slot 0, as argmax
        for (int t = 0; t < ntie[u]; ++t)
          if (sa[min(max(tie[u * P + t], 0), N - 1)] == m) {
            b = tie[u * P + t];
            break;
          }
      }
      bp[u] = b;
    }
    int m = nc < N ? kNeg : INT_MIN;
    for (int u = tid; u < nc && u < N; u += nt) m = max(m, sa[u]);
    const int smax = __reduce_max_sync(kFull, m);
    int rk = INT_MAX;
    for (int u = tid; u < N; u += nt)
      rk = min(rk, (u < nc && sa[u] == smax) ? rank[u] : 1 << 30);
    const int s_rank = __reduce_min_sync(kFull, rk);
    int e = INT_MAX;
    for (int u = tid; u < N; u += nt)
      if (((u < nc && sa[u] == smax) ? rank[u] : 1 << 30) == s_rank)
        e = min(e, u);
    const int s_end = __reduce_min_sync(kFull, e);
    __syncwarp();  // every bp is written
    k = MC;
    if (tid == 0) {
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
  } else {
    __shared__ int s_max, s_rank, s_end, s_k;
    if (tid == 0) {
      s_max = nc < N ? kNeg : INT_MIN;
      s_rank = INT_MAX;
      s_end = INT_MAX;
    }
    for (int u = tid; u < N; u += nt) {
      int b = -1;
      if (u < nc && has[u]) {
        const int m = best_tied(sa, u);
        b = pred[u * P];  // no tied slot reaches m: slot 0, as argmax
        for (int t = 0; t < ntie[u]; ++t)
          if (sa[min(max(tie[u * P + t], 0), N - 1)] == m) {
            b = tie[u * P + t];
            break;
          }
      }
      bp[u] = b;
    }
    __syncthreads();
    for (int u = tid; u < nc && u < N; u += nt) atomicMax(&s_max, sa[u]);
    __syncthreads();
    const int smax = s_max;
    for (int u = tid; u < N; u += nt)
      atomicMin(&s_rank, (u < nc && sa[u] == smax) ? rank[u] : 1 << 30);
    __syncthreads();
    for (int u = tid; u < N; u += nt)
      if (((u < nc && sa[u] == smax) ? rank[u] : 1 << 30) == s_rank)
        atomicMin(&s_end, u);
    __syncthreads();

    if (tid == 0) {
      int u = nc > 0 ? s_end : -1;
      int k = MC;
      while (u >= 0 && k > 0) {
        buf[k - 1] = u;
        u = u < N ? bp[u] : -1;
        --k;
      }
      s_k = k;
      *length_out = MC - k;
    }
    __syncthreads();
    k = s_k;
  }
  for (int i = tid; i < MC; i += nt) {
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
}

}  // namespace cga
