// Device function of the graph NW and its traceback, shared by poa_nwtb.cu
// (one launch per added sequence of the lockstep route) and poa_window.cu
// (the whole POA of a window in one block).  The rules are described in
// poa_nwtb.cu.
#pragma once

#include <climits>

#include "common.cuh"

namespace cga {

constexpr int kNwMaxChunk = 8;  // columns per thread
constexpr unsigned kFullWarp = 0xffffffffu;

// ints of shared scratch nwtb_block needs
__host__ __device__ inline long long nwtb_scratch_ints(int N, int P, int L) {
  return L + 3LL * N + (long long)N * P;
}

// threads of a block: about four columns a thread, at most kNwMaxChunk;
// 0 when L is too long for 1,024 threads
__host__ inline int nwtb_threads(int L) {
  const int want = ((L + 1 + 3) / 4 + 31) / 32 * 32;
  const int threads = want < 32 ? 32 : (want > 1024 ? 1024 : want);
  return (long long)threads * kNwMaxChunk < L + 1 ? 0 : threads;
}

// plane row ri (0 = virtual source) at column j; rows past nc are NEG
__device__ __forceinline__ int nw_cell(const int32_t* plane, int ri, int j,
                                       int nc, int L1, int g) {
  if (ri == 0) return j * g;
  if (ri > nc) return kNeg;
  return plane[(size_t)ri * L1 + j];
}

// Graph NW and traceback of one sequence against the block's window, which
// is alive.  seq (L) is the sequence in device memory; order, rank, npred,
// base, nsucc (N) and pred (N * P) are the window's graph, in shared or
// device memory; plane is the window's (N + 1) * (L + 1) work buffer in
// device memory; scratch is nwtb_scratch_ints of shared memory.  No two of
// the arrays overlap.  Writes the path into pn, pp (N + L each, which the
// caller has filled with -2), and *k0 and *band_ok (visible after the
// caller's next barrier).  Every thread of the block calls it;
// blockDim.x * kNwMaxChunk must reach L + 1.
__device__ inline void nwtb_block(
    const int32_t* __restrict__ seq, const int32_t* __restrict__ order,
    const int32_t* __restrict__ rank, const int32_t* __restrict__ npred,
    const int32_t* __restrict__ base, const int32_t* __restrict__ nsucc,
    const int32_t* __restrict__ pred, int slen, int nc,
    int32_t* __restrict__ plane, int32_t* __restrict__ pnw,
    int32_t* __restrict__ ppw, int N, int P, int L, int match, int mismatch,
    int g, int band_width, int32_t* __restrict__ scratch,
    int32_t* __restrict__ k0_out, int32_t* __restrict__ band_ok_out) {
  int32_t* sq = scratch;         // the sequence, L
  int32_t* rorder = sq + L;      // node of rank r, N
  int32_t* rbase = rorder + N;   // its base
  int32_t* rnp = rbase + N;      // its in-degree
  int32_t* rprow = rnp + N;      // plane row of each pred slot, N * P
  __shared__ int warp_tot[32];
  __shared__ int s_vmax, s_rend;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int TL = N + L;
  const int L1 = L + 1;
  const int nce = min(max(nc, 0), N);
  for (int i = tid; i < L; i += nt) sq[i] = seq[i];
  for (int r = tid; r < N; r += nt) {
    const int u = min(max(order[r], 0), N - 1);
    const int k = npred[u];
    rorder[r] = order[r];
    rbase[r] = base[u];
    rnp[r] = k;
    for (int p = 0; p < P; ++p) {
      int row = 0;
      if (p < k) {
        const int q = pred[u * P + p];
        row = (q >= 0 && q < N) ? rank[q] + 1 : 0;
      }
      rprow[r * P + p] = min(max(row, 0), N);
    }
  }
  __syncthreads();

  const int ncol = slen + 1;
  const int cpt = (ncol + nt - 1) / nt;
  const int c0 = tid * cpt;
  const int c1 = min(c0 + cpt, ncol);
  const int half = band_width / 2;
  for (int r = 0; r < nce; ++r) {
    const int k = rnp[r];
    const int b = rbase[r];
    const int32_t* prow = rprow + r * P;
    const int center =
        band_width > 0 ? (int)(((long long)(r + 1) * slen) / (nc + 1)) : 0;
    // the max over the pred rows at column j (the virtual row for a source)
    auto pmax = [&](int j) {
      if (k == 0) return j * g;
      int m = k < P ? kNeg : INT_MIN;
      for (int p = 0; p < k && p < P; ++p)
        m = max(m, nw_cell(plane, prow[p], j, nce, L1, g));
      return m;
    };
    int xs[kNwMaxChunk];
    int run = INT_MIN;
    int pm_prev = c0 >= 1 && c0 < c1 ? pmax(c0 - 1) : 0;
#pragma unroll
    for (int i = 0; i < kNwMaxChunk; ++i) {
      const int j = c0 + i;
      if (j < c1) {
        const int pm = pmax(j);
        int v;
        if (j == 0) {
          v = pm + g;
        } else {
          const int sc = sq[j - 1];
          const int sub = (sc == b && sc >= 0) ? match : mismatch;
          v = max(pm_prev + sub, pm + g);
        }
        if (band_width > 0 && abs(j - center) > half) v = kNeg;
        run = max(run, v - j * g);
        pm_prev = pm;
      }
      xs[i] = run;
    }
    // block-wide exclusive prefix max of the threads' runs
    int tot = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullWarp, tot, o);
      if (lane >= o) tot = max(tot, y);
    }
    if (lane == 31) warp_tot[wid] = tot;
    int pre = __shfl_up_sync(kFullWarp, tot, 1);
    if (lane == 0) pre = INT_MIN;
    __syncthreads();
    for (int q = 0; q < wid; ++q) pre = max(pre, warp_tot[q]);
    int32_t* out = plane + (size_t)(r + 1) * L1;
#pragma unroll
    for (int i = 0; i < kNwMaxChunk; ++i) {
      const int j = c0 + i;
      if (j < c1) {
        int v = max(pre, xs[i]) + j * g;
        if (band_width > 0 && abs(j - center) > half) v = kNeg;
        out[j] = v;
      }
    }
    __syncthreads();  // the row is complete; warp_tot may be reused
  }

  // end cell: the best sink at column slen, ties to the smallest rank
  if (tid == 0) {
    s_vmax = INT_MIN;
    s_rend = INT_MAX;
  }
  __syncthreads();
  for (int r = tid; r < N; r += nt) {
    const bool sink = r < nc && nsucc[min(max(rorder[r], 0), N - 1)] == 0;
    atomicMax(&s_vmax,
              sink ? nw_cell(plane, r + 1, slen, nce, L1, g) : kNeg);
  }
  __syncthreads();
  const int vmax = s_vmax;
  for (int r = tid; r < N; r += nt) {
    const bool sink = r < nc && nsucc[min(max(rorder[r], 0), N - 1)] == 0;
    if (sink && nw_cell(plane, r + 1, slen, nce, L1, g) == vmax)
      atomicMin(&s_rend, r);
  }
  __syncthreads();
  const bool ok = vmax > kNeg / 2;
  if (tid == 0) *band_ok_out = ok;
  if (!ok || wid != 0) {
    if (tid == 0 && !ok) *k0_out = TL;
    return;
  }

  // traceback, warp 0: lane p tests pred slot p
  int r = nc > 0 ? (s_rend == INT_MAX ? 0 : s_rend) : -1;
  int j = slen;
  int k = TL;
  while ((r >= 0 || j > 0) && k > 0) {
    const bool real = r >= 0 && r < N;
    const int jc = min(max(j, 0), L);
    const int here = nw_cell(plane, min(r + 1, N), jc, nce, L1, g);
    const int sc = (j >= 1 && j <= L) ? sq[j - 1] : -1;
    const int u = real ? rorder[r] : -1;
    const int bu = real ? rbase[r] : -2;
    const int sub = (sc == bu && sc >= 0) ? match : mismatch;
    const int nslots = real ? rnp[r] : 0;
    bool any_d = false, any_v = false;
    int row_d = 0, row_v = 0;
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int p = p0 + lane;
      bool slot = p < P && p < nslots;
      int prow = slot ? rprow[r * P + p] : -1;
      if (p == 0 && nslots == 0) {  // a source: the virtual row
        prow = 0;
        slot = true;
      }
      bool d_ok = false, v_ok = false;
      if (slot) {
        const int pr = min(max(prow, 0), N);
        d_ok = j > 0 &&
               nw_cell(plane, pr, min(max(j - 1, 0), L), nce, L1, g) + sub ==
                   here;
        v_ok = nw_cell(plane, pr, jc, nce, L1, g) + g == here;
      }
      const unsigned bd = __ballot_sync(kFullWarp, d_ok);
      const unsigned bv = __ballot_sync(kFullWarp, v_ok);
      if (!any_d && bd) {
        row_d = __shfl_sync(kFullWarp, prow, __ffs(bd) - 1);
        any_d = true;
      }
      if (!any_v && bv) {
        row_v = __shfl_sync(kFullWarp, prow, __ffs(bv) - 1);
        any_v = true;
      }
    }
    // priority: virtual row, diag, vert, horizontal
    const int move = r < 0 ? 3 : any_d ? 0 : any_v ? 1 : 3;
    --k;
    if (lane == 0) {
      pnw[k] = move == 3 ? -1 : u;
      ppw[k] = move == 1 ? -1 : j - 1;
    }
    if (move == 0) {
      r = row_d - 1;
      --j;
    } else if (move == 1) {
      r = row_v - 1;
    } else {
      --j;
    }
  }
  if (lane == 0) *k0_out = k;
}

}  // namespace cga
