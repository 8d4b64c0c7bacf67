// Device function of the MSA, shared by poa_msa.cu (one launch per launch of
// windows of the lockstep route, a warp a window) and poa_window.cu (the
// whole POA of a window in one kernel, whose group's first warp runs it).
// The rules are described in poa_msa.cu.
#pragma once

#include <stdint.h>

#include "poa_group.cuh"

namespace cga {

// a window's record in the split build (CGA_MSA_SPLIT): cycles of the
// gathers, the column chain, the max and the rows; the ranks walked, the
// ranks that gave a clique its column, the gathers
constexpr int kMsaSplitSlots = 8;

// int32 a rank takes in the rank lists: its members and the ids of their
// pred slots, at most (A + 1) (P + 1)
__host__ __device__ inline int msa_rank_ints(int P, int A) {
  return (A + 1) * (P + 1);
}

// ranks a gather lists, a lane each: 32, or as many as 8,192 ints hold
// (at least one)
__host__ __device__ inline int msa_gather_ranks(int P, int A) {
  const int r = 8192 / msa_rank_ints(P, A);
  return r < 1 ? 1 : (r > 32 ? 32 : r);
}

// int32 of a window's rank lists
__host__ __device__ inline int msa_list_ints(int P, int A) {
  return msa_gather_ranks(P, A) * msa_rank_ints(P, A);
}

// MSA of one window by one warp (lane 0-31).  order, npred, nalig, base (N),
// pred (N * P), alig (N * A) are the final graph and paths (S, L) its
// sequences' node ids, in device memory; col (N) and list
// (msa_list_ints(P, A)) are the window's tables, in shared or device
// memory.  Writes rows (S, N) and *n_cols_out.  In the split build
// (CGA_MSA_SPLIT) lane 0 writes the window's record into `split` where it
// is given.
__device__ inline void msa_warp(const int32_t* order, const int32_t* npred,
                                const int32_t* nalig, const int32_t* base,
                                const int32_t* pred, const int32_t* alig,
                                const int32_t* paths, int nc, int32_t* rows,
                                int32_t* n_cols_out, int N, int P, int A,
                                int S, int L, int32_t* col, int32_t* list,
                                int lane, long long* split = nullptr) {
  const int nce = min(max(nc, 0), N);
  const int stride = msa_rank_ints(P, A);
  const int R = msa_gather_ranks(P, A);
#ifdef CGA_MSA_SPLIT
  const long long t0 = clock64();
  long long c_gather = 0, c_chain = 0;
  int n_done = 0, n_gathers = 0;
#endif
  for (int u = lane; u < N; u += 32) col[u] = -1;
  __syncwarp();
#ifdef CGA_MSA_SPLIT
  c_gather = clock64() - t0;  // the columns' fill counts as a gather's
#endif

  // columns.  A rank's member and pred ids depend on no column, so the
  // warp gathers them for R ranks at a time, a lane a rank, each into its
  // stride of the list: its members in [0, N) as ~id (the rank's node
  // first), then their filled pred slots' ids in [0, N).  The chain over
  // those ranks then reads only the list and the columns.
  for (int r0 = 0; r0 < nce; r0 += R) {
#ifdef CGA_MSA_SPLIT
    const long long tg = clock64();
    ++n_gathers;
#endif
    const int r = r0 + lane;
    int cnt = 0;
    if (lane < R && r < nce) {
      const int u = min(max(order[r], 0), N - 1);
      const int nal = min(nalig[u], A);
      const int32_t* al = alig + (size_t)u * A;
      int32_t* out = list + lane * stride;
      for (int mi = 0; mi == 0 || mi - 1 < nal; ++mi) {
        const int m = mi == 0 ? u : al[mi - 1];
        if (m >= 0 && m < N) out[cnt++] = ~m;
      }
      const int nm = cnt;
      for (int i = 0; i < nm; ++i) {
        const int m = ~out[i];
        const int32_t* pr = pred + (size_t)m * P;
        const int k = min(npred[m], P);
        for (int p = 0; p < k; ++p)
          if (pr[p] >= 0 && pr[p] < N) out[cnt++] = pr[p];
      }
    }
    __syncwarp();
#ifdef CGA_MSA_SPLIT
    const long long tc = clock64();
    c_gather += tc - tg;
#endif
    // the chain: a rank whose node has no column yet gives its clique
    // 1 + the largest column of the clique's preds (-1 where none has
    // one), even where a pred of another member has none yet (the
    // reference's rule).  Entry 0 is the rank's node, so its lane's
    // column is the skip test.
    const int nr = min(R, nce - r0);
    for (int j = 0; j < nr; ++j) {
      const int cj = __shfl_sync(kFull, cnt, j);
      const int32_t* lj = list + j * stride;
      const int v = lane < cj ? lj[lane] : INT_MAX;  // INT_MAX: no entry
      const int cv = v == INT_MAX ? -1 : col[v < 0 ? ~v : v];
      if (__any_sync(kFull, lane == 0 && cv >= 0)) continue;
      int c = (v >= 0 && v != INT_MAX) ? cv : -1;
      for (int i = lane + 32; i < cj; i += 32)
        if (lj[i] >= 0) c = max(c, col[lj[i]]);
      c = __reduce_max_sync(kFull, c) + 1;  // every lane has read col
      if (v < 0) col[~v] = c;
      for (int i = lane + 32; i < cj; i += 32)
        if (lj[i] < 0) col[~lj[i]] = c;
      __syncwarp();
#ifdef CGA_MSA_SPLIT
      ++n_done;
#endif
    }
#ifdef CGA_MSA_SPLIT
    c_chain += clock64() - tc;
#endif
  }
#ifdef CGA_MSA_SPLIT
  const long long t2 = clock64();
#endif

  int m = -1;
  for (int u = lane; u < nce; u += 32) m = max(m, col[u]);
  const int maxcol = __reduce_max_sync(kFull, m);
#ifdef CGA_MSA_SPLIT
  const long long t3 = clock64();
#endif

  // rows: the -1 fill of (S, N) in 16-byte stores where the window's rows
  // are aligned to them; then each position's base into its column, 32
  // positions of 8 sequences at a time (their loads in flight together;
  // the 8 land in 8 rows), in position order: of the lanes that land on one
  // cell the last one writes, and a later store overwrites an earlier
  // one, so the later position wins
  const long long SN = (long long)S * N;
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(rows) & 15) == 0) {
    head = SN & ~3LL;
    int4* r4 = reinterpret_cast<int4*>(rows);
    for (long long i = lane; i < head / 4; i += 32)
      r4[i] = make_int4(-1, -1, -1, -1);
  }
  for (long long i = head + lane; i < SN; i += 32) rows[i] = -1;
  __syncwarp();
  for (int s0 = 0; s0 < S; s0 += 8) {
    for (int j = lane; j - lane < L; j += 32) {
      int pu[8], pc[8], pb[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        pu[t] = (s0 + t < S && j < L) ? paths[(size_t)(s0 + t) * L + j] : -1;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        pc[t] = (pu[t] >= 0 && pu[t] < N) ? col[pu[t]] : -1;
        pb[t] = (pc[t] >= 0 && pc[t] < N) ? base[pu[t]] : 0;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const bool put = pc[t] >= 0 && pc[t] < N;
        const unsigned same = __match_any_sync(kFull, put ? pc[t] : -1 - lane);
        if (put && lane == 31 - __clz(same))
          rows[(size_t)(s0 + t) * N + pc[t]] = pb[t];
      }
      __syncwarp();
    }
  }
  if (lane == 0) *n_cols_out = maxcol + 1;
#ifdef CGA_MSA_SPLIT
  if (lane == 0 && split != nullptr) {
    split[0] = c_gather;
    split[1] = c_chain;
    split[2] = t3 - t2;
    split[3] = clock64() - t3;
    split[4] = nce;
    split[5] = n_done;
    split[6] = n_gathers;
  }
#else
  (void)split;
#endif
}

}  // namespace cga
