// Sequence-to-graph Needleman-Wunsch and its canonical traceback, one added
// sequence per window.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas2.py::_nwtb_pallas
// (kernel body built by _build_nwtb_kernel); spec poa_ops.graph_nw and
// poa_ops.nw_traceback.  The outputs equal the plain PyTorch version in
// ops/poa_nwtb.py.
//
// The score plane has N + 1 rows (row 0 the virtual source, j * gap; row
// r + 1 the node of rank r) of L + 1 columns.  Row r + 1 takes per column
// the max over its node's pred rows (a masked pred slot counting as NEG),
// then diag / vert and the in-row gap chain in closed form,
// row[j] = j*g + cummax(vals[j] - j*g), an inclusive max-scan; with a band
// only |j - ((r+1)*slen)//(nc+1)| <= band_width/2 is kept.  Only columns
// 0..slen are computed: no column past slen feeds one at or before it, and
// the traceback starts at column slen.  Rows of rank >= node_count read as
// NEG.  Unreachable cells hold NEG = -2^30 and sums on them are plain int32
// arithmetic, never saturated, as in the JAX package; the traceback's
// equality tests (pv + sub == here, pv + g == here) start only from a real
// end cell, and a real cell never equals one derived from NEG.
//
// What bounds it on Hopper.  Per live cell, P pred-slot loads and maxes, a
// compare, two adds and the scan step: integer work far below the card's
// int32 rate.  The plane (395,780 B per window at the correction shape) is
// too large for shared memory, so each row is written to device memory and
// read back by its successors (mostly from L2); each row ends with the
// block's scan barriers.  So a window is bound by its chain of rows
// (node_count dependent steps) and the serial traceback, not by bytes or
// operations; many windows at once fill the card.
//
// Design.  One block per window.  The window's sequence and, by rank, each
// node's base, in-degree and pred-slot rows are staged in shared memory.
// Threads own contiguous runs of at most kMaxChunk columns: each computes
// its run's values, a running max, then a warp shuffle scan and a scan of
// the warp totals give every thread its prefix.  The score plane lives in a
// chunk-sized work buffer the wrapper allocates.  The traceback is warp 0:
// lane p tests pred slot p (diag and vert at once), ballots pick the first
// matching slot, lane 0 writes the path.  A window that is not alive, or
// whose best sink lies outside the band, gets the inert path.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxChunk = 8;  // columns per thread
constexpr unsigned kFull = 0xffffffffu;

// plane row ri (0 = virtual source) at column j; rows past nc are NEG
__device__ __forceinline__ int cell(const int32_t* plane, int ri, int j,
                                    int nc, int L1, int g) {
  if (ri == 0) return j * g;
  if (ri > nc) return cga::kNeg;
  return plane[(size_t)ri * L1 + j];
}

__global__ void poa_nwtb_kernel(
    const int32_t* __restrict__ seq, const int32_t* __restrict__ order,
    const int32_t* __restrict__ rank, const int32_t* __restrict__ npred,
    const int32_t* __restrict__ base, const int32_t* __restrict__ nsucc,
    const int32_t* __restrict__ pred, const int32_t* __restrict__ slens,
    const int32_t* __restrict__ node_counts, const int32_t* __restrict__ alive,
    int32_t* __restrict__ planes, int32_t* __restrict__ pn,
    int32_t* __restrict__ pp, int32_t* __restrict__ k0s,
    int32_t* __restrict__ band_oks, int N, int P, int L, int match,
    int mismatch, int g, int band_width) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* sq = smem;            // the sequence, L
  int32_t* rorder = sq + L;      // node of rank r, N
  int32_t* rbase = rorder + N;   // its base
  int32_t* rnp = rbase + N;      // its in-degree
  int32_t* rprow = rnp + N;      // plane row of each pred slot, N * P
  __shared__ int warp_tot[32];
  __shared__ int s_vmax, s_rend;

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int TL = N + L;
  const int L1 = L + 1;
  int32_t* pnw = pn + (size_t)w * TL;
  int32_t* ppw = pp + (size_t)w * TL;
  for (int i = tid; i < TL; i += nt) {
    pnw[i] = -2;
    ppw[i] = -2;
  }
  if (!alive[w]) {
    if (tid == 0) {
      k0s[w] = TL;
      band_oks[w] = 0;
    }
    return;
  }
  const int nc = node_counts[w];
  const int nce = min(max(nc, 0), N);
  const int slen = slens[w];
  const size_t wn = (size_t)w * N;
  for (int i = tid; i < L; i += nt) sq[i] = seq[(size_t)w * L + i];
  for (int r = tid; r < N; r += nt) {
    const int u = min(max(order[wn + r], 0), N - 1);
    const int k = npred[wn + u];
    rorder[r] = order[wn + r];
    rbase[r] = base[wn + u];
    rnp[r] = k;
    for (int p = 0; p < P; ++p) {
      int row = 0;
      if (p < k) {
        const int q = pred[(wn + u) * P + p];
        row = (q >= 0 && q < N) ? rank[wn + q] + 1 : 0;
      }
      rprow[r * P + p] = min(max(row, 0), N);
    }
  }
  __syncthreads();

  int32_t* plane = planes + (size_t)w * (N + 1) * L1;
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
      int m = k < P ? cga::kNeg : INT_MIN;
      for (int p = 0; p < k && p < P; ++p)
        m = max(m, cell(plane, prow[p], j, nce, L1, g));
      return m;
    };
    int xs[kMaxChunk];
    int run = INT_MIN;
    int pm_prev = c0 >= 1 && c0 < c1 ? pmax(c0 - 1) : 0;
#pragma unroll
    for (int i = 0; i < kMaxChunk; ++i) {
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
        if (band_width > 0 && abs(j - center) > half) v = cga::kNeg;
        run = max(run, v - j * g);
        pm_prev = pm;
      }
      xs[i] = run;
    }
    // block-wide exclusive prefix max of the threads' runs
    int tot = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, tot, o);
      if (lane >= o) tot = max(tot, y);
    }
    if (lane == 31) warp_tot[wid] = tot;
    int pre = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) pre = INT_MIN;
    __syncthreads();
    for (int q = 0; q < wid; ++q) pre = max(pre, warp_tot[q]);
    int32_t* out = plane + (size_t)(r + 1) * L1;
#pragma unroll
    for (int i = 0; i < kMaxChunk; ++i) {
      const int j = c0 + i;
      if (j < c1) {
        int v = max(pre, xs[i]) + j * g;
        if (band_width > 0 && abs(j - center) > half) v = cga::kNeg;
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
    const bool sink =
        r < nc && nsucc[wn + min(max(rorder[r], 0), N - 1)] == 0;
    atomicMax(&s_vmax, sink ? cell(plane, r + 1, slen, nce, L1, g)
                            : cga::kNeg);
  }
  __syncthreads();
  const int vmax = s_vmax;
  for (int r = tid; r < N; r += nt) {
    const bool sink =
        r < nc && nsucc[wn + min(max(rorder[r], 0), N - 1)] == 0;
    if (sink && cell(plane, r + 1, slen, nce, L1, g) == vmax)
      atomicMin(&s_rend, r);
  }
  __syncthreads();
  const bool ok = vmax > cga::kNeg / 2;
  if (tid == 0) band_oks[w] = ok;
  if (!ok || wid != 0) {
    if (tid == 0 && !ok) k0s[w] = TL;
    return;
  }

  // traceback, warp 0: lane p tests pred slot p
  int r = nc > 0 ? (s_rend == INT_MAX ? 0 : s_rend) : -1;
  int j = slen;
  int k = TL;
  while ((r >= 0 || j > 0) && k > 0) {
    const bool real = r >= 0 && r < N;
    const int jc = min(max(j, 0), L);
    const int here = cell(plane, min(r + 1, N), jc, nce, L1, g);
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
               cell(plane, pr, min(max(j - 1, 0), L), nce, L1, g) + sub ==
                   here;
        v_ok = cell(plane, pr, jc, nce, L1, g) + g == here;
      }
      const unsigned bd = __ballot_sync(kFull, d_ok);
      const unsigned bv = __ballot_sync(kFull, v_ok);
      if (!any_d && bd) {
        row_d = __shfl_sync(kFull, prow, __ffs(bd) - 1);
        any_d = true;
      }
      if (!any_v && bv) {
        row_v = __shfl_sync(kFull, prow, __ffs(bv) - 1);
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
  if (lane == 0) k0s[w] = k;
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// seq (W, L), order, rank, npred, base, nsucc (W, N), pred (W, N, P), slen,
// node_count, alive (W,) int32; plane is an int32 work buffer of
// W * (N + 1) * (L + 1); writes pn, pp (W, N + L), k0 and band_ok (W,) int32.
extern "C" int cga_poa_nwtb(const void* seq, const void* order,
                            const void* rank, const void* npred,
                            const void* base, const void* nsucc,
                            const void* pred, const void* slen,
                            const void* node_count, const void* alive,
                            void* plane, void* pn, void* pp, void* k0,
                            void* band_ok, int W, int N, int P, int L,
                            int match, int mismatch, int gap, int band_width,
                            void* stream) {
  // about four columns a thread; a thread takes at most kMaxChunk
  const int want = ((L + 1 + 3) / 4 + 31) / 32 * 32;
  const int threads = want < 32 ? 32 : (want > 1024 ? 1024 : want);
  if ((long long)threads * kMaxChunk < L + 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * (L + 3LL * N + (long long)N * P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_nwtb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  poa_nwtb_kernel<<<W, threads, (size_t)smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(seq), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(rank), static_cast<const int32_t*>(npred),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(nsucc),
      static_cast<const int32_t*>(pred), static_cast<const int32_t*>(slen),
      static_cast<const int32_t*>(node_count),
      static_cast<const int32_t*>(alive), static_cast<int32_t*>(plane),
      static_cast<int32_t*>(pn), static_cast<int32_t*>(pp),
      static_cast<int32_t*>(k0), static_cast<int32_t*>(band_ok), N, P, L,
      match, mismatch, gap, band_width);
  return (int)cudaGetLastError();
}
