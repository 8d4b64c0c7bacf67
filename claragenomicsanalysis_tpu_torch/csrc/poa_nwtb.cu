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

#include "poa_nwtb.cuh"

namespace {

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
  const int w = blockIdx.x;
  const int TL = N + L;
  int32_t* pnw = pn + (size_t)w * TL;
  int32_t* ppw = pp + (size_t)w * TL;
  for (int i = threadIdx.x; i < TL; i += blockDim.x) {
    pnw[i] = -2;
    ppw[i] = -2;
  }
  if (!alive[w]) {
    if (threadIdx.x == 0) {
      k0s[w] = TL;
      band_oks[w] = 0;
    }
    return;
  }
  const size_t wn = (size_t)w * N;
  cga::nwtb_block(seq + (size_t)w * L, order + wn, rank + wn, npred + wn,
                  base + wn, nsucc + wn, pred + wn * P, slens[w],
                  node_counts[w], planes + (size_t)w * (N + 1) * (L + 1), pnw,
                  ppw, N, P, L, match, mismatch, g, band_width, smem, k0s + w,
                  band_oks + w);
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
  const int threads = cga::nwtb_threads(L);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * cga::nwtb_scratch_ints(N, P, L);
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
