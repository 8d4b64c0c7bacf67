// Fold one traceback path per window into its POA graph.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas2.py::_add_pallas
// (kernel body built by _build_add_kernel); spec poa_ops.add_alignment.  The
// outputs equal the plain PyTorch version in ops/poa_add.py.
//
// The walk goes along the path from k0, one step per entry, rule by rule as
// poa_ops.add_alignment: inert and deletion entries change nothing; a
// consumed base lands on the path's node when the bases agree, else on the
// first aligned candidate with that base, else on a new node at
// clip(node_count, 0, N - 1), which joins the clique of the node it sits
// beside (members sorted ascending; the new id appended to each member's
// list, reading the counts after the new node's own is set); coverage grows
// by the base's weight; the edge from the previous consumed node gets
// min(w[prev_pos], w), added to an existing slot or inserted in ascending
// pred order (the whole slot row shifts); overflows set a sticky status,
// node over clique over edge.  The clipped writes of an overflowed window
// still happen, because the consensus reads that state.  Where the state
// carries paths (the MSA is asked for), row s_row of a window with act set
// becomes this sequence's walk: -1 everywhere, then target at
// clip(pos, 0, L - 1) per consumed base.
//
// What bounds it on Hopper.  Each step is a short chain of dependent loads
// and stores into the window's graph (a few hundred bytes touched, a few
// dozen int32 operations), and the steps of a window are serial.  Latency
// of that chain, not bytes or operations, bounds a window; the card's
// throughput comes from many windows walking at once.  The first design
// (lane 0 walking every path entry alone) spent two thirds of a window in
// the edge insert: a serial scan of the pred slots and a shift of every slot
// above the insert point, each a dependent load and store (chip_smoke.py
// --add-split).
//
// Design.  One warp a window, all 32 lanes walking together (poa_add.cuh
// add_walk): the path read 32 entries at a time and a ballot keeping the
// consumed ones; the node choice a clique slot a lane and a ballot; the
// clique list ranked over shuffles, no array indexed at run time (nothing
// in local memory); the pred slots a lane each, found and counted by
// ballots, shifted by a shuffle.  Each step reads what the steps before
// wrote, so a step's time is its rounds of L2 latency: the loads that
// depend on the same value go out together, so a base that lands on its
// node waits on one round (its node's row).  The graph stays in device
// memory: a copy of it in shared memory made a window's walk shorter but
// fitted a few windows an SM at the correction shape, where device memory
// keeps all of a launch's windows in flight at once, and the launch ran
// longer (PERF.md).  The whole warp clears the paths row first.  The state
// is updated in place; the wrapper hands the kernel a copy, which keeps the
// entry point pure.

#include "poa_add.cuh"

namespace {

__global__ void poa_add_kernel(
    const int32_t* __restrict__ pn, const int32_t* __restrict__ pp,
    const int32_t* __restrict__ seq, const int32_t* __restrict__ weights,
    const int32_t* __restrict__ k0s, const int32_t* __restrict__ act,
    int32_t* __restrict__ base, int32_t* __restrict__ cov,
    int32_t* __restrict__ npred, int32_t* __restrict__ pred,
    int32_t* __restrict__ predw, int32_t* __restrict__ nsucc,
    int32_t* __restrict__ nalig, int32_t* __restrict__ alig,
    int32_t* __restrict__ node_count, int32_t* __restrict__ status,
    int32_t* __restrict__ paths, int N, int P, int A, int L, int S, int s_row,
    int max_nodes) {
  const int w = blockIdx.x;
  if (!act[w]) return;
  int32_t* prow = nullptr;
#ifdef CGA_ADD_SPLIT
  const long long t_row = clock64();
#endif
  if (paths != nullptr) {
    prow = paths + ((size_t)w * S + s_row) * L;
    for (int i = threadIdx.x; i < L; i += blockDim.x) prow[i] = -1;
    __syncwarp();
  }
#ifdef CGA_ADD_SPLIT
  if (threadIdx.x == 0)
    cga::g_add_split[(size_t)w * cga::kAddSplitSlots + 4] += clock64() - t_row;
#endif
  const int TL = N + L;
  const size_t wn = (size_t)w * N;
  int nc = node_count[w];
  int st = status[w];
  cga::add_walk(pn + (size_t)w * TL, pp + (size_t)w * TL,
                seq + (size_t)w * L, weights + (size_t)w * L, k0s[w],
                base + wn, cov + wn, npred + wn, nsucc + wn, nalig + wn,
                pred + wn * P, predw + wn * P, alig + wn * A, nc, st, prow, N,
                P, A, L, max_nodes, threadIdx.x);
  if (threadIdx.x == 0) {
    node_count[w] = nc;
    status[w] = st;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// pn, pp (W, N + L), seq, weights (W, L), k0, act (W,) int32; the state
// (base, cov, npred (W, N), pred, predw (W, N, P), nsucc, nalig (W, N),
// alig (W, N, A), node_count, status (W,) int32) is updated in place, and so
// is row s_row of paths (W, S, L) unless paths is null.
extern "C" int cga_poa_add(const void* pn, const void* pp, const void* seq,
                           const void* weights, const void* k0,
                           const void* act, void* base, void* cov,
                           void* npred, void* pred, void* predw, void* nsucc,
                           void* nalig, void* alig, void* node_count,
                           void* status, void* paths, int W, int N, int P,
                           int A, int L, int S, int s_row, int max_nodes,
                           void* stream) {
  if (A + 1 > cga::kAddMaxMembers) return (int)cudaErrorInvalidValue;
  poa_add_kernel<<<W, 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(pn), static_cast<const int32_t*>(pp),
      static_cast<const int32_t*>(seq), static_cast<const int32_t*>(weights),
      static_cast<const int32_t*>(k0), static_cast<const int32_t*>(act),
      static_cast<int32_t*>(base), static_cast<int32_t*>(cov),
      static_cast<int32_t*>(npred), static_cast<int32_t*>(pred),
      static_cast<int32_t*>(predw), static_cast<int32_t*>(nsucc),
      static_cast<int32_t*>(nalig), static_cast<int32_t*>(alig),
      static_cast<int32_t*>(node_count), static_cast<int32_t*>(status),
      static_cast<int32_t*>(paths), N, P, A, L, S, s_row, max_nodes);
  return (int)cudaGetLastError();
}

#ifdef CGA_ADD_SPLIT
// the split build's record: W x kAddSplitSlots int64, zeroed by the caller
extern "C" int cga_poa_add_split_set(void* split) {
  return (int)cudaMemcpyToSymbol(cga::g_add_split, &split, sizeof(split));
}
#endif
