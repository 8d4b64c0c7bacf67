// Topological levels, order and rank of each window's POA graph.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas2.py::_topsort_pallas
// (kernel body built by _build_topsort_kernel); spec poa_ops.topsort.  The
// outputs equal the plain PyTorch version in ops/poa_topsort.py.
//
// Levels: the fixpoint of level[u] = max(max_p level[pred[u][p]] + 1, 0) over
// the active nodes (u < node_count; inactive nodes stay at 0), as the Jacobi
// sweeps of the plain version reach it from the carried levels in at most
// N + 2 sweeps; ok = the last sweep changed nothing.  A graph without a cycle
// has exactly one fixpoint, so any relaxation that ends at a fixpoint gives
// the Jacobi sweeps' levels; a graph with a cycle has none, and then the
// levels are those of N + 2 Jacobi sweeps.  Order: the stable sort by
// (level, id) with the inactive nodes last; rank its inverse.
//
// What bounds it on Hopper.  The work is a pass over the active nodes and
// their filled pred slots and three (N,) rows written, far below the card's
// rates: what bounds a window is its chain of dependent steps.  The first
// design ran Jacobi sweeps with a block barrier each; a level change travels
// one edge a sweep, so an inserted node shifted the levels downstream for
// as many sweeps as the backbone is long: 52-186 sweeps a window, 89-94 % of
// its cycles, and the rank a count over the active nodes, O(nc^2) reads
// (chip_smoke.py --topsort-split; PERF.md, B7).
//
// Design (as the JAX kernel, whose hint topsort_guess gives the order):
// - A warp a window (several windows a block, no block barrier).  Its tables
//   (topsort_table_ints: levels, a second level buffer, visit positions,
//   the visit order, a histogram) live in shared memory where those of the
//   plan's windows fit a block, else in a device scratch slice a window
//   (ops/poa_topsort.py topsort_plan); the pred lists are read where they
//   lie.
// - The levels are relaxed in a visit order that is topological for the
//   graph after the last add (poa_topsort.cuh topsort_warp): the old nodes
//   (id < nc_pre, the node count the carried levels were computed for) in
//   their carried (level, id) order, each new node right after its anchor,
//   the old node its chain of new nodes hangs from through first-pred links
//   (a chain is a run of ids, as the add makes it), in chain order.  The add
//   walks the old nodes in rank order, so a new node's old successor lies
//   after its anchor.  An ordered sweep takes 32 positions at a time; a node
//   pulls its preds' levels, those earlier among the same 32 by one shuffle
//   a position, so a topological order converges in one sweep; a confirming
//   sweep, parallel over the nodes, checks the fixpoint.  A window still off
//   its fixpoint after kOrderedSweeps ordered sweeps (a cycle, or a hint that
//   was wrong) runs the Jacobi sweeps from its starting levels, so level and
//   ok equal the plain version's on every graph.
// - The rank is a counting sort on (level, id): a histogram of the levels
//   (a fixpoint's lie in 0..nc), its prefix sum, then the nodes placed in
//   id order, 32 at a time, each after the lower lanes of its level
//   (__match_any_sync).  A window whose levels did not converge ranks by
//   the count of smaller keys (topsort_place).
// Built with CGA_TOPSORT_SPLIT (chip_smoke.py --topsort-split), lane 0 of
// each window writes its sweeps and the cycles of the visit order, the
// sweeps and the rank.

#include "poa_topsort.cuh"

#ifdef CGA_TOPSORT_SPLIT
__device__ long long* g_topsort_split;
#endif

namespace {

// kShared: the tables in shared memory (per int32 a window each), else in
// the window's slice of the device scratch
template <bool kShared>
__global__ void poa_topsort_kernel(const int32_t* __restrict__ level_in,
                                   const int32_t* __restrict__ npred,
                                   const int32_t* __restrict__ pred,
                                   const int32_t* __restrict__ node_count,
                                   const int32_t* __restrict__ nc_pre,
                                   int32_t* __restrict__ level_out,
                                   int32_t* __restrict__ order,
                                   int32_t* __restrict__ rank,
                                   int32_t* __restrict__ ok,
                                   int32_t* __restrict__ scratch, int W,
                                   int N, int P, int per) {
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + slot;
  if (w >= W) return;  // the whole warp
  const size_t off = (size_t)w * N;
  int32_t* T = kShared ? smem + (size_t)slot * per : scratch + (size_t)w * per;
  const int nc = node_count[w];
  long long* split = nullptr;
#ifdef CGA_TOPSORT_SPLIT
  split = g_topsort_split + (size_t)w * cga::kTopsortSplitSlots;
#endif
  const int good = cga::topsort_warp(
      level_in + off, npred + off, pred + off * P, nc,
      nc_pre == nullptr ? nc : nc_pre[w], N, P, T, level_out + off,
      order + off, rank + off, lane, split);
  if (lane == 0) ok[w] = good;
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// level_in, npred (W, N), pred (W, N, P), node_count (W,) int32, nc_pre
// (W,) int32 or null (every active node old); writes level_out, order,
// rank (W, N) and ok (W,) int32.  A warp a window, `windows` a block; the
// tables in shared memory when scratch is null, else in scratch,
// topsort_table_ints(N) int32 a window.
extern "C" int cga_poa_topsort(const void* level_in, const void* npred,
                               const void* pred, const void* node_count,
                               const void* nc_pre, void* level_out,
                               void* order, void* rank, void* ok,
                               void* scratch, int W, int N, int P,
                               int windows, void* stream) {
  if (windows < 1 || windows > 32 || N < 1) return (int)cudaErrorInvalidValue;
  const int per = (int)cga::topsort_table_ints(N);
  const long long smem = scratch == nullptr ? 4LL * per * windows : 0;
  auto kernel = scratch == nullptr ? poa_topsort_kernel<true>
                                   : poa_topsort_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(W + windows - 1) / windows, 32 * windows, (size_t)smem,
           (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(level_in),
      static_cast<const int32_t*>(npred), static_cast<const int32_t*>(pred),
      static_cast<const int32_t*>(node_count),
      static_cast<const int32_t*>(nc_pre), static_cast<int32_t*>(level_out),
      static_cast<int32_t*>(order), static_cast<int32_t*>(rank),
      static_cast<int32_t*>(ok), static_cast<int32_t*>(scratch), W, N, P,
      per);
  return (int)cudaGetLastError();
}

#ifdef CGA_TOPSORT_SPLIT
// the split build's record: W x kTopsortSplitSlots int64, zeroed by the
// caller
extern "C" int cga_poa_topsort_split_set(void* split) {
  return (int)cudaMemcpyToSymbol(g_topsort_split, &split, sizeof(split));
}
#endif
