// Heaviest-bundle consensus of each window's POA graph.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas2.py::_consensus_pallas
// (kernel body built by _build_consensus_kernel); spec poa_ops.consensus.
// The outputs equal the plain PyTorch version in ops/poa_consensus.py.
//
// A node's score is wmax (its heaviest in-edge) plus the best score among
// the preds whose edge weighs wmax; sources score 0, inactive nodes NEG.
// The scores are the fixpoint of Jacobi sweeps over all nodes, at most
// N + 2 of them, exactly the relaxation of poa_ops.consensus; where an
// overflowed window's clipped writes left a cycle the sweeps' last state
// is the result.  Every max over the P pred slots counts a masked slot as
// NEG, as the JAX package's masked reductions do.  best_pred is the first
// slot (slots are sorted by pred id) reaching the best score; the path
// ends at the best node, ties to the smallest rank, and is walked back
// through best_pred into an MC-long buffer from its end, then moved to the
// front.
//
// What bounds it on Hopper.  The work is a pass over the active nodes and
// their pred slots and two (MC,) rows written, far below the card's rates:
// a window's chain of dependent steps bounds it.  The first design ran the
// Jacobi sweeps with a block barrier each, as many sweeps as the heaviest
// chains are deep (chip_smoke.py --finish-split; PERF.md, B8).
//
// Design (as the JAX kernel, which visits the nodes in argsort(rank)):
// - A warp a window, several windows a block (no block barrier).  Its
//   tables (consensus_table_ints: scores, a second buffer, the heaviest
//   in-edge, the first tied pred, the tie count, the rank, the walk back)
//   live in shared memory where those of the plan's windows fit a block,
//   else in a device scratch slice a window (ops/poa_consensus.py
//   consensus_plan).  A node with several tied preds reads them from pred
//   and predw where they lie.
// - The scores in one pass in rank order (rank's inverse built in the
//   tables): 32 positions at a time, a lane a node; a tied pred earlier in
//   the order is final, one among the same 32 is resolved in position
//   order by one shuffle a position.  A confirming sweep, parallel over the
//   nodes, checks each score against its rule and takes each best pred.
//   A DAG has one fixpoint, so a confirmed fixpoint whose every tied pred
//   lies earlier in the order is the Jacobi one.  A window whose rank is
//   not a permutation of its active nodes, whose order puts a tied pred at
//   or after its node (a cycle after an overflow, or a topsort that did not
//   converge), or that is not confirmed, runs the Jacobi sweeps from its
//   starting scores, so the outputs equal the plain version's on every
//   graph.
// - The end node by three warp reductions, the walk back serial on lane
//   0 through the best preds in the tables, the codes and coverages
//   written by the warp.
// Built with CGA_CONSENSUS_SPLIT (chip_smoke.py --finish-split), lane 0 of
// each window writes the cycles of its parts and its sweeps.

#include "poa_consensus.cuh"

#ifdef CGA_CONSENSUS_SPLIT
__device__ long long* g_consensus_split;
#endif

namespace {

// kShared: the tables in shared memory (per int32 a window each), else in
// the window's slice of the device scratch
template <bool kShared>
__global__ void poa_consensus_kernel(
    const int32_t* __restrict__ npred, const int32_t* __restrict__ pred,
    const int32_t* __restrict__ predw, const int32_t* __restrict__ base,
    const int32_t* __restrict__ cov, const int32_t* __restrict__ rank,
    const int32_t* __restrict__ node_count, int32_t* __restrict__ codes,
    int32_t* __restrict__ covs, int32_t* __restrict__ lengths,
    int32_t* __restrict__ scratch, int W, int N, int P, int MC, int per) {
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + slot;
  if (w >= W) return;  // the whole warp
  const size_t wn = (size_t)w * N;
  int32_t* T = kShared ? smem + (size_t)slot * per : scratch + (size_t)w * per;
  long long* split = nullptr;
#ifdef CGA_CONSENSUS_SPLIT
  split = g_consensus_split + (size_t)w * cga::kConsensusSplitSlots;
#endif
  cga::consensus_warp(npred + wn, pred + wn * P, predw + wn * P, base + wn,
                      cov + wn, rank + wn, node_count[w],
                      codes + (size_t)w * MC, covs + (size_t)w * MC,
                      lengths + w, N, P, MC, T, lane, split);
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// npred, base, cov, rank (W, N), pred, predw (W, N, P), node_count (W,)
// int32; writes codes, covs (W, MC) and lengths (W,) int32.  A warp a
// window, `windows` a block; the tables in shared memory when scratch is
// null, else in scratch, consensus_table_ints(N, MC) int32 a window.
extern "C" int cga_poa_consensus(const void* npred, const void* pred,
                                 const void* predw, const void* base,
                                 const void* cov, const void* rank,
                                 const void* node_count, void* codes,
                                 void* covs, void* lengths, void* scratch,
                                 int W, int N, int P, int MC, int windows,
                                 void* stream) {
  if (windows < 1 || windows > 32 || N < 1) return (int)cudaErrorInvalidValue;
  const int per = (int)cga::consensus_table_ints(N, MC);
  const long long smem = scratch == nullptr ? 4LL * per * windows : 0;
  auto kernel = scratch == nullptr ? poa_consensus_kernel<true>
                                   : poa_consensus_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(W + windows - 1) / windows, 32 * windows, (size_t)smem,
           (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(npred), static_cast<const int32_t*>(pred),
      static_cast<const int32_t*>(predw), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(cov), static_cast<const int32_t*>(rank),
      static_cast<const int32_t*>(node_count), static_cast<int32_t*>(codes),
      static_cast<int32_t*>(covs), static_cast<int32_t*>(lengths),
      static_cast<int32_t*>(scratch), W, N, P, MC, per);
  return (int)cudaGetLastError();
}

#ifdef CGA_CONSENSUS_SPLIT
// the split build's record: W x kConsensusSplitSlots int64, zeroed by the
// caller
extern "C" int cga_poa_consensus_split_set(void* split) {
  return (int)cudaMemcpyToSymbol(g_consensus_split, &split, sizeof(split));
}
#endif
