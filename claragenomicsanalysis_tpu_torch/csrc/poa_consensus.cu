// Heaviest-bundle consensus of each window's POA graph.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas2.py::_consensus_pallas
// (kernel body built by _build_consensus_kernel); spec poa_ops.consensus.
// The outputs equal the plain PyTorch version in ops/poa_consensus.py.
//
// A node's score is wmax (its heaviest in-edge) plus the best score among
// the preds whose edge weighs wmax; sources score 0, inactive nodes NEG.
// The scores are the fixpoint of Jacobi sweeps over all nodes, at most
// N + 2 of them, exactly the relaxation of poa_ops.consensus; on a DAG this
// equals one pass in topological order, and it stays equal to the JAX
// package where an overflowed window's clipped writes left a cycle.
// Every max over the P pred slots counts a masked slot as NEG, as the JAX
// package's masked reductions do.  best_pred is the first slot (slots are
// sorted by pred id) reaching the best score; the path ends at the best
// node, ties to the smallest rank, and is walked back through best_pred
// into an MC-long buffer from its end, then moved to the front.
//
// What bounds it on Hopper.  A sweep is about 2 int32 operations per node
// and tied pred slot in shared memory, ended by one barrier; the sweeps
// number the depth of the heaviest chains, and the walk back is serial.
// Device-memory traffic is the graph read once and two (MC,) rows written:
// far below the memory rate.  The barrier chain and the serial walk bound a
// window.
//
// Design.  One block per window, threads over nodes.  A first pass keeps in
// shared memory, per node, wmax and the list of its tied preds (the only
// slots a score reads), so a sweep reads nothing from device memory.  The
// end node comes from three shared-memory atomic reductions (max score,
// min rank among the ties, min id among those); thread 0 walks back; all
// threads write the codes and coverages.
//
// Two variants, chosen by the wrapper from the shapes
// (ops/poa_consensus.py consensus_smem_bytes): the tables and the walk back
// (4 (6N + NP + MC) bytes) in shared memory, or, past the 227 KB a block
// can have (cli poa's windows of some 1,800 bases or more), in a scratch
// slice of the same size a window that the wrapper allocates.  The rules
// are one device function, consensus_block, which takes either.

#include "poa_consensus.cuh"

namespace {

template <bool kShared>
__global__ void poa_consensus_kernel(
    const int32_t* __restrict__ npred, const int32_t* __restrict__ pred,
    const int32_t* __restrict__ predw, const int32_t* __restrict__ base,
    const int32_t* __restrict__ cov, const int32_t* __restrict__ rank,
    const int32_t* __restrict__ node_count, int32_t* __restrict__ codes,
    int32_t* __restrict__ covs, int32_t* __restrict__ lengths,
    int32_t* __restrict__ scratch, int N, int P, int MC) {
  extern __shared__ __align__(16) int32_t smem[];
  const int w = blockIdx.x;
  const size_t wn = (size_t)w * N;
  // the tables: shared memory, or this window's slice of the device
  // scratch (a compile-time choice, so the shared variant's accesses stay
  // shared-memory instructions)
  int32_t* tables =
      kShared ? smem
              : scratch + (size_t)w * cga::consensus_scratch_ints(N, P, MC);
  cga::consensus_group<false>(npred + wn, pred + wn * P, predw + wn * P,
                              base + wn, cov + wn, rank + wn, node_count[w],
                              codes + (size_t)w * MC, covs + (size_t)w * MC,
                              lengths + w, N, P, MC, tables, threadIdx.x,
                              blockDim.x);
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// npred, base, cov, rank (W, N), pred, predw (W, N, P), node_count (W,)
// int32; writes codes, covs (W, MC) and lengths (W,) int32.  scratch is null
// for the shared variant and holds consensus_scratch_ints int32 a window for
// the device variant.
extern "C" int cga_poa_consensus(const void* npred, const void* pred,
                                 const void* predw, const void* base,
                                 const void* cov, const void* rank,
                                 const void* node_count, void* codes,
                                 void* covs, void* lengths, void* scratch,
                                 int W, int N, int P, int MC, void* stream) {
  const int threads = N >= 1024 ? 1024 : ((N + 31) / 32) * 32;
  auto go = [&](auto kernel, size_t smem) {
    kernel<<<W, threads > 0 ? threads : 32, smem, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(npred), static_cast<const int32_t*>(pred),
        static_cast<const int32_t*>(predw), static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(cov), static_cast<const int32_t*>(rank),
        static_cast<const int32_t*>(node_count), static_cast<int32_t*>(codes),
        static_cast<int32_t*>(covs), static_cast<int32_t*>(lengths),
        static_cast<int32_t*>(scratch), N, P, MC);
  };
  if (scratch != nullptr) {
    go(poa_consensus_kernel<false>, 0);
    return (int)cudaGetLastError();
  }
  const long long smem = 4LL * cga::consensus_scratch_ints(N, P, MC);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_consensus_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  go(poa_consensus_kernel<true>, (size_t)smem);
  return (int)cudaGetLastError();
}
