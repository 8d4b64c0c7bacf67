// Topological levels, order and rank of each window's POA graph.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas2.py::_topsort_pallas
// (kernel body built by _build_topsort_kernel); spec poa_ops.topsort.  The
// outputs equal the plain PyTorch version in ops/poa_topsort.py.
//
// Levels: Jacobi sweeps level[u] = max(max_p level[pred[u][p]] + 1, 0) over
// the active nodes (u < node_count), from the carried levels (inactive nodes
// start at 0 and keep their level), at most N + 2 sweeps; ok = the last
// sweep changed nothing.  Order: the stable sort by (level, id) with the
// inactive nodes last.  The key level * N + id is computed in int32, as the
// JAX package does, and stays below 2^30 (levels are at most a few times N),
// so an inactive node u simply takes rank u and an active one the count of
// active keys below its own.
//
// What bounds it on Hopper.  A sweep is N * P int32 max/compare steps over
// data in shared memory, ended by one barrier; the count of sweeps is the
// number of edges a level change has to travel (the graph's depth at worst).
// Device-memory traffic is the state read once and three (N,) rows written.
// So the chain of barrier-separated sweeps bounds a window, not bytes.
//
// Design.  One block per window, threads over nodes, the window's levels
// (two buffers), in-degrees and pred lists in shared memory, so a sweep
// touches no device memory; __syncthreads_or both ends a sweep and tells
// every thread whether anything changed.  The rank is a count over the
// active nodes (O(nc^2) shared-memory reads, broadcast to the block), so no
// sort pass is needed.  Many windows run at once, one block each.
//
// Two variants of the one kernel body (template kShared), chosen by the
// wrapper from the shapes (ops/poa_topsort.py topsort_smem_bytes): the
// shared variant stages the levels, in-degrees and pred lists, 4N (3 + P)
// bytes a block; past the 227 KB a block can have (a window of some 2,700
// bases or more at P = 4) the device variant keeps the two level buffers
// in a scratch slice of 8N bytes a window and reads the in-degrees and
// pred lists where they lie.

#include "poa_topsort.cuh"

namespace {

template <bool kShared>
__global__ void poa_topsort_kernel(const int32_t* __restrict__ level_in,
                                   const int32_t* __restrict__ npred,
                                   const int32_t* __restrict__ pred,
                                   const int32_t* __restrict__ node_count,
                                   int32_t* __restrict__ level_out,
                                   int32_t* __restrict__ order,
                                   int32_t* __restrict__ rank,
                                   int32_t* __restrict__ ok,
                                   int32_t* __restrict__ scratch, int N,
                                   int P) {
  extern __shared__ __align__(16) int32_t smem[];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t off = (size_t)w * N;
  const int nc = node_count[w];
  // levels read and written by a sweep: shared memory, or this window's
  // slice of the device scratch
  int32_t* la = kShared ? smem : scratch + 2 * off;
  int32_t* lb = la + N;
  const int32_t* np = npred + off;      // in-degrees
  const int32_t* pr = pred + off * P;   // pred lists, N * P
  if constexpr (kShared) {
    int32_t* nps = lb + N;
    int32_t* prs = nps + N;
    for (int u = tid; u < N; u += nt) nps[u] = np[u];
    for (int i = tid; i < N * P; i += nt) prs[i] = pr[i];
    np = nps;
    pr = prs;
  }
  for (int u = tid; u < N; u += nt)
    la[u] = u < nc ? max(level_in[off + u], 0) : 0;
  __syncthreads();

  int changed;
  const int32_t* lv =
      cga::topsort_levels<false>(la, lb, np, pr, nc, N, P, &changed, tid, nt);
  cga::topsort_place(lv, nc, N, level_out + off, order + off, rank + off, tid,
                     nt);
  if (tid == 0) ok[w] = !changed;
}

}  // namespace
// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// level_in, npred (W, N), pred (W, N, P), node_count (W,) int32; writes
// level_out, order, rank (W, N) and ok (W,) int32.  scratch is null for the
// shared variant and holds 2N int32 a window for the device variant.
extern "C" int cga_poa_topsort(const void* level_in, const void* npred,
                               const void* pred, const void* node_count,
                               void* level_out, void* order, void* rank,
                               void* ok, void* scratch, int W, int N, int P,
                               void* stream) {
  const int threads = N >= 1024 ? 1024 : ((N + 31) / 32) * 32;
  auto go = [&](auto kernel, size_t smem) {
    kernel<<<W, threads > 0 ? threads : 32, smem, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(level_in),
        static_cast<const int32_t*>(npred), static_cast<const int32_t*>(pred),
        static_cast<const int32_t*>(node_count),
        static_cast<int32_t*>(level_out), static_cast<int32_t*>(order),
        static_cast<int32_t*>(rank), static_cast<int32_t*>(ok),
        static_cast<int32_t*>(scratch), N, P);
  };
  if (scratch != nullptr) {
    go(poa_topsort_kernel<false>, 0);
    return (int)cudaGetLastError();
  }
  const long long smem = 4LL * N * (3 + P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_topsort_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  go(poa_topsort_kernel<true>, (size_t)smem);
  return (int)cudaGetLastError();
}
