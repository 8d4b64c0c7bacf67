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

#include "poa_topsort.cuh"

namespace {

__global__ void poa_topsort_kernel(const int32_t* __restrict__ level_in,
                                   const int32_t* __restrict__ npred,
                                   const int32_t* __restrict__ pred,
                                   const int32_t* __restrict__ node_count,
                                   int32_t* __restrict__ level_out,
                                   int32_t* __restrict__ order,
                                   int32_t* __restrict__ rank,
                                   int32_t* __restrict__ ok, int N, int P) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* la = smem;      // levels read by this sweep
  int32_t* lb = la + N;    // levels written by this sweep
  int32_t* np = lb + N;    // in-degrees
  int32_t* pr = np + N;    // pred lists, N * P

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t off = (size_t)w * N;
  const int nc = node_count[w];

  for (int u = tid; u < N; u += nt) {
    la[u] = u < nc ? max(level_in[off + u], 0) : 0;
    np[u] = npred[off + u];
  }
  for (int i = tid; i < N * P; i += nt) pr[i] = pred[off * P + i];
  __syncthreads();

  int changed;
  const int32_t* lv = cga::topsort_levels(la, lb, np, pr, nc, N, P, &changed);
  cga::topsort_place(lv, nc, N, level_out + off, order + off, rank + off);
  if (tid == 0) ok[w] = !changed;
}

}  // namespace
// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// level_in, npred (W, N), pred (W, N, P), node_count (W,) int32; writes
// level_out, order, rank (W, N) and ok (W,) int32.
extern "C" int cga_poa_topsort(const void* level_in, const void* npred,
                               const void* pred, const void* node_count,
                               void* level_out, void* order, void* rank,
                               void* ok, int W, int N, int P, void* stream) {
  const int threads = N >= 1024 ? 1024 : ((N + 31) / 32) * 32;
  const long long smem = 4LL * N * (3 + P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_topsort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  poa_topsort_kernel<<<W, threads > 0 ? threads : 32, (size_t)smem,
                       (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(level_in),
      static_cast<const int32_t*>(npred), static_cast<const int32_t*>(pred),
      static_cast<const int32_t*>(node_count),
      static_cast<int32_t*>(level_out), static_cast<int32_t*>(order),
      static_cast<int32_t*>(rank), static_cast<int32_t*>(ok), N, P);
  return (int)cudaGetLastError();
}
