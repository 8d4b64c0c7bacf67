// Multiple sequence alignment of each window's POA graph: a column per
// aligned clique, then each sequence's gapped row.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas2.py::_msa_pallas
// (kernel body built by _build_msa_kernel); spec poa_ops.msa_columns and
// poa_ops.msa_rows(max_cols = N).  The outputs equal the plain PyTorch
// version in ops/poa_msa.py.
//
// Columns: the nodes are visited in topological order (order[r], r <
// node_count).  A node without a column gets one together with its aligned
// clique: c = 1 + max over the columns of every filled pred slot of every
// member (-1 where none), written to every member whose id lies in [0, N).
// n_cols = 1 + max column over the active nodes.  Rows: sequence s puts
// base[paths[s][j]] into column col[paths[s][j]] for every position whose
// path entry is >= 0 and whose column lies in [0, N); the rest of a row is
// -1.  Ids out of range (an overflowed window's clipped writes) read as no
// node and are never written; where two positions of a sequence share a
// column (again only after an overflow) the later position wins.
//
// What bounds it on Hopper.  The column pass is a chain of node_count
// dependent steps, each a handful of loads (the clique, its pred slots,
// their columns) and one max over at most (A + 1) * P values; the rows are
// S * L independent gathers and stores.  Device-memory traffic is the graph
// and the paths read once and rows written once.  The serial chain bounds a
// window; the card's throughput comes from many windows at once.
//
// Design.  One block per window.  col (N) lives in shared memory.  Warp 0
// walks the ranks: a lane per (member, pred slot) pair gathers a column, a
// shuffle max reduces them, the lanes write the members.  Then a warp per
// sequence scatters 32 positions at a time; __match_any_sync keeps the
// later position where two share a column.

#include "poa_msa.cuh"

namespace {

__global__ void poa_msa_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ npred,
    const int32_t* __restrict__ nalig, const int32_t* __restrict__ base,
    const int32_t* __restrict__ pred, const int32_t* __restrict__ alig,
    const int32_t* __restrict__ paths, const int32_t* __restrict__ node_count,
    int32_t* __restrict__ rows, int32_t* __restrict__ n_cols, int N, int P,
    int A, int S, int L) {
  extern __shared__ __align__(16) int32_t smem[];
  const int w = blockIdx.x;
  const size_t wn = (size_t)w * N;
  cga::msa_group<false>(order + wn, npred + wn, nalig + wn, base + wn,
                        pred + wn * P, alig + wn * A,
                        paths + (size_t)w * S * L, node_count[w],
                        rows + (size_t)w * S * N, n_cols + w, N, P, A, S, L,
                        smem, threadIdx.x, blockDim.x);
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// order, npred, nalig, base (W, N), pred (W, N, P), alig (W, N, A), paths
// (W, S, L), node_count (W,) int32; writes rows (W, S, N) and n_cols (W,)
// int32.
extern "C" int cga_poa_msa(const void* order, const void* npred,
                           const void* nalig, const void* base,
                           const void* pred, const void* alig,
                           const void* paths, const void* node_count,
                           void* rows, void* n_cols, int W, int N, int P,
                           int A, int S, int L, void* stream) {
  const int want = (S < 4 ? 4 : S) * 32;  // a warp per sequence
  const int threads = want > 512 ? 512 : want;
  const long long smem = 4LL * N;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_msa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  poa_msa_kernel<<<W, threads, (size_t)smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(npred),
      static_cast<const int32_t*>(nalig), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(pred), static_cast<const int32_t*>(alig),
      static_cast<const int32_t*>(paths),
      static_cast<const int32_t*>(node_count), static_cast<int32_t*>(rows),
      static_cast<int32_t*>(n_cols), N, P, A, S, L);
  return (int)cudaGetLastError();
}
