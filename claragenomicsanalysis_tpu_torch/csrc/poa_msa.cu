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
// dependent steps, each the skip test, one max over at most (A + 1) * P
// columns and the members' writes; the rows are S * L independent gathers
// and the (S, N) rows written.  The first design walked the ranks on one
// warp of a block, each rank three rounds of dependent loads from device
// memory (order, the clique, the pred slots), while the block's other
// warps waited (chip_smoke.py --finish-split; PERF.md, B9).
//
// Design:
// - A warp a window, several windows a block (no block barrier).  Its
//   tables, the columns (N) and the rank lists (msa_list_ints), live in
//   shared memory where those of the plan's windows fit a block; else the
//   columns alone where they fit one window a block, the lists in a device
//   scratch slice; else both in the scratch slice (ops/poa_msa.py
//   msa_plan).
// - A rank's member and pred ids depend on no column: the warp gathers
//   them for 32 ranks at a time (msa_gather_ranks), a lane a rank, each
//   into a fixed stride of the lists, then walks those ranks in order
//   reading only the lists and the columns: an entry a lane, the skip test
//   a vote on the rank's node's column, the max over the preds' columns a
//   warp reduction, then the members' writes.
// - Rows: the (S, N) -1 fill in 16-byte stores, then 32 positions of 8
//   sequences at a time scattered in position order (the 8 land in 8
//   rows); __match_any_sync keeps the later position where two share a
//   cell.
// Built with CGA_MSA_SPLIT (chip_smoke.py --finish-split), lane 0 of each
// window writes the cycles of its parts, its ranks and its gathers.

#include "poa_msa.cuh"

#ifdef CGA_MSA_SPLIT
__device__ long long* g_msa_split;
#endif

namespace {

// where a window's tables live: kColShared, the columns in shared memory;
// kListShared, the rank lists too; the others in the window's slice of the
// device scratch
template <bool kColShared, bool kListShared>
__global__ void poa_msa_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ npred,
    const int32_t* __restrict__ nalig, const int32_t* __restrict__ base,
    const int32_t* __restrict__ pred, const int32_t* __restrict__ alig,
    const int32_t* __restrict__ paths, const int32_t* __restrict__ node_count,
    int32_t* __restrict__ rows, int32_t* __restrict__ n_cols,
    int32_t* __restrict__ scratch, int W, int N, int P, int A, int S,
    int L) {
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + slot;
  if (w >= W) return;  // the whole warp
  const size_t wn = (size_t)w * N;
  const int cap = cga::msa_list_ints(P, A);
  const int in_smem = (kColShared ? N : 0) + (kListShared ? cap : 0);
  const int in_scratch = (kColShared ? 0 : N) + (kListShared ? 0 : cap);
  int32_t* sm = smem + (size_t)slot * in_smem;
  int32_t* dv = scratch + (size_t)w * in_scratch;
  int32_t* col = kColShared ? sm : dv;
  int32_t* list = kListShared ? sm + N : (kColShared ? dv : dv + N);
  long long* split = nullptr;
#ifdef CGA_MSA_SPLIT
  split = g_msa_split + (size_t)w * cga::kMsaSplitSlots;
#endif
  cga::msa_warp(order + wn, npred + wn, nalig + wn, base + wn, pred + wn * P,
                alig + wn * A, paths + (size_t)w * S * L, node_count[w],
                rows + (size_t)w * S * N, n_cols + w, N, P, A, S, L, col,
                list, lane, split);
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// order, npred, nalig, base (W, N), pred (W, N, P), alig (W, N, A), paths
// (W, S, L), node_count (W,) int32; writes rows (W, S, N) and n_cols (W,)
// int32.  A warp a window, `windows` a block.  plan 0: the columns and
// the rank lists in shared memory (scratch null); 1: the columns in shared
// memory, the lists in scratch, msa_list_ints(P, A) int32 a window; 2: both
// in scratch, N + msa_list_ints(P, A) int32 a window.
extern "C" int cga_poa_msa(const void* order, const void* npred,
                           const void* nalig, const void* base,
                           const void* pred, const void* alig,
                           const void* paths, const void* node_count,
                           void* rows, void* n_cols, void* scratch, int W,
                           int N, int P, int A, int S, int L, int plan,
                           int windows, void* stream) {
  if (windows < 1 || windows > 32 || N < 1 || plan < 0 || plan > 2 ||
      (plan > 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const int cap = cga::msa_list_ints(P, A);
  const long long per = plan == 0 ? (long long)N + cap : plan == 1 ? N : 0;
  const long long smem = 4LL * per * windows;
  auto kernel = plan == 0   ? poa_msa_kernel<true, true>
                : plan == 1 ? poa_msa_kernel<true, false>
                            : poa_msa_kernel<false, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(W + windows - 1) / windows, 32 * windows, (size_t)smem,
           (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(npred),
      static_cast<const int32_t*>(nalig), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(pred), static_cast<const int32_t*>(alig),
      static_cast<const int32_t*>(paths),
      static_cast<const int32_t*>(node_count), static_cast<int32_t*>(rows),
      static_cast<int32_t*>(n_cols), static_cast<int32_t*>(scratch), W, N, P,
      A, S, L);
  return (int)cudaGetLastError();
}

#ifdef CGA_MSA_SPLIT
// the split build's record: W x kMsaSplitSlots int64, zeroed by the caller
extern "C" int cga_poa_msa_split_set(void* split) {
  return (int)cudaMemcpyToSymbol(g_msa_split, &split, sizeof(split));
}
#endif
