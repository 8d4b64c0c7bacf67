// The whole POA of a window in one kernel: the first sequence's chain, then
// per added sequence topsort -> graph NW -> traceback -> add-alignment, then
// the consensus and, when asked for, the MSA.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas.py::poa_batch_pallas
// (kernel body built by build_poa_kernel); spec models/poa._build_program.
// The outputs equal the lockstep route's (ops/poa_window.py::run_windows on
// the plain PyTorch versions of the five phases).
//
// The phases are the device functions of poa_topsort.cuh, poa_nwtb.cuh,
// poa_add.cuh, poa_consensus.cuh and poa_msa.cuh, the same code the five
// per-phase kernels run, so each rule exists once.  The status rules are
// those of the lockstep loop: a window takes sequence s while s < n_seqs and
// its status is SUCCESS; a sequence whose best end cell lies outside the band
// leaves the graph as it was and sets EXCEEDED_BAND_WIDTH; a topsort that did
// not converge sets LOOP_COUNT_EXCEEDED_UPPER_BOUND over whatever the add
// set; overflows come from the add.
//
// What bounds it on Hopper.  The same chains as the per-phase kernels: the
// rows of the score plane with a block scan each, the serial traceback and
// walk, the sweeps of topsort and consensus.  What it saves is the traffic
// between them: the graph never leaves the block between the phases, and one
// launch replaces about four per added sequence.
//
// Design.  One block per window.  The graph (base, cov, npred, nsucc, nalig,
// pred, predw, alig), the carried levels, order and rank stay in shared
// memory for the life of the window; the phases share one scratch region,
// sized for the largest of them; the score plane, the path (pn, pp) and the
// MSA's paths are work buffers in device memory that the wrapper allocates.
// A block barrier separates the phases.  A plan whose shared memory passes
// what a block can have is refused by the wrapper, which names the sizes.

#include "poa_add.cuh"
#include "poa_consensus.cuh"
#include "poa_msa.cuh"
#include "poa_nwtb.cuh"
#include "poa_topsort.cuh"

namespace {

constexpr int kLoopExceeded = 25;  // LOOP_COUNT_EXCEEDED_UPPER_BOUND
constexpr int kBandExceeded = 28;  // EXCEEDED_BAND_WIDTH

// ints of the phases' shared scratch: the largest of topsort's two level
// buffers, the graph NW's staging, the consensus's tables and the MSA's
// columns
__host__ long long window_scratch_ints(int N, int P, int L, int MC) {
  long long m = 2LL * N;
  const long long nw = cga::nwtb_scratch_ints(N, P, L);
  const long long co = cga::consensus_scratch_ints(N, P, MC);
  if (nw > m) m = nw;
  if (co > m) m = co;
  return m;
}

// ints of shared memory a window takes: the graph (5 node fields, pred and
// predw, alig), level, order and rank, then the scratch
__host__ long long window_smem_ints(int N, int P, int A, int L, int MC) {
  return (long long)N * (8 + 2 * P + A) + window_scratch_ints(N, P, L, MC);
}

__global__ void poa_window_kernel(
    const int32_t* __restrict__ seqs, const int32_t* __restrict__ weights,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ n_seqs,
    int32_t* __restrict__ planes, int32_t* __restrict__ pns,
    int32_t* __restrict__ pps, int32_t* __restrict__ paths,
    int32_t* __restrict__ codes, int32_t* __restrict__ covs,
    int32_t* __restrict__ lengths, int32_t* __restrict__ statuses,
    int32_t* __restrict__ rows, int32_t* __restrict__ n_cols, int N, int P,
    int A, int S, int L, int MC, int max_nodes, int match, int mismatch,
    int g, int band_width) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* base = smem;
  int32_t* cov = base + N;
  int32_t* npred = cov + N;
  int32_t* nsucc = npred + N;
  int32_t* nalig = nsucc + N;
  int32_t* level = nalig + N;
  int32_t* order = level + N;
  int32_t* rank = order + N;
  int32_t* pred = rank + N;
  int32_t* predw = pred + N * P;
  int32_t* alig = predw + N * P;
  int32_t* scratch = alig + N * A;
  __shared__ int s_nc, s_st, s_k0, s_band_ok;

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int TL = N + L;
  const int32_t* SQ = seqs + (size_t)w * S * L;
  const int32_t* WT = weights + (size_t)w * S * L;
  const int32_t* LN = lens + (size_t)w * S;
  int32_t* plane = planes + (size_t)w * (N + 1) * (L + 1);
  int32_t* pnw = pns + (size_t)w * TL;
  int32_t* ppw = pps + (size_t)w * TL;
  int32_t* PT = paths == nullptr ? nullptr : paths + (size_t)w * S * L;
  const int ns = n_seqs[w];
  const int len0 = LN[0];

  // the graph of the first sequence: a chain, node u at level u
  for (int u = tid; u < N; u += nt) {
    const bool act = u < len0;
    const int w_u = u < L ? WT[u] : 0;
    const int w_p = (u >= 1 && u - 1 < L) ? WT[u - 1] : (u == 0 ? w_u : 0);
    const bool has = act && u > 0;
    base[u] = act && u < L ? SQ[u] : -1;
    cov[u] = act ? w_u : 0;
    npred[u] = has;
    nsucc[u] = act && u < len0 - 1;
    nalig[u] = 0;
    level[u] = act ? u : 0;
    for (int p = 0; p < P; ++p) {
      pred[u * P + p] = (p == 0 && has) ? u - 1 : -1;
      predw[u * P + p] = (p == 0 && has) ? min(w_p, w_u) : 0;
    }
    for (int a = 0; a < A; ++a) alig[u * A + a] = -1;
  }
  if (PT != nullptr)
    for (int i = tid; i < S * L; i += nt) PT[i] = (i < L && i < len0) ? i : -1;
  if (tid == 0) {
    s_nc = len0;
    s_st = len0 > max_nodes ? cga::kNodeOverflow : 0;
  }
  __syncthreads();

  int32_t* la = scratch;
  int32_t* lb = scratch + N;
  for (int s = 1; s < S; ++s) {
    if (s >= ns || s_st != 0) break;  // the same for the whole block
    const int nc = s_nc;
    for (int u = tid; u < N; u += nt) la[u] = u < nc ? max(level[u], 0) : 0;
    __syncthreads();
    int changed;
    const int32_t* lv =
        cga::topsort_levels(la, lb, npred, pred, nc, N, P, &changed);
    cga::topsort_place(lv, nc, N, level, order, rank);
    __syncthreads();

    for (int i = tid; i < TL; i += nt) {
      pnw[i] = -2;
      ppw[i] = -2;
    }
    cga::nwtb_block(SQ + (size_t)s * L, order, rank, npred, base, nsucc, pred,
                    LN[s], nc, plane, pnw, ppw, N, P, L, match, mismatch, g,
                    band_width, scratch, &s_k0, &s_band_ok);
    __syncthreads();

    if (s_band_ok) {
      int32_t* prow = PT == nullptr ? nullptr : PT + (size_t)s * L;
      if (prow != nullptr) {
        for (int i = tid; i < L; i += nt) prow[i] = -1;
        __syncthreads();
      }
      if (tid == 0) {
        int ncv = nc, st = 0;
        cga::add_walk(pnw, ppw, SQ + (size_t)s * L, WT + (size_t)s * L, s_k0,
                      base, cov, npred, nsucc, nalig, pred, predw, alig, ncv,
                      st, prow, N, P, A, L, max_nodes);
        s_nc = ncv;
        s_st = changed ? kLoopExceeded : st;
      }
    } else if (tid == 0) {
      s_st = kBandExceeded;
    }
    __syncthreads();
  }

  // the final order, the consensus and the MSA
  const int nc = s_nc;
  for (int u = tid; u < N; u += nt) la[u] = u < nc ? max(level[u], 0) : 0;
  __syncthreads();
  int changed;
  const int32_t* lv =
      cga::topsort_levels(la, lb, npred, pred, nc, N, P, &changed);
  cga::topsort_place(lv, nc, N, level, order, rank);
  __syncthreads();
  cga::consensus_block(npred, pred, predw, base, cov, rank, nc,
                       codes + (size_t)w * MC, covs + (size_t)w * MC,
                       lengths + w, N, P, MC, scratch);
  __syncthreads();
  if (rows != nullptr)
    cga::msa_block(order, npred, nalig, base, pred, alig, PT, nc,
                   rows + (size_t)w * S * N, n_cols + w, N, P, A, S, L,
                   scratch);
  if (tid == 0) statuses[w] = s_st;
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// seqs, weights (W, S, L), lens (W, S), n_seqs (W,) int32; plane, pn, pp and
// paths are int32 work buffers of W * (N + 1) * (L + 1), W * (N + L) twice
// and W * S * L; writes codes, covs (W, MC), length, status (W,), rows
// (W, S, N) and n_cols (W,) int32.  paths, rows and n_cols are null when no
// MSA is asked for.  smem_bytes is what the caller counted for one window's
// shared memory; a count other than the kernel's layout is refused.
extern "C" int cga_poa_window(const void* seqs, const void* weights,
                              const void* lens, const void* n_seqs,
                              void* plane, void* pn, void* pp, void* paths,
                              void* codes, void* covs, void* length,
                              void* status, void* rows, void* n_cols, int W,
                              int N, int P, int A, int S, int L, int MC,
                              int max_nodes, int match, int mismatch, int gap,
                              int band_width, int smem_bytes, void* stream) {
  if (A + 1 > cga::kAddMaxMembers) return (int)cudaErrorInvalidValue;
  int threads = cga::nwtb_threads(L);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  if (threads < 128) threads = 128;
  const long long smem = 4LL * window_smem_ints(N, P, A, L, MC);
  if (smem != smem_bytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  poa_window_kernel<<<W, threads, (size_t)smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(seqs), static_cast<const int32_t*>(weights),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(n_seqs),
      static_cast<int32_t*>(plane), static_cast<int32_t*>(pn),
      static_cast<int32_t*>(pp), static_cast<int32_t*>(paths),
      static_cast<int32_t*>(codes), static_cast<int32_t*>(covs),
      static_cast<int32_t*>(length), static_cast<int32_t*>(status),
      static_cast<int32_t*>(rows), static_cast<int32_t*>(n_cols), N, P, A, S,
      L, MC, max_nodes, match, mismatch, gap, band_width);
  return (int)cudaGetLastError();
}
