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

#include <climits>

#include "common.cuh"

namespace {

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);  // int32 arithmetic, as in JAX
}

__global__ void poa_consensus_kernel(
    const int32_t* __restrict__ npred, const int32_t* __restrict__ pred,
    const int32_t* __restrict__ predw, const int32_t* __restrict__ base,
    const int32_t* __restrict__ cov, const int32_t* __restrict__ rank,
    const int32_t* __restrict__ node_count, int32_t* __restrict__ codes,
    int32_t* __restrict__ covs, int32_t* __restrict__ lengths, int N, int P,
    int MC) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* sa = smem;       // scores read by this sweep
  int32_t* sb = sa + N;     // scores written by this sweep
  int32_t* wmx = sb + N;    // heaviest in-edge weight
  int32_t* ntie = wmx + N;  // tied slots per node
  int32_t* has = ntie + N;  // npred > 0
  int32_t* bp = has + N;    // best_pred
  int32_t* tie = bp + N;    // tied preds (raw ids) in slot order, N * P
  int32_t* buf = tie + N * P;  // the walk back, MC
  __shared__ int s_max, s_rank, s_end, s_k;

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t wn = (size_t)w * N;
  const int nc = node_count[w];

  for (int u = tid; u < N; u += nt) {
    const bool act = u < nc;
    const int np = npred[wn + u];
    const int k = act ? min(max(np, 0), P) : 0;  // slots in use
    const int32_t* pw = predw + (wn + u) * P;
    int wm = k < P ? cga::kNeg : INT_MIN;
    for (int p = 0; p < k; ++p) wm = max(wm, pw[p]);
    int n = 0;
    for (int p = 0; p < k; ++p)
      if (pw[p] == wm) tie[u * P + n++] = pred[(wn + u) * P + p];
    wmx[u] = wm;
    ntie[u] = n;
    has[u] = np > 0;
    sa[u] = (act && np <= 0) ? 0 : cga::kNeg;
  }
  __syncthreads();

  // the best score among u's tied preds, a masked slot counting as NEG
  auto best_tied = [&](const int32_t* score, int u) {
    int m = ntie[u] < P ? cga::kNeg : INT_MIN;
    for (int t = 0; t < ntie[u]; ++t)
      m = max(m, score[min(max(tie[u * P + t], 0), N - 1)]);
    return m;
  };

  int changed = 1;
  for (int it = 0; changed && it < N + 2; ++it) {
    int local = 0;
    for (int u = tid; u < N; u += nt) {
      int nv = cga::kNeg;
      if (u < nc) nv = has[u] ? wrap_add(wmx[u], best_tied(sa, u)) : 0;
      sb[u] = nv;
      local |= nv != sa[u];
    }
    changed = __syncthreads_or(local);
    int32_t* t = sa;
    sa = sb;
    sb = t;
  }

  if (tid == 0) {
    s_max = nc < N ? cga::kNeg : INT_MIN;
    s_rank = INT_MAX;
    s_end = INT_MAX;
  }
  for (int u = tid; u < N; u += nt) {
    int b = -1;
    if (u < nc && has[u]) {
      const int m = best_tied(sa, u);
      b = pred[(wn + u) * P];  // no tied slot reaches m: slot 0, as argmax
      for (int t = 0; t < ntie[u]; ++t)
        if (sa[min(max(tie[u * P + t], 0), N - 1)] == m) {
          b = tie[u * P + t];
          break;
        }
    }
    bp[u] = b;
  }
  __syncthreads();
  for (int u = tid; u < nc && u < N; u += nt) atomicMax(&s_max, sa[u]);
  __syncthreads();
  const int smax = s_max;
  for (int u = tid; u < N; u += nt)
    atomicMin(&s_rank, (u < nc && sa[u] == smax) ? rank[wn + u] : 1 << 30);
  __syncthreads();
  for (int u = tid; u < N; u += nt)
    if (((u < nc && sa[u] == smax) ? rank[wn + u] : 1 << 30) == s_rank)
      atomicMin(&s_end, u);
  __syncthreads();

  if (tid == 0) {
    int u = nc > 0 ? s_end : -1;
    int k = MC;
    while (u >= 0 && k > 0) {
      buf[k - 1] = u;
      u = u < N ? bp[u] : -1;
      --k;
    }
    s_k = k;
    lengths[w] = MC - k;
  }
  __syncthreads();
  const int k = s_k;
  for (int i = tid; i < MC; i += nt) {
    int c = -1, v = 0;
    if (i < MC - k) {
      const int node = buf[i + k];
      if (node >= 0 && node < N) {
        c = base[wn + node];
        v = cov[wn + node];
      }
    }
    codes[(size_t)w * MC + i] = c;
    covs[(size_t)w * MC + i] = v;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// npred, base, cov, rank (W, N), pred, predw (W, N, P), node_count (W,)
// int32; writes codes, covs (W, MC) and lengths (W,) int32.
extern "C" int cga_poa_consensus(const void* npred, const void* pred,
                                 const void* predw, const void* base,
                                 const void* cov, const void* rank,
                                 const void* node_count, void* codes,
                                 void* covs, void* lengths, int W, int N,
                                 int P, int MC, void* stream) {
  const int threads = N >= 1024 ? 1024 : ((N + 31) / 32) * 32;
  const long long smem = 4LL * (6LL * N + (long long)N * P + MC);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_consensus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  poa_consensus_kernel<<<W, threads > 0 ? threads : 32, (size_t)smem,
                         (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(npred), static_cast<const int32_t*>(pred),
      static_cast<const int32_t*>(predw), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(cov), static_cast<const int32_t*>(rank),
      static_cast<const int32_t*>(node_count), static_cast<int32_t*>(codes),
      static_cast<int32_t*>(covs), static_cast<int32_t*>(lengths), N, P, MC);
  return (int)cudaGetLastError();
}
