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
// still happen, because the consensus reads that state.
//
// What bounds it on Hopper.  Each step is a short chain of dependent loads
// and stores into the window's graph (a few hundred bytes touched, a few
// dozen int32 operations), and the steps of a window are serial.  Latency
// of that chain, not bytes or operations, bounds a window; the card's
// throughput comes from many windows walking at once.
//
// Design.  One warp per window, its lane 0 walking the path over the
// graph in device memory (the lines it touches stay in L1), so that no
// two windows share a warp and diverge.  The state is updated in place; the
// wrapper hands the kernel a copy, which keeps the entry point pure.  The
// clique sort holds at most kMaxMembers = A + 1 ids in local memory.

#include "common.cuh"

namespace {

constexpr int kMaxMembers = 64;  // A + 1; the wrapper refuses a larger A
constexpr int kBig = 1 << 30;
constexpr int kNodeOverflow = 23;  // NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE
constexpr int kEdgeOverflow = 24;  // EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__global__ void poa_add_kernel(
    const int32_t* __restrict__ pn, const int32_t* __restrict__ pp,
    const int32_t* __restrict__ seq, const int32_t* __restrict__ weights,
    const int32_t* __restrict__ k0s, const int32_t* __restrict__ act,
    int32_t* __restrict__ base, int32_t* __restrict__ cov,
    int32_t* __restrict__ npred, int32_t* __restrict__ pred,
    int32_t* __restrict__ predw, int32_t* __restrict__ nsucc,
    int32_t* __restrict__ nalig, int32_t* __restrict__ alig,
    int32_t* __restrict__ node_count, int32_t* __restrict__ status, int N,
    int P, int A, int L, int max_nodes) {
  const int w = blockIdx.x;
  if (threadIdx.x != 0 || !act[w]) return;
  const int TL = N + L;
  const size_t wn = (size_t)w * N;
  int32_t* B = base + wn;
  int32_t* C = cov + wn;
  int32_t* NP = npred + wn;
  int32_t* NS = nsucc + wn;
  int32_t* NA = nalig + wn;
  int32_t* PR = pred + wn * P;
  int32_t* PW = predw + wn * P;
  int32_t* AL = alig + wn * A;
  const int32_t* S = seq + (size_t)w * L;
  const int32_t* WT = weights + (size_t)w * L;
  const int32_t* PN = pn + (size_t)w * TL;
  const int32_t* PP = pp + (size_t)w * TL;
  int nc = node_count[w];
  int st = status[w];
  int prev = -1, prev_pos = -1;
  int mem[kMaxMembers], cur[kMaxMembers];

  for (int ix = max(k0s[w], 0); ix < TL; ++ix) {
    const int node = PN[ix];
    const int pos = PP[ix];
    if (node == -2 || (node == -1 && pos == -1) || (node >= 0 && pos == -1))
      continue;  // inert or a deletion: nothing is consumed
    const bool pos_ok = pos >= 0 && pos < L;
    const int b = pos_ok ? S[pos] : -1;
    const int wt = pos_ok ? WT[pos] : 0;

    // choose or create the target node
    const int node_c = clip(node, 0, N - 1);
    const bool same = node >= 0 && b >= 0 && B[node_c] == b;
    const int nal = NA[node_c];
    bool any_cand = false;
    int cand_sel = 0;
    if (b >= 0)
      for (int a = 0; a < A && a < nal; ++a) {
        const int c = AL[node_c * A + a];
        if ((c >= 0 && c < N ? B[c] : -2) == b) {
          cand_sel = c;
          any_cand = true;
          break;
        }
      }
    const bool need_new = !(node >= 0 && (same || any_cand));
    const int new_id = clip(nc, 0, N - 1);
    const bool overflow_node = need_new && nc >= max_nodes;
    const int target = (node >= 0 && same)       ? node
                       : (node >= 0 && any_cand) ? cand_sel
                                                 : new_id;
    const int tc = clip(target, 0, N - 1);
    const bool link = need_new && node >= 0;
    const bool overflow_clique = link && nal + 1 > A;
    if (link) {  // read the clique before the new node's row is written
      mem[0] = node_c;
      for (int a = 0; a < A; ++a)
        mem[a + 1] = a < nal ? AL[node_c * A + a] : -1;
    }
    if (need_new) B[new_id] = b;
    if (link) {
      // the new node's list: the A smallest members, sorted (-1 as +inf)
      for (int i = 0; i <= A; ++i) cur[i] = mem[i] >= 0 ? mem[i] : kBig;
      for (int i = 1; i <= A; ++i)
        for (int q = i; q > 0 && cur[q - 1] > cur[q]; --q) {
          const int t = cur[q];
          cur[q] = cur[q - 1];
          cur[q - 1] = t;
        }
      for (int a = 0; a < A; ++a)
        AL[new_id * A + a] = cur[a] >= kBig ? -1 : cur[a];
      NA[new_id] = min(nal + 1, A);
      // append new_id to each member's list, counts read after that set
      for (int i = 0; i <= A; ++i) cur[i] = NA[clip(mem[i], 0, N - 1)];
      for (int i = 0; i <= A; ++i)
        if (mem[i] >= 0 && cur[i] < A) {
          const int mc = clip(mem[i], 0, N - 1);
          AL[mc * A + clip(cur[i], 0, A - 1)] = new_id;
          NA[mc] += 1;
        }
    }
    C[tc] += wt;
    if (need_new && !overflow_node) ++nc;

    // the edge prev -> target
    bool overflow_edge = false;
    if (prev >= 0) {
      const int pw = (prev_pos >= 0 && prev_pos < L) ? WT[prev_pos] : 0;
      const int ew = min(pw, wt);
      const int pc = clip(prev, 0, N - 1);
      const int np_t = NP[tc];
      int32_t* pl = PR + (size_t)tc * P;
      int32_t* plw = PW + (size_t)tc * P;
      int ex = -1, pos_ins = 0;
      for (int p = 0; p < P && p < np_t; ++p) {
        if (ex < 0 && pl[p] == pc) ex = p;
        pos_ins += pl[p] < pc;
      }
      if (ex >= 0) {
        plw[ex] += ew;
      } else if (np_t >= P) {
        overflow_edge = true;
      } else {
        for (int a = P - 1; a > pos_ins; --a) {
          pl[a] = pl[a - 1];
          plw[a] = plw[a - 1];
        }
        pl[pos_ins] = pc;
        plw[pos_ins] = ew;
        NP[tc] = np_t + 1;
        NS[pc] += 1;
      }
    }
    if (st == 0 && (overflow_node || overflow_clique)) st = kNodeOverflow;
    if (st == 0 && overflow_edge) st = kEdgeOverflow;
    prev = target;
    prev_pos = pos;
  }
  node_count[w] = nc;
  status[w] = st;
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// pn, pp (W, N + L), seq, weights (W, L), k0, act (W,) int32; the state
// (base, cov, npred (W, N), pred, predw (W, N, P), nsucc, nalig (W, N),
// alig (W, N, A), node_count, status (W,) int32) is updated in place.
extern "C" int cga_poa_add(const void* pn, const void* pp, const void* seq,
                           const void* weights, const void* k0,
                           const void* act, void* base, void* cov,
                           void* npred, void* pred, void* predw, void* nsucc,
                           void* nalig, void* alig, void* node_count,
                           void* status, int W, int N, int P, int A, int L,
                           int max_nodes, void* stream) {
  if (A + 1 > kMaxMembers) return (int)cudaErrorInvalidValue;
  poa_add_kernel<<<W, 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(pn), static_cast<const int32_t*>(pp),
      static_cast<const int32_t*>(seq), static_cast<const int32_t*>(weights),
      static_cast<const int32_t*>(k0), static_cast<const int32_t*>(act),
      static_cast<int32_t*>(base), static_cast<int32_t*>(cov),
      static_cast<int32_t*>(npred), static_cast<int32_t*>(pred),
      static_cast<int32_t*>(predw), static_cast<int32_t*>(nsucc),
      static_cast<int32_t*>(nalig), static_cast<int32_t*>(alig),
      static_cast<int32_t*>(node_count), static_cast<int32_t*>(status), N, P,
      A, L, max_nodes);
  return (int)cudaGetLastError();
}
