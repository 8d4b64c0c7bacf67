// Device function of the add-alignment walk, shared by poa_add.cu (one
// launch per added sequence of the lockstep route) and poa_window.cu (the
// whole POA of a window in one kernel).  The rules are described in
// poa_add.cu; one warp runs the walk, its lanes sharing each step.
#pragma once

#include "common.cuh"

namespace cga {

// A + 1, two clique members a lane; the wrappers refuse a larger A
constexpr int kAddMaxMembers = 64;
constexpr int kAddBig = 1 << 30;
constexpr int kNodeOverflow = 23;  // NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE
constexpr int kEdgeOverflow = 24;  // EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

#ifdef CGA_ADD_SPLIT
// Built so by chip_smoke.py --add-split: the SM cycles of each part of the
// walk, summed per window (blockIdx.x of poa_add.cu) into slots 0-4 (the
// entry scan, the node choice, the clique update, the edge insert, the paths
// row), then the entries scanned, the bases consumed and the new nodes.
constexpr int kAddSplitSlots = 8;
__device__ long long* g_add_split;
#define ADD_SPLIT_START() \
  long long sp_t = clock64(), sp_acc[kAddSplitSlots] = {}
#define ADD_SPLIT_MARK(i)                \
  do {                                   \
    const long long sp_now = clock64();  \
    sp_acc[i] += sp_now - sp_t;          \
    sp_t = sp_now;                       \
  } while (0)
#define ADD_SPLIT_COUNT(i, n) (sp_acc[i] += (n))
#define ADD_SPLIT_END(writer)                           \
  if (writer)                                           \
    for (int sp_i = 0; sp_i < kAddSplitSlots; ++sp_i)   \
      g_add_split[(size_t)blockIdx.x * kAddSplitSlots + sp_i] += sp_acc[sp_i]
#else
#define ADD_SPLIT_START() ((void)0)
#define ADD_SPLIT_MARK(i) ((void)0)
#define ADD_SPLIT_COUNT(i, n) ((void)0)
#define ADD_SPLIT_END(writer) ((void)0)
#endif

// What a step of the walk reads of its node u, this lane's part: the clique
// count, the base, clique slots lane and lane + 32, the coverage (lane 0),
// the pred count, and pred slot lane with its weight.
struct NodeRow {
  int nal, base, a0, a1, cov, np, p0, w0;
};

// The path PN, PP (N + L each) from k0 folded into the window's graph, with
// the sequence S and its weights WT (L each): B, C, NP, NS, NA (N), PR, PW
// (N * P), AL (N * A), in shared or device memory, updated in place, as are
// the node count nc and the status st.  prow, when not null, is the
// sequence's paths row (L), already cleared to -1.  All 32 lanes of one warp
// call it, `lane` their lane; nc and st come back the same in every lane.
//
// The warp reads the path 32 entries at a time, with each entry's base and
// weight (none of which depends on the graph); a ballot keeps the entries
// that consume a base, and the warp visits only those, in order, every lane
// holding the step's values.  The node choice: lane a holds clique slot a
// of the path's node, and a ballot over the candidates' bases finds the
// first that matches.  A new node's clique list is the members (the node
// and its clique, member i in lane i, and i + 32) ranked by comparison over
// shuffles; the appends use the counts read after the new node's own is
// set, as the rules say.  The edge: lane p holds pred slot p (and p + 32,
// ...); ballots find the existing slot and count the smaller preds, and the
// slots above the insert point take their neighbour's by a shuffle.
//
// Each step reads what the steps before it wrote, from L2 more than L1, so
// a step's time is its rounds of dependent loads, and the loads that depend
// on the same value go out together: one round where the base lands on the
// path's node (the common case), its NodeRow (clique count, base and slots,
// and, for that case, coverage, pred count and slots); the candidates' bases
// and another target's row are a round each, only where needed.  (Loading
// the next step's row while a step runs saved nothing: a step that waits on
// no load is shorter than the load.)  No load's value is waited on to store
// it back (a weight from the lane that holds it, a count by atomicAdd).
// Scalar writes come from lane 0; a __syncwarp orders each step's writes
// before the next step's reads.
__device__ __forceinline__ void add_walk(
    const int32_t* PN, const int32_t* PP, const int32_t* S, const int32_t* WT,
    int k0, int32_t* B, int32_t* C, int32_t* NP, int32_t* NS, int32_t* NA,
    int32_t* PR, int32_t* PW, int32_t* AL, int& nc, int& st, int32_t* prow,
    int N, int P, int A, int L, int max_nodes, int lane) {
  const int TL = N + L;
  int prev = -1, prev_wt = 0;  // w[prev_pos] is the previous step's w
  ADD_SPLIT_START();
  // a node's row as a step reads it first, in one round of loads
  const auto load_row = [&](int u) {
    NodeRow r;
    r.nal = NA[u];
    r.base = B[u];
    r.a0 = lane < A ? AL[u * A + lane] : -1;
    r.a1 = lane + 32 < A ? AL[u * A + lane + 32] : -1;
    r.cov = lane == 0 ? C[u] : 0;
    r.np = NP[u];
    r.p0 = lane < P ? PR[(size_t)u * P + lane] : 0;
    r.w0 = lane < P ? PW[(size_t)u * P + lane] : 0;
    return r;
  };
  const int first = max(k0, 0);
  int node = -2, pos = -1;  // this lane's entry of the chunk, loaded ahead
  if (first + lane < TL) {
    node = PN[first + lane];
    pos = PP[first + lane];
  }
  for (int ix0 = first; ix0 < TL; ix0 += 32) {
    const int ix = ix0 + lane;
    // inert (-2, or node and position both -1) or a deletion (a node, no
    // position): nothing is consumed
    const bool take =
        ix < TL &&
        !(node == -2 || (node == -1 && pos == -1) || (node >= 0 && pos == -1));
    const bool pos_ok = pos >= 0 && pos < L;
    const int b_l = take && pos_ok ? S[pos] : -1;
    const int w_l = take && pos_ok ? WT[pos] : 0;
    const int node_l = node, pos_l = pos;
    if (ix + 32 < TL) {  // the next chunk's entries
      node = PN[ix + 32];
      pos = PP[ix + 32];
    }
    unsigned todo = __ballot_sync(kFull, take);
    ADD_SPLIT_COUNT(5, min(32, TL - ix0));
    ADD_SPLIT_MARK(0);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int e_node = __shfl_sync(kFull, node_l, src);
      const int e_pos = __shfl_sync(kFull, pos_l, src);
      const int b = __shfl_sync(kFull, b_l, src);
      const int wt = __shfl_sync(kFull, w_l, src);
      ADD_SPLIT_COUNT(6, 1);

      // choose or create the target node: the path's node where the bases
      // agree, else slot a of its clique in lane a (and a + 32), the first
      // whose base matches.  One round of loads: the node's row.
      const int node_c = clip(e_node, 0, N - 1);
      const NodeRow row = load_row(node_c);
      const int nal = row.nal;
      const int b_node = row.base;
      const int a0 = row.a0, a1 = row.a1;
      int cov = row.cov;
      int np_t = row.np;
      int v0 = row.p0, w0 = row.w0;
      const bool same = e_node >= 0 && b >= 0 && b_node == b;
      const int nsl = min(A, nal);
      const int c0 = lane < nsl ? a0 : -1;
      const int c1 = lane + 32 < nsl ? a1 : -1;
      unsigned m0 = 0, m1 = 0;
      if (!same) {  // a second round: the candidates' bases
        m0 = __ballot_sync(kFull, b >= 0 && lane < nsl &&
                                      (c0 >= 0 && c0 < N ? B[c0] : -2) == b);
        m1 = __ballot_sync(kFull, b >= 0 && lane + 32 < nsl &&
                                      (c1 >= 0 && c1 < N ? B[c1] : -2) == b);
      }
      const int sel0 = __shfl_sync(kFull, c0, m0 ? __ffs(m0) - 1 : 0);
      const int sel1 = __shfl_sync(kFull, c1, m1 ? __ffs(m1) - 1 : 0);
      const bool any_cand = (m0 | m1) != 0;
      const int cand_sel = m0 ? sel0 : sel1;
      const bool need_new = !(e_node >= 0 && (same || any_cand));
      const int new_id = clip(nc, 0, N - 1);
      const bool overflow_node = need_new && nc >= max_nodes;
      const int target = (e_node >= 0 && same)       ? e_node
                         : (e_node >= 0 && any_cand) ? cand_sel
                                                     : new_id;
      const int tc = clip(target, 0, N - 1);
      const bool link = need_new && e_node >= 0;
      const bool overflow_clique = link && nal + 1 > A;
      ADD_SPLIT_MARK(1);
      ADD_SPLIT_COUNT(7, need_new);
      // every lane's reads of B are in (the ballots used them)
      if (need_new && lane == 0) B[new_id] = b;
      if (link) {
        // member 0 is the node, member i + 1 its clique slot i (-1 past
        // nal): member lane in m_lo, member lane + 32 in m_hi; -1 as +inf
        const int up0 = __shfl_up_sync(kFull, c0, 1);
        const int up1 = __shfl_up_sync(kFull, c1, 1);
        const int top0 = __shfl_sync(kFull, c0, 31);
        const int m_lo = lane == 0 ? node_c : up0;
        const int m_hi = lane == 0 ? top0 : up1;
        const bool in_lo = lane <= A, in_hi = lane + 32 <= A;
        const int k_lo = m_lo >= 0 ? m_lo : kAddBig;
        const int k_hi = m_hi >= 0 ? m_hi : kAddBig;
        // the new node's list: the A smallest members, sorted, by rank
        int r_lo = 0, r_hi = 0;
        for (int q = 0; q <= A; ++q) {
          const int kq = __shfl_sync(kFull, q < 32 ? k_lo : k_hi, q & 31);
          r_lo += kq < k_lo || (kq == k_lo && q < lane);
          r_hi += kq < k_hi || (kq == k_hi && q < lane + 32);
        }
        if (in_lo && r_lo < A)
          AL[new_id * A + r_lo] = k_lo >= kAddBig ? -1 : k_lo;
        if (in_hi && r_hi < A)
          AL[new_id * A + r_hi] = k_hi >= kAddBig ? -1 : k_hi;
        if (lane == 0) NA[new_id] = min(nal + 1, A);
        __syncwarp();
        // append new_id to each member's list, counts read after that set
        const int mc_lo = clip(m_lo, 0, N - 1), mc_hi = clip(m_hi, 0, N - 1);
        const int n_lo = in_lo ? NA[mc_lo] : A;
        const int n_hi = in_hi ? NA[mc_hi] : A;
        __syncwarp();
        if (in_lo && m_lo >= 0 && n_lo < A) {
          AL[mc_lo * A + clip(n_lo, 0, A - 1)] = new_id;
          atomicAdd(NA + mc_lo, 1);
        }
        if (in_hi && m_hi >= 0 && n_hi < A) {
          AL[mc_hi * A + clip(n_hi, 0, A - 1)] = new_id;
          atomicAdd(NA + mc_hi, 1);
        }
      }
      ADD_SPLIT_MARK(2);
      if (need_new && !overflow_node) ++nc;

      // the edge prev -> target, weight min(w[prev_pos], w): where the
      // target is not the path's node, its coverage, pred count and first
      // 32 slots in one more round (the clique update wrote none of them)
      int32_t* pl = PR + (size_t)tc * P;
      int32_t* plw = PW + (size_t)tc * P;
      if (tc != node_c) {
        cov = lane == 0 ? C[tc] : 0;
        np_t = NP[tc];
        v0 = lane < P ? pl[lane] : 0;
        w0 = lane < P ? plw[lane] : 0;
      }
      bool overflow_edge = false;
      if (prev >= 0) {
        const int ew = min(prev_wt, wt);
        const int pc = clip(prev, 0, N - 1);
        const int n = min(P, np_t);
        int ex = -1, pos_ins = 0;
        for (int p0 = 0; p0 < n && ex < 0; p0 += 32) {
          const int p = p0 + lane;
          const int v = p0 == 0 ? v0 : (p < n ? pl[p] : 0);
          const unsigned eq = __ballot_sync(kFull, p < n && v == pc);
          pos_ins += __popc(__ballot_sync(kFull, p < n && v < pc));
          if (eq) ex = p0 + __ffs(eq) - 1;
        }
        if (ex >= 0) {  // its weight from the lane that holds it
          const int w_ex = __shfl_sync(kFull, w0, ex & 31);
          if (lane == 0) plw[ex] = (ex < 32 ? w_ex : plw[ex]) + ew;
        } else if (np_t >= P) {
          overflow_edge = true;
        } else {
          // slot pos_ins takes the new pred, each slot above it its lower
          // neighbour's: 32 slots at a time from the bottom, each chunk's old
          // values in registers before it is written, its top one carried
          int carry = 0, carry_w = 0;
          for (int p0 = 0; p0 < P; p0 += 32) {
            const int p = p0 + lane;
            const int o = p0 == 0 ? v0 : (p < P ? pl[p] : 0);
            const int ow = p0 == 0 ? w0 : (p < P ? plw[p] : 0);
            int up = __shfl_up_sync(kFull, o, 1);
            int up_w = __shfl_up_sync(kFull, ow, 1);
            if (lane == 0) {
              up = carry;
              up_w = carry_w;
            }
            carry = __shfl_sync(kFull, o, 31);
            carry_w = __shfl_sync(kFull, ow, 31);
            if (p < P && p >= pos_ins) {
              pl[p] = p == pos_ins ? pc : up;
              plw[p] = p == pos_ins ? ew : up_w;
            }
          }
          if (lane == 0) {
            NP[tc] = np_t + 1;
            atomicAdd(NS + pc, 1);  // no load to wait on
          }
        }
      }
      if (lane == 0) C[tc] = cov + wt;
      ADD_SPLIT_MARK(3);
      if (st == 0 && (overflow_node || overflow_clique)) st = kNodeOverflow;
      if (st == 0 && overflow_edge) st = kEdgeOverflow;
      if (prow && lane == 0) prow[clip(e_pos, 0, L - 1)] = target;
      prev = target;
      prev_wt = wt;
      __syncwarp();  // this step's writes before the next step's reads
      ADD_SPLIT_MARK(4);
    }
  }
  ADD_SPLIT_MARK(0);
  ADD_SPLIT_END(lane == 0);
}

}  // namespace cga
