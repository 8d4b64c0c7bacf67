// Device function of the add-alignment walk, shared by poa_add.cu (one
// launch per added sequence of the lockstep route) and poa_window.cu (the
// whole POA of a window in one block).  The rules are described in
// poa_add.cu.
#pragma once

#include "common.cuh"

namespace cga {

constexpr int kAddMaxMembers = 64;  // A + 1; the wrappers refuse a larger A
constexpr int kAddBig = 1 << 30;
constexpr int kNodeOverflow = 23;  // NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE
constexpr int kEdgeOverflow = 24;  // EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// One thread walks the path PN, PP (N + L each) from k0 and folds the
// sequence S with weights WT (L each) into the window's graph: B, C, NP, NS,
// NA (N), PR, PW (N * P), AL (N * A), in shared or device memory, updated in
// place, as are the node count nc and the status st.  prow, when not null,
// is the sequence's paths row (L), already cleared to -1.
__device__ inline void add_walk(const int32_t* PN, const int32_t* PP,
                                const int32_t* S, const int32_t* WT, int k0,
                                int32_t* B, int32_t* C, int32_t* NP,
                                int32_t* NS, int32_t* NA, int32_t* PR,
                                int32_t* PW, int32_t* AL, int& nc, int& st,
                                int32_t* prow, int N, int P, int A, int L,
                                int max_nodes) {
  const int TL = N + L;
  int prev = -1, prev_pos = -1;
  int mem[kAddMaxMembers], cur[kAddMaxMembers];

  for (int ix = max(k0, 0); ix < TL; ++ix) {
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
      for (int i = 0; i <= A; ++i) cur[i] = mem[i] >= 0 ? mem[i] : kAddBig;
      for (int i = 1; i <= A; ++i)
        for (int q = i; q > 0 && cur[q - 1] > cur[q]; --q) {
          const int t = cur[q];
          cur[q] = cur[q - 1];
          cur[q - 1] = t;
        }
      for (int a = 0; a < A; ++a)
        AL[new_id * A + a] = cur[a] >= kAddBig ? -1 : cur[a];
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
    if (prow) prow[clip(pos, 0, L - 1)] = target;
    prev = target;
    prev_pos = pos;
  }
}

}  // namespace cga
