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
// rows of the score plane, the serial traceback and walk, topsort's and the
// consensus's passes in rank order, the MSA's column chain.  What it saves
// is the traffic and the launches between them: one launch replaces about
// four per added sequence.  The
// first design (a block of at least 128 threads a window, the graph and a
// scratch region in shared memory, B5's first graph NW) fitted 3 windows an
// SM at the correction shape and 7 at the MSA shape, so a launch ran in 4-6
// waves of latency chains, at 1.7-1.9x the lockstep kernels' time (PERF.md,
// B10).
//
// Design (the plan comes from ops/poa_window.py window_plan):
// - A warp a window where a launch has many windows (several windows a
//   block, each its own warp: no block barrier anywhere, the windows leave
//   the sequence loop at their own s), else a block a window.  One kernel
//   body, a template on the group (poa_group.cuh); the phases' device
//   functions are templated the same way.
// - A window's graph (the node fields, pred and predw, alig, level, order,
//   rank), its path (pn, pp) and the phases' tables live in the window's
//   slice of a device scratch buffer that the wrapper allocates, the layout
//   the lockstep route keeps between its kernels; it stays in L1 and L2
//   during the window's life.  Shared memory holds only the graph NW's ring
//   of recent rows, two rows' facts, the sequence and four words of state:
//   a few KB a window, so 20 windows share an SM (a warp plan's registers
//   allow five blocks of four).
// - The topsort is the lockstep route's (poa_topsort.cuh topsort_warp): a
//   visit-order relaxation and a counting-sort rank on the group's first
//   warp, its tables in the window's phase tables, the hint the node count
//   before the last add.
// - The graph NW is B5's redesigned body (poa_nwtb.cuh): rows a warp or a
//   block wide, the move in a packed plane word (4 or 8 bytes, Word), a
//   one-load walk.  It reads the graph with plain loads, since this kernel
//   writes it between sequences (kLdg false).
// - The walk of the traceback runs on the group's thread 0, the add on its
//   first warp (poa_add.cuh, the lockstep route's device function).
// - The consensus and the MSA are the lockstep route's (poa_consensus.cuh
//   consensus_warp: the scores in one pass in rank order, confirmed;
//   poa_msa.cuh msa_warp: rank lists gathered 32 ranks at a time, then the
//   column chain on them), out-of-line calls on the group's first warp, their
//   tables in the window's phase tables.
// The wrapper counts the shared memory of a window (window_smem_bytes) and
// passes it; a count other than this kernel's layout is refused.  Built with
// CGA_WINDOW_SPLIT (chip_smoke.py --window-split), thread 0 of each window
// sums the SM cycles of each phase into a per-window record.

#include <algorithm>

#include "common.cuh"

#ifdef CGA_WINDOW_SPLIT
// per thread: the graph NW's marks (the forward pass's end, the end cell's),
// defined before poa_nwtb.cuh so that its marks record
__device__ long long* g_nw_marks;
#define CGA_NW_MARK(k)                                                    \
  (g_nw_marks[((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2 + (k)] = \
       clock64())
#endif

#include "poa_add.cuh"
#include "poa_consensus.cuh"
#include "poa_msa.cuh"
#include "poa_nwtb.cuh"
#include "poa_topsort.cuh"

namespace {

using namespace cga;

constexpr int kLoopExceeded = 25;  // LOOP_COUNT_EXCEEDED_UPPER_BOUND
constexpr int kBandExceeded = 28;  // EXCEEDED_BAND_WIDTH

// a window's four words of state in shared memory
constexpr int kNc = 0, kSt = 1, kK0 = 2, kBandOk = 3, kStateInts = 4;

#ifdef CGA_WINDOW_SPLIT
// per window: cycles of init, topsort, NW forward, NW end cell, walk, add,
// final topsort, consensus, MSA; then the sequences added and the rows
constexpr int kSplitSlots = 16;
__device__ long long* g_split;
struct Split {
  long long t, acc[kSplitSlots];
  __device__ void start() {
    t = clock64();
    for (int i = 0; i < kSplitSlots; ++i) acc[i] = 0;
  }
  __device__ void mark(int i) {
    const long long now = clock64();
    acc[i] += now - t;
    t = now;
  }
};
#define SPLIT_START() \
  Split split;        \
  if (gt == 0) split.start()
#define SPLIT_MARK(i) \
  if (gt == 0) split.mark(i)
#else
#define SPLIT_START() ((void)0)
#define SPLIT_MARK(i) ((void)0)
#endif

// the topsort of a window (poa_topsort.cuh), a call of its own: inlined,
// its tables' bookkeeping would add to the registers of the whole window
// loop, which __launch_bounds__ caps
__device__ __noinline__ int window_topsort(const int32_t* npred,
                                           const int32_t* pred, int nc,
                                           int nc_pre, int N, int P,
                                           int32_t* tables, int32_t* level,
                                           int32_t* order, int32_t* rank,
                                           int lane) {
  return topsort_warp(level, npred, pred, nc, nc_pre, N, P, tables, level,
                      order, rank, lane);
}

// the consensus and the MSA of a window (poa_consensus.cuh, poa_msa.cuh),
// calls of their own for the same reason, on the group's first warp, their
// tables in the window's phase tables
__device__ __noinline__ void window_consensus(
    const int32_t* npred, const int32_t* pred, const int32_t* predw,
    const int32_t* base, const int32_t* cov, const int32_t* rank, int nc,
    int32_t* codes, int32_t* covs, int32_t* length, int N, int P, int MC,
    int32_t* tables, int lane) {
  consensus_warp(npred, pred, predw, base, cov, rank, nc, codes, covs, length,
                 N, P, MC, tables, lane);
}

__device__ __noinline__ void window_msa(
    const int32_t* order, const int32_t* npred, const int32_t* nalig,
    const int32_t* base, const int32_t* pred, const int32_t* alig,
    const int32_t* paths, int nc, int32_t* rows, int32_t* n_cols, int N,
    int P, int A, int S, int L, int32_t* tables, int lane) {
  msa_warp(order, npred, nalig, base, pred, alig, paths, nc, rows, n_cols, N,
           P, A, S, L, tables, tables + N, lane);
}

// ints of a window's slice of the device scratch: the graph (5 node fields,
// level, order, rank, pred and predw, alig), the path pn and pp (N + L
// each), then the phases' tables, sized for the largest of topsort's,
// the consensus's and the MSA's (columns and rank lists)
__host__ long long window_slice_ints(int N, int P, int A, int L, int MC) {
  long long tables = topsort_table_ints(N);
  tables = std::max(tables, consensus_table_ints(N, MC));
  tables = std::max(tables, (long long)N + msa_list_ints(P, A));
  return (long long)N * (8 + 2 * P + A) + 2LL * (N + L) + tables;
}

struct Shape {
  int N, P, A, S, L, MC, max_nodes;
  long long slice;  // window_slice_ints
  int per;          // shared ints a window: nwtb_smem_ints + the state
};

#define WINDOW_PARAMS                                                       \
  const int32_t *__restrict__ seqs, const int32_t *__restrict__ weights,    \
      const int32_t *__restrict__ lens, const int32_t *__restrict__ n_seqs, \
      int32_t *__restrict__ graphs, Word *__restrict__ planes,              \
      int32_t *__restrict__ paths, int32_t *__restrict__ codes,             \
      int32_t *__restrict__ covs, int32_t *__restrict__ lengths,            \
      int32_t *__restrict__ statuses, int32_t *__restrict__ rows,           \
      int32_t *__restrict__ n_cols, int W, Shape sh, Dims d
#define WINDOW_ARGS                                                          \
  seqs, weights, lens, n_seqs, graphs, planes, paths, codes, covs, lengths, \
      statuses, rows, n_cols, W, sh, d

// kWarp: blockDim.x / 32 windows a block, one a warp; else one a block
template <bool kWarp, typename Word>
__device__ __forceinline__ void window_body(WINDOW_PARAMS) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int wtot[32];
  const int slot = kWarp ? threadIdx.x >> 5 : 0;
  const int w = kWarp ? blockIdx.x * (blockDim.x >> 5) + slot : blockIdx.x;
  if (w >= W) return;  // a whole warp (kWarp) or block leaves
  const int gt = kWarp ? threadIdx.x & 31 : threadIdx.x;
  const int gn = kWarp ? 32 : blockDim.x;
  SPLIT_START();
  const int N = sh.N, P = sh.P, A = sh.A, S = sh.S, L = sh.L, MC = sh.MC;
  const int TL = N + L;

  // the window's slice of the device scratch
  int32_t* base = graphs + (size_t)w * sh.slice;
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
  int32_t* pnw = alig + N * A;
  int32_t* ppw = pnw + TL;
  int32_t* tables = ppw + TL;
  // and of shared memory
  Word* ring = reinterpret_cast<Word*>(smem + (size_t)slot * sh.per);
  int32_t* facts = reinterpret_cast<int32_t*>(ring + d.R * d.RW);
  int8_t* sq = reinterpret_cast<int8_t*>(facts + 2 * (kRowPreds + 3 * P));
  int32_t* state = smem + (size_t)(slot + 1) * sh.per - kStateInts;

  const int32_t* SQ = seqs + (size_t)w * S * L;
  const int32_t* WT = weights + (size_t)w * S * L;
  const int32_t* LN = lens + (size_t)w * S;
  Word* plane = planes + (size_t)w * (N + 1) * (L + 1);
  int32_t* PT = paths == nullptr ? nullptr : paths + (size_t)w * S * L;
  const int ns = n_seqs[w];
  const int len0 = LN[0];

  // the graph of the first sequence: a chain, node u at level u
  for (int u = gt; u < N; u += gn) {
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
    for (int i = gt; i < S * L; i += gn) PT[i] = (i < L && i < len0) ? i : -1;
  if (gt == 0) {
    state[kNc] = len0;
    state[kSt] = len0 > sh.max_nodes ? kNodeOverflow : 0;
  }
  group_sync<kWarp>();
  SPLIT_MARK(0);

  // topsort runs on the group's first warp, its tables in the device
  // tables (dead between the phases that use them); nc_pre: the node count
  // the levels were computed for
  int nc_pre = state[kNc];
  int added = 0;
  for (int s = 1; s < S; ++s) {
    if (s >= ns || state[kSt] != 0) break;  // the same for the whole group
    const int nc = state[kNc];
    int changed = 0;
    if (gt < 32)
      changed = !window_topsort(npred, pred, nc, nc_pre, N, P, tables, level,
                                order, rank, gt);
    nc_pre = nc;
    for (int i = gt; i < L; i += gn) sq[i] = (int8_t)SQ[(size_t)s * L + i];
    group_sync<kWarp>();
    SPLIT_MARK(1);

    // pn and pp need no -2 fill: the add reads only the walk's steps
    Window<Word, false> win;
    win.seq = sq;
    win.order = order;
    win.rank = rank;
    win.npred = npred;
    win.base = base;
    win.nsucc = nsucc;
    win.pred = pred;
    win.plane = plane;
    win.ring = ring;
    win.rows = facts;
    win.slen = LN[s];
    win.nc = nc;
    win.nce = min(max(nc, 0), N);
    nwtb_window<kWarp>(win, d, gt, gn, wtot, pnw, ppw, state + kK0,
                       state + kBandOk);
    group_sync<kWarp>();
#ifdef CGA_WINDOW_SPLIT
    if (gt == 0) {  // the NW's marks split its time: forward, end cell, walk
      const long long* mk =
          g_nw_marks + ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2;
      const long long now = clock64();
      if (state[kBandOk]) {
        split.acc[2] += mk[0] - split.t;
        split.acc[3] += mk[1] - mk[0];
        split.acc[4] += now - mk[1];
      } else {
        split.acc[2] += now - split.t;
      }
      split.t = now;
      split.acc[10] += win.nce;
    }
#endif

    if (state[kBandOk]) {
      int32_t* prow = PT == nullptr ? nullptr : PT + (size_t)s * L;
      if (prow != nullptr) {
        for (int i = gt; i < L; i += gn) prow[i] = -1;
        group_sync<kWarp>();
      }
      if (gt < 32) {  // the group's first (or only) warp
        int ncv = nc, st = 0;
        add_walk(pnw, ppw, SQ + (size_t)s * L, WT + (size_t)s * L,
                 state[kK0], base, cov, npred, nsucc, nalig, pred, predw,
                 alig, ncv, st, prow, N, P, A, L, sh.max_nodes, gt);
        if (gt == 0) {
          state[kNc] = ncv;
          state[kSt] = changed ? kLoopExceeded : st;
        }
      }
    } else if (gt == 0) {
      state[kSt] = kBandExceeded;
    }
    group_sync<kWarp>();
    SPLIT_MARK(5);
    ++added;
  }

  // the final order, the consensus and the MSA
  const int nc = state[kNc];
  if (gt < 32)
    window_topsort(npred, pred, nc, nc_pre, N, P, tables, level, order, rank,
                   gt);
  group_sync<kWarp>();
  SPLIT_MARK(6);
  if (gt < 32)
    window_consensus(npred, pred, predw, base, cov, rank, nc,
                     codes + (size_t)w * MC, covs + (size_t)w * MC,
                     lengths + w, N, P, MC, tables, gt);
  group_sync<kWarp>();
  SPLIT_MARK(7);
  if (rows != nullptr && gt < 32)
    window_msa(order, npred, nalig, base, pred, alig, PT, nc,
               rows + (size_t)w * S * N, n_cols + w, N, P, A, S, L, tables,
               gt);
  SPLIT_MARK(8);
  if (gt == 0) statuses[w] = state[kSt];
#ifdef CGA_WINDOW_SPLIT
  if (gt == 0) {
    split.acc[9] = added;
    for (int i = 0; i < kSplitSlots; ++i)
      g_split[(size_t)w * kSplitSlots + i] = split.acc[i];
  }
#endif
}

// four windows a block of 128 threads; registers bounded so that five such
// blocks (20 windows) fit an SM: the whole window loop is one function, and
// unbounded its registers, not its shared memory, would set the windows an
// SM to fewer (PERF.md, B10)
template <typename Word>
__global__ void __launch_bounds__(128, 5)
    poa_window_warp_kernel(WINDOW_PARAMS) {
  window_body<true, Word>(WINDOW_ARGS);
}

// a block of 128 threads a window
template <typename Word>
__global__ void __launch_bounds__(128) poa_window_block_kernel(WINDOW_PARAMS) {
  window_body<false, Word>(WINDOW_ARGS);
}

// a block a window whose rows pass 512 columns may have up to 1,024 threads:
// bound its registers so that such a block always fits an SM
template <typename Word>
__global__ void __launch_bounds__(1024) poa_window_wide_kernel(WINDOW_PARAMS) {
  window_body<false, Word>(WINDOW_ARGS);
}

template <typename Word>
int launch(const void* const* in, void* graphs, void* plane,
           void* const* out, int W, const Shape& shape, const Dims& d,
           int group, int threads, long long smem_bytes,
           cudaStream_t stream) {
  Shape sh = shape;
  sh.per = (int)nwtb_smem_ints<Word>(d.R, d.RW, sh.P, sh.L, kStateInts);
  if (4LL * sh.per != smem_bytes) return (int)cudaErrorInvalidValue;
  const int windows = group == 0 ? threads / 32 : 1;
  const long long smem = 4LL * windows * sh.per;
  const int blocks = (W + windows - 1) / windows;
  auto kernel = group == 0      ? poa_window_warp_kernel<Word>
                : threads <= 128 ? poa_window_block_kernel<Word>
                                 : poa_window_wide_kernel<Word>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const auto i32 = [&](int k) { return static_cast<const int32_t*>(in[k]); };
  const auto o32 = [&](int k) { return static_cast<int32_t*>(out[k]); };
  kernel<<<blocks, threads, (size_t)smem, stream>>>(
      i32(0), i32(1), i32(2), i32(3), static_cast<int32_t*>(graphs),
      static_cast<Word*>(plane), o32(0), o32(1), o32(2), o32(3), o32(4),
      o32(5), o32(6), W, sh, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// seqs, weights (W, S, L), lens (W, S), n_seqs (W,) int32; graphs is a work
// buffer of W slices of window_slice_ints int32, plane one of W * (N + 1) *
// (L + 1) words of `word` bytes (4: int32, values in 24 bits; 8: int64), paths
// one of W * S * L int32; writes codes, covs (W, MC), length, status (W,),
// rows (W, S, N) and n_cols (W,) int32.  paths, rows and n_cols are null when
// no MSA is asked for.  group is 0 for a warp a window (`threads` / 32
// windows a block) and 1 for a block of `threads` a window; ring is R (0 or
// a power of two), rw the columns of a ring row.  smem_bytes is what the
// caller counted for one window's shared memory; a count other than the
// kernel's layout is refused.
extern "C" int cga_poa_window(const void* seqs, const void* weights,
                              const void* lens, const void* n_seqs,
                              void* graphs, void* plane, void* paths,
                              void* codes, void* covs, void* length,
                              void* status, void* rows, void* n_cols, int W,
                              int N, int P, int A, int S, int L, int MC,
                              int max_nodes, int match, int mismatch, int gap,
                              int band_width, int group, int threads,
                              int ring, int rw, int word, int smem_bytes,
                              void* stream) {
  if (A + 1 > kAddMaxMembers || threads < 32 || threads > 1024 ||
      threads % 32 || (ring & (ring - 1)) || (word != 4 && word != 8))
    return (int)cudaErrorInvalidValue;
  const Dims d{N, P, L, ring, rw, match, mismatch, gap, band_width / 2,
               band_width > 0};
  const Shape sh{N, P, A, S, L, MC, max_nodes,
                 window_slice_ints(N, P, A, L, MC), 0};
  const void* in[4] = {seqs, weights, lens, n_seqs};
  void* out[7] = {paths, codes, covs, length, status, rows, n_cols};
  const cudaStream_t s = (cudaStream_t)stream;
  return word == 8 ? launch<long long>(in, graphs, plane, out, W, sh, d, group,
                                       threads, smem_bytes, s)
                   : launch<int32_t>(in, graphs, plane, out, W, sh, d, group,
                                     threads, smem_bytes, s);
}

#ifdef CGA_WINDOW_SPLIT
// the split build's records: split (W x kSplitSlots int64), marks (2 int64
// a thread of the launch)
extern "C" int cga_poa_window_split_set(void* split, void* marks) {
  cudaError_t e = cudaMemcpyToSymbol(g_split, &split, sizeof(split));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_nw_marks, &marks, sizeof(marks));
  return (int)e;
}
#endif
