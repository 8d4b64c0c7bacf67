// Banded global edit distance (unit-cost Needleman-Wunsch) swept by query
// row, with an in-row min-plus prefix scan and a 2-bit packed traceback.
//
// Replaces: claragenomicsanalysis_tpu/ops/nw_band_pallas.py::_kernel, the
// TPU kernel behind banded_nw_pallas.  It computes the same function as
// csrc/nw_diag.cu (B1) in the other traceback layout; the output arrays have
// the JAX function's shapes and values on every row a problem reaches, so a
// traceback written by either package decodes with either package's decoder.
//
// Layout.  Row i (1..Lq) keeps W = round_up(2r + 1, 8) lanes; lane k holds
// cell (i, j = i + k - r), and the band |i - j| <= r is k <= 2r.  Row 0 is
// D[0, j] = j.  For a cell of row i
//     diag  D[i-1, j-1]  ->  row i - 1, lane k
//     up    D[i-1, j  ]  ->  row i - 1, lane k + 1
//     left  D[i,   j-1]  ->  row i,     lane k - 1
// so a row depends on itself through `left`: with tmp = min(diag, up + 1)
// (i at j = 0, INF outside the problem), D[i, k] = k + min_{l <= k}(tmp[l] -
// l), a min-plus prefix over the lanes.  tb[(i - 1) / 4, b, k] holds the
// codes of four rows, row i at bits 2 * ((i - 1) % 4), with the package's
// tie-break: diagonal, then DELETION (left + 1), else INSERTION.  int32 with
// INF = 2^30 and no saturation, as in the JAX kernel (fits16 = False).
//
// What bounds it on Hopper.  The work per cell is a handful of int32
// operations and the traceback written is W bytes per four rows per problem,
// far below the card's rates.  What bounds a problem is the chain: qlen
// dependent rows, each an in-row min-plus scan.  The first design ran a row
// as a block-wide scan with two barriers, its previous row in shared memory
// (about 1,036 SM cycles a row at r = 72, 35x its bound; PERF.md, B3).
//
// Design (the plan comes from ops/nw_row.py nw_row_plan):
// - A warp a problem where W <= 256 (band_warp.cuh): lane l holds the K
//   contiguous lanes l K .. l K + K - 1 of the row (K = ceil(W / 32), 1 to
//   8, a template picked per launch) in registers.  A row is: tmp of the K
//   slots (diag the slot's own previous value, up the next slot's, the last
//   slot's the next lane's first previous value), the lane's minimum of
//   tmp - k (a tree), an inclusive warp min-scan of the lane minima and its
//   exclusive shift, the K values from the carry and the lane's running
//   minimum, and the codes, `left` of the first slot from the previous lane
//   by one shuffle (kInf on lane 0).  The next row's `up` of the last slot
//   is the next lane's first value, min(its carry, its first tmp - k) + k,
//   and its carry is this lane's inclusive scan: so only its first tmp - k
//   crosses, by a shuffle issued before the scan, and a row's chain is the
//   scan's five shuffles and the exclusive shift.  No shared row and no
//   barrier.
// - A slot's column j = i + k - r advances by one a row, so the lane's K
//   target codes shift down a slot a row and one new code enters, loaded a
//   row before it is used, as the query code of the next row is: from the
//   warp's copy of q and t in shared memory where they fit, else through
//   the read-only cache (as nw_diag.cu's warp plan).
// - The K slots' codes are ORed into one register, byte k slot k's, and
//   stored every fourth row, one store a lane where K is a power of two
//   (store_lane_bytes); four rows are one unrolled step, so the codes' shift
//   is compile-time.  Several problems a block, one a warp.
// - W > 256 keeps the block body below: one thread block per problem, so
//   every barrier is a __syncthreads.  Each thread owns CPT contiguous lanes
//   (CPT the least power of two that covers W with at most 1,024 threads; W
//   reaches 4,104 when banded-escalate widens r on short reads).  A row is
//   two passes over the thread's lanes:
//   1. from the previous row in shared memory, tmp and the thread's own
//      minimum of tmp - k; an inclusive __shfl_up_sync scan over the warp's
//      thread minima; each warp's total to shared memory; barrier;
//   2. each warp's carry (a shuffle reduction over the totals of the warps
//      before it); the thread recomputes tmp lane by lane from the carry
//      and writes the row's values over the previous row in place (the one
//      value of the previous row it would lose, its right neighbour's first
//      lane, it read in pass 1); the codes of every lane but its first, whose
//      left neighbour belongs to the thread before; barrier; the first
//      lane's code.
//   The previous row lives in one shared int32 buffer of W + 1 (an INF
//   sentinel at W), the problem's query and target in shared memory.  Each
//   lane's four 2-bit codes are OR-accumulated in a register (four lanes a
//   word) and stored once every four rows.  Two variants of the one body
//   (template kShared): the shared variant keeps the row, q and t in shared
//   memory, 4 (W + 1) + Lq + Lt bytes beside the 128 of the warp totals;
//   past the 227 KB a block can have (the W = 65,672 of pairs whose lengths
//   differ by more than 16,384, or long reads) the device variant keeps the
//   row in a scratch slice of 4 (W + 1) bytes a problem, reads q and t
//   through L1 (__ldg) and ORs each row's codes into the traceback byte in
//   device memory.  A thread owns CPT x G contiguous lanes (CPT = 1, 2, 4 or
//   8), G lane groups of CPT: G = 1 in the shared variant, which keeps a
//   lane's codes in registers and so takes W <= 8,192; the device variant
//   takes any width.
// Every plan stops a problem at its own last packed row (round_up(qlen, 4))
// and writes zeros to the rows it does not reach; the plain PyTorch version
// in ops/nw_row.py defines the same output.

#include <climits>

#include "band_warp.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// a base of q or t: staged in shared memory, or read through L1
template <bool kShared>
__device__ __forceinline__ int base_at(const int8_t* s, int p) {
  if constexpr (kShared) return s[p];
  return __ldg(s + p);
}

__device__ __forceinline__ int warp_scan_min(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = min(v, n);
  }
  return v;
}

__device__ __forceinline__ int warp_reduce_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tmp of lane k of row i from the previous row's diag (`pd`) and up (`pu`)
// values; also returns the cell's validity, substitution cost and diag sum.
struct Cell {
  int tmp, diag, sub;
  bool valid;
};

template <bool kShared>
__device__ __forceinline__ Cell cell(int i, int k, int pd, int pu, int qc,
                                     const int8_t* ts, int Lt, int r,
                                     int qlen, int tlen) {
  const int j = i + k - r;
  Cell c;
  c.valid = j >= 0 && j <= tlen && i <= qlen && k <= 2 * r;
  // an unknown base (N, code -1) never matches, not even another N
  const int tc = (j >= 1 && j <= Lt) ? base_at<kShared>(ts, j - 1) : -1;
  c.sub = (qc == tc && qc >= 0) ? 0 : 1;
  c.diag = pd + c.sub;
  int tmp = min(c.diag, pu + 1);
  if (j == 0) tmp = i;  // column 0
  c.tmp = c.valid ? tmp : cga::kInf;
  return c;
}

__device__ __forceinline__ int move_code(int cur, int diag, int sub,
                                         int left) {
  return (cur == diag) ? sub
                       : (cur == left + 1 ? cga::kDeletion : cga::kInsertion);
}

template <int CPT, bool kShared>
__device__ __forceinline__ void nw_row_body(
    const int8_t* __restrict__ q, const int32_t* __restrict__ qlens,
    const int8_t* __restrict__ t, const int32_t* __restrict__ tlens,
    int32_t* __restrict__ scores, uint8_t* __restrict__ tb,
    int32_t* __restrict__ scratch, int B, int Lq, int Lt, int r, int W,
    int R4, int G) {
  constexpr int kWords = (CPT + 3) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  // a total per warp: in the shared variant right after the row, where the
  // dynamic block has always kept it (a static array there ran 3-4 % slower
  // on an H100), else a static array
  __shared__ int32_t wtot_static[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int qlen = qlens[b];
  const int tlen = tlens[b];
  // the previous row, W lanes + INF at W: shared memory, or this problem's
  // slice of the device scratch
  int32_t* row = kShared ? reinterpret_cast<int32_t*>(smem)
                         : scratch + (size_t)b * (W + 1);
  const int8_t* qs = q + (size_t)b * Lq;
  const int8_t* ts = t + (size_t)b * Lt;
  int32_t* wtot = kShared ? row + W + 1 : wtot_static;
  if constexpr (kShared) {
    int8_t* qsh = reinterpret_cast<int8_t*>(wtot + 32);
    int8_t* tsh = qsh + Lq;
    for (int p = tid; p < Lq; p += nt) qsh[p] = qs[p];
    for (int p = tid; p < Lt; p += nt) tsh[p] = ts[p];
    qs = qsh;
    ts = tsh;
  }
  // lane groups of CPT lanes a thread: one in the shared variant, where
  // every lane index and neighbour test below is then a compile-time
  // expression of c, as in a kernel without groups
  const int groups = kShared ? 1 : G;
  const int span = CPT * groups;  // contiguous lanes this thread owns
  const int k0 = tid * span;

  for (int k = tid; k <= W; k += nt) {
    const int j = k - r;  // row 0: D[0, j] = j inside the band
    row[k] = (k < W && j >= 0 && j <= tlen && k <= 2 * r) ? j : cga::kInf;
  }
  const int dl = qlen > tlen ? qlen - tlen : tlen - qlen;
  const bool band_ok = dl <= r;
  const int kf = r + tlen - qlen;  // the lane of (qlen, tlen)
  // row 0 holds the score when qlen == 0; otherwise row qlen overwrites it
  if (tid == 0) scores[b] = band_ok ? (qlen == 0 ? tlen : 0) : cga::kInf;
  const int rows_end = (qlen + 3) & ~3;  // <= 4 * R4
  uint32_t acc[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) acc[w] = 0;
  __syncthreads();

  for (int i = 1; i <= rows_end; ++i) {
    const int qc = (i <= Lq) ? base_at<kShared>(qs, i - 1) : -1;
    const int shift = 2 * ((i - 1) & 3);
    // the traceback row of this query row's byte (the shared variant
    // computes it only where it stores, every fourth row)
    const auto tb_row = [&]() {
      return tb + ((size_t)((i - 1) >> 2) * B + b) * W;
    };

    // pass 1: the thread's minimum of tmp - k over its lanes
    int mine = INT_MAX;
    int pd = (k0 < W) ? row[k0] : cga::kInf;
    for (int g = 0; g < (kShared ? 1 : groups); ++g) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int k = kShared ? k0 + c : k0 + g * CPT + c;
        if (k < W) {
          const int pu = row[k + 1];
          mine = min(mine, cell<kShared>(i, k, pd, pu, qc, ts, Lt, r, qlen,
                                         tlen).tmp - k);
          pd = pu;
        }
      }
    }
    const int pu_last = pd;  // the right neighbour's first previous value
    const int incl = warp_scan_min(mine, lane);
    int excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = INT_MAX;
    if (lane == 31) wtot[wid] = incl;
    __syncthreads();

    // pass 2: the carry from the warps before, then the row in place
    const int carry = warp_reduce_min(lane < wid ? wtot[lane] : INT_MAX);
    int run = min(carry, excl);
    int left = cga::kInf, cur0 = cga::kInf, diag0 = 0, sub0 = 0;
    pd = (k0 < W) ? row[k0] : cga::kInf;
    for (int g = 0; g < (kShared ? 1 : groups); ++g) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int k = kShared ? k0 + c : k0 + g * CPT + c;
        if (k < W) {
          const bool inner = kShared ? c + 1 < CPT : k + 1 < k0 + span;
          const int pu = inner ? row[k + 1] : pu_last;
          const Cell x =
              cell<kShared>(i, k, pd, pu, qc, ts, Lt, r, qlen, tlen);
          run = min(run, x.tmp - k);
          const int cur = x.valid ? run + k : cga::kInf;
          if (kShared ? c == 0 : k == k0) {
            cur0 = cur;
            diag0 = x.diag;
            sub0 = x.sub;
          } else {
            const uint32_t code = move_code(cur, x.diag, x.sub, left);
            if constexpr (kShared)
              acc[c >> 2] |= code << (8 * (c & 3) + shift);
            else {
              uint8_t* out = tb_row();
              out[k] = (uint8_t)((shift ? out[k] : 0) | (code << shift));
            }
          }
          if (i == qlen && k == kf && band_ok) scores[b] = cur;
          row[k] = cur;
          left = cur;
          pd = pu;
        }
      }
    }
    __syncthreads();

    if (k0 < W) {
      const int left0 = (k0 > 0) ? row[k0 - 1] : cga::kInf;
      const uint32_t code = move_code(cur0, diag0, sub0, left0);
      if constexpr (kShared) {
        acc[0] |= code << shift;
      } else {
        uint8_t* out = tb_row();
        out[k0] = (uint8_t)((shift ? out[k0] : 0) | (code << shift));
      }
    }
    if constexpr (kShared) {
      if (shift == 6) {
        uint8_t* out = tb_row();
        if constexpr (CPT >= 4) {  // k0 and W are multiples of 4: words
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            if (k0 + 4 * w < W)
              reinterpret_cast<uint32_t*>(out + k0)[w] = acc[w];
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            if (k0 + c < W) out[k0 + c] = (uint8_t)(acc[0] >> (8 * c));
        }
#pragma unroll
        for (int w = 0; w < kWords; ++w) acc[w] = 0;
      }
    }
  }

  for (int rr = rows_end >> 2; rr < R4; ++rr)
    for (int k = tid; k < W; k += nt) tb[((size_t)rr * B + b) * W + k] = 0;
}

#define NW_ROW_PARAMS                                                        \
  const int8_t *__restrict__ q, const int32_t *__restrict__ qlens,           \
      const int8_t *__restrict__ t, const int32_t *__restrict__ tlens,       \
      int32_t *__restrict__ scores, uint8_t *__restrict__ tb,                \
      int32_t *__restrict__ scratch, int B, int Lq, int Lt, int r, int W,    \
      int R4, int G

template <int CPT>
__global__ void nw_row_shared(NW_ROW_PARAMS) {
  nw_row_body<CPT, true>(q, qlens, t, tlens, scores, tb, scratch, B, Lq, Lt,
                         r, W, R4, G);
}

// the device variant runs up to 1,024 threads at any width: bound its
// registers so that such a block always fits an SM
template <int CPT>
__global__ void __launch_bounds__(kMaxThreads) nw_row_device(NW_ROW_PARAMS) {
  nw_row_body<CPT, false>(q, qlens, t, tlens, scores, tb, scratch, B, Lq,
                          Lt, r, W, R4, G);
}

// ------------------------------------------------------- a warp a problem

// One problem's rows by one warp, K band lanes a lane: slot c of this lane
// is band lane k = u0 + c, cell (i, j = i + k - r) on row i.
template <int K, bool kStaged>
struct WarpRows {
  const int8_t* qs;
  const int8_t* ts;
  uint8_t* tb;        // this lane's first byte of traceback row 0
  size_t row_stride;  // bytes from one traceback row to the next (B W)
  int Lq, Lt, r, qlen, tlen, u0, nreal, kf;
  int jt0;            // the column of slot 0 on the current row
  int prev[K];        // the previous row's values
  int nup;            // the next lane's first previous value: slot K - 1's up
  int tv[K];          // the target codes of the slots' cells on this row
  int qc;             // the query code of this row
  cga::Fetch nq, nt;  // the next row's query code and entering target code
  typename cga::LaneBytes<K>::T acc;
  int score;

  // row 0 (D[0, j] = j inside the band) and the codes of row 1
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int k = u0 + c;
      const int j = k - r;
      prev[c] = (k <= 2 * r && j >= 0 && j <= tlen) ? j : cga::kInf;
    }
    nup = cga::from_next_lane<K>(prev, cga::kInf);
    jt0 = 1 + u0 - r;
#pragma unroll
    for (int c = 0; c < K; ++c)
      tv[c] = cga::t_code(cga::fetch<kStaged>(ts, jt0 + c, Lt));
    qc = cga::q_code(cga::fetch<kStaged>(qs, 1, Lq));
    nq = cga::fetch<kStaged>(qs, 2, Lq);
    nt = cga::fetch<kStaged>(ts, jt0 + K, Lt);
    acc = 0;
    score = 0;
  }

  // row i, its codes at bits SH of each slot's byte
  template <int SH>
  __device__ __forceinline__ void step(int i) {
    const int lane = threadIdx.x & 31;
    int up[K];
#pragma unroll
    for (int c = 0; c + 1 < K; ++c) up[c] = prev[c + 1];
    up[K - 1] = nup;
    // the slots whose cell lies in the problem and the band: c in
    // [klo, khi] on a row i <= qlen
    const int klo = -jt0;
    const int khi = i <= qlen ? min(tlen - jt0, 2 * r - u0) : -1;
    int diag[K], sub[K], y[K], t[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      sub[c] = qc != tv[c];
      diag[c] = prev[c] + sub[c];
      int x = min(diag[c], up[c] + 1);
      if (jt0 + c == 0) x = i;  // column 0
      if (c < klo || c > khi) x = cga::kInf;
      y[c] = x - (u0 + c);
      t[c] = y[c];
    }
    // the lane's minimum of tmp - k by a tree (its running minimum is off
    // the scan's chain)
#pragma unroll
    for (int h = 1; h < K; h <<= 1)
#pragma unroll
      for (int c = 0; c + h < K; c += 2 * h) t[c] = min(t[c], t[c + h]);
    // the next lane's first tmp - k, for the next row's `up` of slot K - 1:
    // that lane's carry is this lane's inclusive scan, so the value needs
    // no shuffle after the scan (INT_MIN: outside the band)
    const int r0 = __shfl_down_sync(
        cga::kFull, (klo <= 0 && 0 <= khi) ? y[0] : INT_MIN, 1);
    // the lane minima's inclusive min-scan over the warp (a lane below o
    // reads its own value), then the carry from the lanes before
    int incl = t[0];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      incl = min(incl, __shfl_up_sync(cga::kFull, incl, o));
    int excl = __shfl_up_sync(cga::kFull, incl, 1);
    if (lane == 0) excl = INT_MAX;
    nup = (lane == 31 || r0 == INT_MIN) ? cga::kInf
                                        : min(incl, r0) + u0 + K;
    int cur[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {  // y becomes the lane's running minimum
      if (c > 0) y[c] = min(y[c], y[c - 1]);
      cur[c] = (c < klo || c > khi) ? cga::kInf : min(excl, y[c]) + u0 + c;
    }
    const int left0 = cga::from_prev_lane<K>(cur, cga::kInf);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int left = c > 0 ? cur[c - 1] : left0;
      const int code = move_code(cur[c], diag[c], sub[c], left);
      acc |= (typename cga::LaneBytes<K>::T)code << (8 * c + SH);
    }
    if (i == qlen) {
#pragma unroll
      for (int c = 0; c < K; ++c)
        if (u0 + c == kf) score = cur[c];
    }
    if constexpr (SH == 6) {
      if (nreal > 0)
        cga::store_lane_bytes<K>(tb + (size_t)((i - 1) >> 2) * row_stride,
                                 acc, nreal);
      acc = 0;
    }
#pragma unroll
    for (int c = 0; c < K; ++c) prev[c] = cur[c];
    // into row i + 1: every column advances (the target codes shift down a
    // slot, one entering); the entering codes were loaded a row ago, the
    // next ones are issued now
    ++jt0;
#pragma unroll
    for (int c = 0; c + 1 < K; ++c) tv[c] = tv[c + 1];
    tv[K - 1] = cga::t_code(nt);
    nt = cga::fetch<kStaged>(ts, jt0 + K, Lt);
    qc = cga::q_code(nq);
    nq = cga::fetch<kStaged>(qs, i + 2, Lq);
  }
};

// stage: bytes of shared memory a warp's copy of q and t takes (0 when they
// are read through the read-only cache)
template <int K, bool kStaged>
__global__ void nw_row_warp_kernel(const int8_t* __restrict__ q,
                                   const int32_t* __restrict__ qlens,
                                   const int8_t* __restrict__ t,
                                   const int32_t* __restrict__ tlens,
                                   int32_t* __restrict__ scores,
                                   uint8_t* __restrict__ tb, int B, int Lq,
                                   int Lt, int r, int W, int R4, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + slot;
  if (b >= B) return;  // the whole warp
  WarpRows<K, kStaged> s;
  s.qs = q + (size_t)b * Lq;
  s.ts = t + (size_t)b * Lt;
  if constexpr (kStaged) {
    int8_t* qsh = reinterpret_cast<int8_t*>(smem + (size_t)slot * stage);
    int8_t* tsh = qsh + cga::stage_len(Lq);
    for (int p = lane; p < Lq; p += 32) qsh[p] = s.qs[p];
    for (int p = lane; p < Lt; p += 32) tsh[p] = s.ts[p];
    __syncwarp();
    s.qs = qsh;
    s.ts = tsh;
  }
  s.Lq = Lq;
  s.Lt = Lt;
  s.r = r;
  s.qlen = qlens[b];
  s.tlen = tlens[b];
  s.u0 = cga::lane_slot0<K>();
  s.nreal = min(K, W - s.u0);
  s.row_stride = (size_t)B * W;
  s.tb = tb + (size_t)b * W + s.u0;
  const int dl = s.qlen > s.tlen ? s.qlen - s.tlen : s.tlen - s.qlen;
  const bool band_ok = dl <= r;
  s.kf = band_ok ? r + s.tlen - s.qlen : -1;  // the lane of (qlen, tlen)
  const int rows_end = (s.qlen + 3) & ~3;      // <= 4 R4
  s.start();
  for (int i = 1; i <= rows_end; i += 4) {
    s.template step<0>(i);
    s.template step<2>(i + 1);
    s.template step<4>(i + 2);
    s.template step<6>(i + 3);
  }
  // row 0 holds the score when qlen == 0; otherwise row qlen set it
  if (lane == (band_ok ? s.kf / K : 0))
    scores[b] = band_ok ? (s.qlen == 0 ? s.tlen : s.score) : cga::kInf;
  if (s.nreal > 0)
    for (int rr = rows_end >> 2; rr < R4; ++rr)
      cga::store_lane_bytes<K>(s.tb + (size_t)rr * s.row_stride, 0,
                               s.nreal);
}

template <int K>
int launch_warp(const void* q, const void* qlen, const void* t,
                const void* tlen, void* scores, void* tb, int B, int Lq,
                int Lt, int r, int W, int R4, int problems, bool staged,
                cudaStream_t stream) {
  const int stage = staged ? cga::stage_len(Lq) + cga::stage_len(Lt) : 0;
  const long long smem = (long long)problems * stage;
  auto kernel = staged ? nw_row_warp_kernel<K, true>
                       : nw_row_warp_kernel<K, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + problems - 1) / problems, 32 * problems, (size_t)smem,
           stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int32_t*>(qlen),
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tlen),
      static_cast<int32_t*>(scores), static_cast<uint8_t*>(tb), B, Lq, Lt, r,
      W, R4, stage);
  return (int)cudaGetLastError();
}

template <int CPT>
int launch(const void* q, const void* qlen, const void* t, const void* tlen,
           void* scores, void* tb, void* scratch, int B, int Lq, int Lt,
           int r, int W, int R4, int G, cudaStream_t stream) {
  const int span = CPT * G;
  const int threads = ((W + span - 1) / span + 31) / 32 * 32;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  auto go = [&](auto kernel, size_t smem) {
    kernel<<<B, threads, smem, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int32_t*>(qlen),
        static_cast<const int8_t*>(t), static_cast<const int32_t*>(tlen),
        static_cast<int32_t*>(scores), static_cast<uint8_t*>(tb),
        static_cast<int32_t*>(scratch), B, Lq, Lt, r, W, R4, G);
  };
  if (scratch != nullptr) {
    go(nw_row_device<CPT>, 0);
    return (int)cudaGetLastError();
  }
  // the row (W + 1 int32), the warp totals, then q and t (the wrapper
  // picks this variant only where the whole fits a block)
  const long long smem = 4LL * (W + 1) + 128 + Lq + Lt;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_row_shared<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  go(nw_row_shared<CPT>, (size_t)smem);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 is success).  q (B, Lq) and t (B, Lt) are int8 codes with -1 PAD,
// qlen and tlen (B,) int32, scores (B,) int32, tb (R4, B, W) int8 with
// R4 = round_up(Lq, 16) / 4 and W = round_up(2r + 1, 8).  The plan
// (ops/nw_row.py nw_row_plan): K in 1..8 runs a warp a problem, K band
// lanes a lane (32 K >= W), n problems a block, with q and t in shared
// memory when `staged`, else read through the read-only cache (scratch
// null); K = 0 runs a block a problem, a thread owning cpt x n lanes (cpt 1,
// 2, 4 or 8; n lane groups), its shared variant when `staged` (scratch null,
// n = 1), else its device variant on `scratch`, 4 (W + 1) bytes a problem.
extern "C" int cga_nw_row(const void* q, const void* qlen, const void* t,
                          const void* tlen, void* scores, void* tb,
                          void* scratch, int B, int Lq, int Lt, int r, int W,
                          int R4, int K, int cpt, int n, int staged,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K != 0) {
    if (32 * K < W || n < 1 || n > 32 || scratch != nullptr ||
        (!staged && (Lq < 1 || Lt < 1)))
      return (int)cudaErrorInvalidValue;
    switch (K) {
#define CGA_NW_ROW_K(k)                                                     \
  case k:                                                                   \
    return launch_warp<k>(q, qlen, t, tlen, scores, tb, B, Lq, Lt, r, W,    \
                          R4, n, staged, s);
      CGA_NW_ROW_K(1)
      CGA_NW_ROW_K(2)
      CGA_NW_ROW_K(3)
      CGA_NW_ROW_K(4)
      CGA_NW_ROW_K(5)
      CGA_NW_ROW_K(6)
      CGA_NW_ROW_K(7)
      CGA_NW_ROW_K(8)
#undef CGA_NW_ROW_K
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (n < 1 || (scratch == nullptr) != (staged != 0) ||
      (scratch == nullptr && n != 1))
    return (int)cudaErrorInvalidValue;
  switch (cpt) {
    case 1:
      return launch<1>(q, qlen, t, tlen, scores, tb, scratch, B, Lq, Lt, r,
                       W, R4, n, s);
    case 2:
      return launch<2>(q, qlen, t, tlen, scores, tb, scratch, B, Lq, Lt, r,
                       W, R4, n, s);
    case 4:
      return launch<4>(q, qlen, t, tlen, scores, tb, scratch, B, Lq, Lt, r,
                       W, R4, n, s);
    case 8:
      return launch<8>(q, qlen, t, tlen, scores, tb, scratch, B, Lq, Lt, r,
                       W, R4, n, s);
    default:
      return (int)cudaErrorInvalidValue;  // not an instantiated width
  }
}
