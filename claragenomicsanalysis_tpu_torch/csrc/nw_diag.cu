// Banded global edit distance (unit-cost Needleman-Wunsch) swept by
// anti-diagonal, with a 2-bit packed traceback.
//
// Replaces: claragenomicsanalysis_tpu/ops/nw_diag_pallas.py::_kernel, the
// TPU kernel behind banded_nw_diag_pallas.  The output arrays have the same
// shapes, layout and values on every cell a traceback can reach, so a
// traceback written by either package decodes with either package's decoder.
//
// Layout.  Cell (i, j) lies on anti-diagonal d = i + j.  With
// par = (d + r) & 1 it sits in half-band slot u' = (j - i + r - par) / 2, so
// i = (d + r) / 2 - u' and j = d - i.  The band |i - j| <= r is u' <= r for
// par 0 and u' <= r - 1 for par 1; W = round_up(r + 1, 8) slots are kept.
// tb[d / 4, b, u'] holds the codes of four diagonals, diagonal d at bits
// 2 * (d % 4).  The dependencies of (d, u') are
//     diag  D[i-1, j-1]  ->  (d - 2, u')
//     up    D[i-1, j  ]  ->  (d - 1, u' + par)
//     left  D[i,   j-1]  ->  (d - 1, u' + par - 1)
// so every cell of a diagonal is independent of the others.  The tie-break is
// the package's canonical one: diagonal, then DELETION (left + 1), else
// INSERTION.
//
// What bounds it on Hopper.  The work is integer and tiny per cell (a 3-way
// min and a few compares); the traceback written is W bytes per four
// diagonals per problem, far below device-memory bandwidth.  What bounds a
// problem is the chain of diagonals: each depends on the previous two, so a
// problem takes qlen + tlen dependent steps.  A block a problem with a
// barrier a diagonal (the first design, kept below for wide bands) ran a
// diagonal in about 476 SM cycles at r = 72 with 3.4 blocks an SM, nothing
// hiding the chain (PERF.md, B1).
//
// Design (the plan comes from ops/nw_diag.py nw_diag_plan):
// - A warp a problem where W <= 256 (band_warp.cuh): lane l holds the K
//   contiguous slots l K .. l K + K - 1 (K = ceil(W / 32), 1 to 8, a
//   template picked per launch) of diagonals d - 1 and d - 2 in registers.  par alternates
//   each diagonal, so a diagonal needs exactly one value from the next lane
//   (par 1, `up` of the lane's last slot) or the previous one (par 0, `left`
//   of its first), one shuffle, kInf past the band's ends; no shared
//   diagonal and no barrier.  Four diagonals are one unrolled step, so par
//   and the code's shift are compile-time.
// - A slot's i and j each advance by one every second diagonal, so the
//   lane's K query and K target codes shift by one slot a diagonal, one new
//   code entering, loaded two diagonals before it is used: from the warp's
//   copy of q and t in shared memory where they fit, else through the
//   read-only cache.
// - The K slots' codes are ORed into one register, byte k slot k's, and
//   stored every fourth diagonal, one store a lane where K is a power of two;
//   only the W real slots are written, and the rows past the problem's last
//   diagonal are zeros as before.
// - The top row's cells (i = 0) need no rule of their own past (0, 0):
//   their up and diagonal neighbours lie outside the matrix (INF), so the
//   3-way min gives j; only diagonal 0 sets (0, 0) = 0.
// - Several problems a block (one a warp), so a short problem (Hirschberg's
//   32 x 32 base cases) fills whole blocks.
// - W > 256 keeps the block body below: one thread block a problem, threads
//   striding over the W slots, diagonals d - 1 and d - 2 as int32 in shared
//   memory (d - 2 read only at the thread's own slot, so diagonal d
//   overwrites it in place, one barrier a diagonal), q and t staged in shared
//   memory, codes OR-accumulated in a shared byte a slot.  Its shared variant
//   keeps 9W + Lq + Lt bytes a block; past the 227 KB a block can have, its
//   device variant keeps the diagonals and code bytes in a scratch slice of
//   9W bytes a problem that the wrapper allocates and reads q and t through
//   the read-only cache (__ldg).  The rules are the same code (template
//   kShared).
// A problem stops at its own last diagonal (round_up(qlen + tlen + 1, 4))
// rather than the batch's padded one and writes zeros to the traceback rows
// it does not reach; the plain PyTorch version in ops/nw_diag.py defines the
// same output.

#include "band_warp.cuh"

namespace {

// a base of q or t: staged in shared memory, or read through L1
template <bool kShared>
__device__ __forceinline__ int base_at(const int8_t* s, int p) {
  if constexpr (kShared) return s[p];
  return __ldg(s + p);
}

template <bool kShared>
__global__ void nw_diag_kernel(const int8_t* __restrict__ q,
                               const int32_t* __restrict__ qlens,
                               const int8_t* __restrict__ t,
                               const int32_t* __restrict__ tlens,
                               int32_t* __restrict__ scores,
                               uint8_t* __restrict__ tb,
                               unsigned char* __restrict__ scratch, int B,
                               int Lq, int Lt, int r, int W, int Dpad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // two int32 diagonals and a code byte per slot: shared memory, or this
  // problem's 9W bytes of the device scratch
  unsigned char* area = kShared ? smem : scratch + (size_t)b * 9 * W;
  int32_t* prev1 = reinterpret_cast<int32_t*>(area);  // diagonal d - 1
  int32_t* prev2 = prev1 + W;                         // diagonal d - 2
  uint8_t* acc = reinterpret_cast<uint8_t*>(prev2 + W);
  const int8_t* qs = q + (size_t)b * Lq;
  const int8_t* ts = t + (size_t)b * Lt;
  if constexpr (kShared) {
    int8_t* qsh = reinterpret_cast<int8_t*>(acc + W);
    int8_t* tsh = qsh + Lq;
    for (int p = tid; p < Lq; p += nt) qsh[p] = qs[p];
    for (int p = tid; p < Lt; p += nt) tsh[p] = ts[p];
    qs = qsh;
    ts = tsh;
  }
  const int qlen = qlens[b];
  const int tlen = tlens[b];

  for (int u = tid; u < W; u += nt) {
    prev1[u] = cga::kInf;
    prev2[u] = cga::kInf;
    acc[u] = 0;
  }

  const int dl = qlen > tlen ? qlen - tlen : tlen - qlen;
  const bool band_ok = dl <= r;
  // the cell (qlen, tlen) overwrites this in the loop when the band holds it
  if (tid == 0) scores[b] = band_ok ? 0 : cga::kInf;

  // diagonals this problem needs, rounded to whole traceback bytes
  long long d_need = ((long long)qlen + tlen + 1 + 3) & ~3LL;
  const int d_end = (int)(d_need < 0 ? 0 : (d_need > Dpad ? Dpad : d_need));
  __syncthreads();

  for (int d = 0; d < d_end; ++d) {
    const int par = (d + r) & 1;
    const int i_top = (d + r) >> 1;
    const int shift = 2 * (d & 3);
    for (int u = tid; u < W; u += nt) {
      const int i = i_top - u;
      const int j = d - i;
      const bool valid =
          i >= 0 && i <= qlen && j >= 0 && j <= tlen && u <= r - par;
      // an unknown base (N, code -1) never matches, not even another N
      const int qc = (i >= 1 && i <= Lq) ? base_at<kShared>(qs, i - 1) : -1;
      const int tc = (j >= 1 && j <= Lt) ? base_at<kShared>(ts, j - 1) : -1;
      const int sub = (qc == tc && qc >= 0) ? 0 : 1;
      int up, left;
      if (par) {
        up = (u + 1 < W) ? prev1[u + 1] : cga::kInf;
        left = prev1[u];
      } else {
        up = prev1[u];
        left = (u >= 1) ? prev1[u - 1] : cga::kInf;
      }
      const int diag = prev2[u] + sub;
      int cur = min(diag, min(up, left) + 1);
      if (i == 0) cur = j;  // top boundary; column 0 comes from INF alone
      if (!valid) cur = cga::kInf;
      const int code =
          (cur == diag) ? sub : (cur == left + 1 ? cga::kDeletion
                                                 : cga::kInsertion);
      uint8_t a = acc[u] | (uint8_t)(code << shift);
      if (shift == 6) {
        tb[((size_t)(d >> 2) * B + b) * W + u] = a;
        a = 0;
      }
      acc[u] = a;
      if (band_ok && valid && i == qlen && j == tlen) scores[b] = cur;
      prev2[u] = cur;  // diagonal d replaces d - 2 at this thread's own slot
    }
    __syncthreads();
    int32_t* tmp = prev1;
    prev1 = prev2;
    prev2 = tmp;
  }

  for (int row = d_end >> 2; row < (Dpad >> 2); ++row)
    for (int u = tid; u < W; u += nt) tb[((size_t)row * B + b) * W + u] = 0;
}

// ------------------------------------------------------- a warp a problem

// One problem's sweep by one warp, K slots a lane.  Slot k of this lane is
// u = l K + k: on diagonal d it holds cell (i, j) = (iq0 - k, jt0 + k) with
// iq0 = (d + r) / 2 - l K and jt0 = d - iq0.
template <int K, bool kStaged>
struct WarpSweep {
  const int8_t* qs;
  const int8_t* ts;
  uint8_t* tb;        // this problem's column of the traceback
  size_t row_stride;  // bytes from one traceback row to the next (B W)
  int Lq, Lt, r, qlen, tlen, u0;
  int nreal;          // this lane's slots inside the W real ones
  int iq0, jt0;
  int p1[K], p2[K];   // diagonals d - 1 and d - 2
  int qv[K], tv[K];   // the codes of the slots' cells on diagonal d
  cga::Fetch nq, nt;       // the next code to enter each
  typename cga::LaneBytes<K>::T acc;
  int dstar, ustar, score;

  __device__ __forceinline__ void start() {
    iq0 = (r >> 1) - u0;
    jt0 = -iq0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      p1[k] = cga::kInf;
      p2[k] = cga::kInf;
      qv[k] = cga::q_code(cga::fetch<kStaged>(qs, iq0 - k, Lq));
      tv[k] = cga::t_code(cga::fetch<kStaged>(ts, jt0 + k, Lt));
    }
    nq = cga::fetch<kStaged>(qs, iq0 + 1, Lq);
    nt = cga::fetch<kStaged>(ts, jt0 + K, Lt);
    acc = 0;
  }

  // diagonal d, of parity PAR, its codes at bits SH of each slot's byte;
  // kFirst: diagonal 0, whose cell (0, 0) is 0
  template <int PAR, int SH, bool kFirst = false>
  __device__ __forceinline__ void step(int d) {
    int up[K], left[K];
    if constexpr (PAR) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        up[k] = k + 1 < K ? p1[k + 1] : 0;
        left[k] = p1[k];
      }
      up[K - 1] = cga::from_next_lane<K>(p1, cga::kInf);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        up[k] = p1[k];
        left[k] = k > 0 ? p1[k - 1] : 0;
      }
      left[0] = cga::from_prev_lane<K>(p1, cga::kInf);
    }
    // the slots whose cell lies in the matrix and the band: k in [klo, khi]
    const int klo = max(iq0 - qlen, -jt0);
    const int khi = min(min(iq0, tlen - jt0), r - PAR - u0);
    int cur[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int sub = qv[k] != tv[k];
      const int diag = p2[k] + sub;
      int c = min(diag, min(up[k], left[k]) + 1);
      if (kFirst && iq0 == k) c = 0;  // (0, 0)
      if (k < klo || k > khi) c = cga::kInf;
      const int code = c == diag ? sub
                                 : (c == left[k] + 1 ? cga::kDeletion
                                                     : cga::kInsertion);
      acc |= (typename cga::LaneBytes<K>::T)code << (8 * k + SH);
      cur[k] = c;
    }
    if (d == dstar) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (u0 + k == ustar) score = cur[k];
    }
    if constexpr (SH == 6) {
      if (nreal > 0)
        cga::store_lane_bytes<K>(tb + (size_t)(d >> 2) * row_stride, acc,
                                 nreal);
      acc = 0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      p2[k] = p1[k];
      p1[k] = cur[k];
    }
    // into diagonal d + 1: from par 0, j advances (t's codes shift down a
    // slot); from par 1, i advances (q's shift up); the entering code was
    // loaded two diagonals ago, and the next one is issued now
    if constexpr (PAR == 0) {
      ++jt0;
#pragma unroll
      for (int k = 0; k + 1 < K; ++k) tv[k] = tv[k + 1];
      tv[K - 1] = cga::t_code(nt);
      nt = cga::fetch<kStaged>(ts, jt0 + K, Lt);
    } else {
      ++iq0;
#pragma unroll
      for (int k = K - 1; k > 0; --k) qv[k] = qv[k - 1];
      qv[0] = cga::q_code(nq);
      nq = cga::fetch<kStaged>(qs, iq0 + 1, Lq);
    }
  }

  // diagonals [0, d_end) four at a time (d_end is a multiple of 4, at
  // least 4); the first of each four has parity R1 = r & 1
  template <int R1>
  __device__ __forceinline__ void sweep(int d_end) {
    step<R1, 0, true>(0);
    step<1 - R1, 2>(1);
    step<R1, 4>(2);
    step<1 - R1, 6>(3);
    for (int d = 4; d < d_end; d += 4) {
      step<R1, 0>(d);
      step<1 - R1, 2>(d + 1);
      step<R1, 4>(d + 2);
      step<1 - R1, 6>(d + 3);
    }
  }
};

// stage: bytes of shared memory a warp's copy of q and t takes (0 when they
// are read through the read-only cache)
template <int K, bool kStaged>
__global__ void nw_diag_warp_kernel(const int8_t* __restrict__ q,
                                    const int32_t* __restrict__ qlens,
                                    const int8_t* __restrict__ t,
                                    const int32_t* __restrict__ tlens,
                                    int32_t* __restrict__ scores,
                                    uint8_t* __restrict__ tb, int B, int Lq,
                                    int Lt, int r, int W, int Dpad,
                                    int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + slot;
  if (b >= B) return;  // the whole warp
  WarpSweep<K, kStaged> s;
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
  // the end cell (qlen, tlen): its diagonal and slot
  s.dstar = band_ok ? s.qlen + s.tlen : -1;
  s.ustar = (s.tlen - s.qlen + r - ((s.dstar + r) & 1)) >> 1;
  s.score = 0;
  const long long d_need = ((long long)s.qlen + s.tlen + 1 + 3) & ~3LL;
  const int d_end = (int)(d_need < 0 ? 0 : (d_need > Dpad ? Dpad : d_need));
  s.start();
  if (r & 1)
    s.template sweep<1>(d_end);
  else
    s.template sweep<0>(d_end);
  if (lane == (band_ok ? s.ustar / K : 0))
    scores[b] = band_ok ? s.score : cga::kInf;
  if (s.nreal > 0)
    for (int row = d_end >> 2; row < (Dpad >> 2); ++row)
      cga::store_lane_bytes<K>(s.tb + (size_t)row * s.row_stride, 0,
                               s.nreal);
}

template <int K>
int launch_warp(const void* q, const void* qlen, const void* t,
                const void* tlen, void* scores, void* tb, int B, int Lq,
                int Lt, int r, int W, int Dpad, int problems, bool staged,
                cudaStream_t stream) {
  const int stage = staged ? cga::stage_len(Lq) + cga::stage_len(Lt) : 0;
  const long long smem = (long long)problems * stage;
  auto kernel = staged ? nw_diag_warp_kernel<K, true>
                       : nw_diag_warp_kernel<K, false>;
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
      W, Dpad, stage);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 is success).  q (B, Lq) and t (B, Lt) are int8 codes with -1 PAD,
// qlen and tlen (B,) int32, scores (B,) int32, tb (Dpad / 4, B, W) int8.
// The plan (ops/nw_diag.py nw_diag_plan): K in 1..8 runs a warp a problem,
// K slots a lane (32 K >= W), `problems` a block, with q and t in
// shared memory when `staged`, else read through the read-only cache; K = 0
// runs a block a problem, its shared variant when `staged` (scratch null),
// else its device variant on `scratch`, 9W bytes a problem.
extern "C" int cga_nw_diag(const void* q, const void* qlen, const void* t,
                           const void* tlen, void* scores, void* tb,
                           void* scratch, int B, int Lq, int Lt, int r, int W,
                           int Dpad, int K, int problems, int staged,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (K != 0) {
    if (32 * K < W || problems < 1 || problems > 32 ||
        (!staged && (Lq < 1 || Lt < 1)))
      return (int)cudaErrorInvalidValue;
    switch (K) {
#define CGA_NW_DIAG_K(k)                                                    \
  case k:                                                                   \
    return launch_warp<k>(q, qlen, t, tlen, scores, tb, B, Lq, Lt, r, W,    \
                          Dpad, problems, staged, st);
      CGA_NW_DIAG_K(1)
      CGA_NW_DIAG_K(2)
      CGA_NW_DIAG_K(3)
      CGA_NW_DIAG_K(4)
      CGA_NW_DIAG_K(5)
      CGA_NW_DIAG_K(6)
      CGA_NW_DIAG_K(7)
      CGA_NW_DIAG_K(8)
#undef CGA_NW_DIAG_K
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (staged != (scratch == nullptr)) return (int)cudaErrorInvalidValue;
  const int warps = (W + 31) / 32;
  const int threads = warps > 32 ? 1024 : 32 * warps;
  auto args = [&](auto kernel, size_t smem) {
    kernel<<<B, threads, smem, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int32_t*>(qlen),
        static_cast<const int8_t*>(t), static_cast<const int32_t*>(tlen),
        static_cast<int32_t*>(scores), static_cast<uint8_t*>(tb),
        static_cast<unsigned char*>(scratch), B, Lq, Lt, r, W, Dpad);
  };
  if (!staged) {
    args(nw_diag_kernel<false>, 0);
    return (int)cudaGetLastError();
  }
  // two int32 diagonals and a byte of codes per slot, then q and t (the
  // wrapper picks this variant only where they fit a block)
  const long long smem = 9LL * W + Lq + Lt;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_diag_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  args(nw_diag_kernel<true>, (size_t)smem);
  return (int)cudaGetLastError();
}

// Message for an error code returned by any launcher of this library.
extern "C" const char* cga_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
