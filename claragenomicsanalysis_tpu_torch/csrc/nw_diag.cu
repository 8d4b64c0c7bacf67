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
// problem takes qlen + tlen dependent steps, each ended by a barrier.
//
// Design.  One thread block per problem, so the step barrier is a
// __syncthreads and never a grid-wide sync.  Threads stride over the W slots
// (W may exceed the block size when a bucket's band is wide).  Diagonals d - 1
// and d - 2 live in shared memory as int32: d - 2 is read only at the
// thread's own slot, so diagonal d overwrites it in place and two buffers with
// one barrier per diagonal suffice.  The problem's query and target are
// staged in shared memory once, so the per-cell base loads hit shared memory.
// Each slot's four codes are OR-accumulated in a shared byte and stored once
// per four diagonals.  A problem stops at its own last diagonal
// (round_up(qlen + tlen + 1, 4)) rather than the batch's padded one, and
// writes zeros to the traceback rows it does not reach; the plain PyTorch
// version in ops/nw_diag.py defines the same output.
//
// Many problems run at once (one block each, a few KB of shared memory per
// block), which is what fills the card's 132 SMs.
//
// Two variants of the one kernel body (template kShared), chosen by the
// wrapper from the shapes (ops/nw_diag.py nw_diag_smem_bytes): the shared
// variant keeps both diagonals, the code bytes and q and t in shared memory,
// 9W + Lq + Lt bytes a block; past the 227 KB a block can have (wide bands
// of pairs whose lengths differ by more than 16,384, or long reads) the
// device variant keeps the diagonals and code bytes in a scratch slice of
// 9W bytes a problem that the wrapper allocates, and reads q and t through
// the read-only cache (__ldg).  The rules are the same code.

#include "common.cuh"

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

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 is success).  q (B, Lq) and t (B, Lt) are int8 codes with -1 PAD,
// qlen and tlen (B,) int32, scores (B,) int32, tb (Dpad / 4, B, W) int8.
// scratch is null for the shared variant; for the device variant it holds
// 9W bytes a problem.
extern "C" int cga_nw_diag(const void* q, const void* qlen, const void* t,
                           const void* tlen, void* scores, void* tb,
                           void* scratch, int B, int Lq, int Lt, int r, int W,
                           int Dpad, void* stream) {
  const int warps = (W + 31) / 32;
  const int threads = warps > 32 ? 1024 : 32 * warps;
  auto args = [&](auto kernel, size_t smem) {
    kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int32_t*>(qlen),
        static_cast<const int8_t*>(t), static_cast<const int32_t*>(tlen),
        static_cast<int32_t*>(scores), static_cast<uint8_t*>(tb),
        static_cast<unsigned char*>(scratch), B, Lq, Lt, r, W, Dpad);
  };
  if (scratch != nullptr) {
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
