// Walks each problem's packed traceback from (qlen, tlen) back to (0, 0) and
// emits its edit path, 2 bits per move.  One body for both traceback
// layouts: the anti-diagonal one of csrc/nw_diag.cu (B1) and the row one of
// csrc/nw_row.cu (B3), a template on the layout.
//
// Replaces: claragenomicsanalysis_tpu/ops/tb_decode_pallas.py::_kernel, with
// diag=True and diag=False (the TPU kernel behind _decode /
// traceback_paths_device).  The outputs are the same arrays: packed
// (B, TL / 16) int32 holding 16 codes per word, written backwards from slot
// TL, and start (B,) int32, the slot of the first move.  TL =
// round_up(Dpad + 8, 2048) for the diag layout and round_up(2 * 4 * R4 + 2r
// + 8, 2048) for the row layout (R4 packed rows).
//
// The walk reads tb bytes as uint8: a signed shift of an int8 byte would
// spread the sign bit into the code.  Lane and row are clipped to the array
// exactly as the TPU kernel clips them, so a problem whose band overflowed
// (INF score) walks bounded garbage instead of reading out of bounds; its
// caller drops it by status.  Row 0 emits DELETION; the walk stops at the
// origin or when all TL slots are used.
//
// What bounds it on Hopper.  The walk is serial: every step's address depends
// on the code the previous step read, so each problem is a chain of
// qlen + tlen dependent loads, and the time is the latency of that load, not
// bandwidth or arithmetic.  The tb is laid out (R4, B, W): a problem's
// consecutive packed rows lie B * W bytes apart, and a long launch's tb is
// larger than L2, so the first design (a thread a problem reading the tb
// where it lies) met a DRAM miss every second step or so.
//
// Design (the plan comes from ops/tb_decode.py tb_decode_plan):
// - "thread": a thread a problem, the first design, kept for short problems
//   (a Hirschberg base case is about 18 rows), where many walks in flight
//   hide each other's latency.
// - "staged": a warp a problem, up to four a block.  The packed row a walk
//   reads never rises (the diag layout reads row clip((i + j) >> 2), and
//   i + j falls each step; the row layout row (i - 1) >> 2, and i never
//   grows), even on a clipped garbage walk, so the rows it reads next are
//   known before it reads them.  The warp streams the problem's rows from the
//   first one the walk reads down to row 0 into a shared-memory ring of two
//   chunks of `rows` rows, with cp.async (16-byte copies where W is a
//   multiple of 16, else 8: W is a multiple of 8), one chunk in flight while
//   the warp walks the other from shared memory, every lane in step (one
//   broadcast read a step), lane 0 storing.  A step is then a shared load,
//   not a DRAM miss.
// Both keep the word being filled in a register and store it once, when the
// walk leaves it; the wrapper hands in a zeroed output, so words before
// `start` are 0.

#include "common.cuh"

namespace {

using cga::kDeletion;
using cga::kInsertion;

// (packed row, lane, bit shift) of cell (i, j), i >= 1, clipped to the array
template <bool kDiag>
__device__ __forceinline__ void cell(int i, int j, int r, int W, int R4,
                                     int& row, int& lane, int& shift) {
  if constexpr (kDiag) {
    const int d = i + j;
    lane = min(max((r + j - i - ((d + r) & 1)) >> 1, 0), W - 1);
    row = min(max(d >> 2, 0), R4 - 1);
    shift = 2 * (d & 3);
  } else {
    lane = min(max(r + j - i, 0), W - 1);
    row = min((i - 1) >> 2, R4 - 1);
    shift = 2 * ((i - 1) & 3);
  }
}

// one move: slot k - 1 of the path gets `code`; a filled word is stored
// (by the thread that stores)
__device__ __forceinline__ void emit(int code, int& k, uint32_t& word,
                                     int32_t* out, bool store) {
  --k;
  word |= (uint32_t)code << (2 * (k & 15));
  if ((k & 15) == 0) {
    if (store) out[k >> 4] = (int32_t)word;
    word = 0;
  }
}

template <bool kDiag>
__global__ void tb_decode_thread_kernel(const uint8_t* __restrict__ tb,
                                        const int32_t* __restrict__ qlens,
                                        const int32_t* __restrict__ tlens,
                                        int32_t* __restrict__ packed,
                                        int32_t* __restrict__ start, int B,
                                        int R4, int W, int r, int TL) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = qlens[b];
  int j = tlens[b];
  int k = TL;
  uint32_t word = 0;
  int32_t* out = packed + (size_t)b * (TL / 16);
  while ((i > 0 || j > 0) && k > 0) {
    int code = kDeletion;  // row 0: the rest are deletions
    if (i > 0) {
      int row, lane, shift;
      cell<kDiag>(i, j, r, W, R4, row, lane, shift);
      code = (tb[((size_t)row * B + b) * W + lane] >> shift) & 3;
    }
    emit(code, k, word, out, true);
    i -= (code != kDeletion);   // MATCH, MISMATCH, INSERTION
    j -= (code != kInsertion);  // MATCH, MISMATCH, DELETION
  }
  if ((k & 15) != 0) out[k >> 4] = (int32_t)word;
  start[b] = k;
}

template <int kCopy>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (kCopy == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

// The warp's copies of rows [max(hi - rows + 1, 0), hi] of problem b into
// `dst`, row hi first, as one cp.async group (an empty one where hi < 0).
template <int kCopy>
__device__ __forceinline__ void stage_chunk(uint8_t* dst,
                                            const uint8_t* __restrict__ tb,
                                            int hi, int rows, int B, int b,
                                            int W, int lane) {
  const int n = hi - max(hi - rows + 1, 0) + 1;
  const int per = W / kCopy;
  for (int p = lane; p < n * per; p += 32) {
    const int rr = p / per, cc = (p - rr * per) * kCopy;
    copy_async<kCopy>(dst + rr * W + cc,
                      tb + ((size_t)(hi - rr) * B + b) * W + cc);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kDiag, int kCopy>
__global__ void __launch_bounds__(128)
    tb_decode_staged_kernel(const uint8_t* __restrict__ tb,
                            const int32_t* __restrict__ qlens,
                            const int32_t* __restrict__ tlens,
                            int32_t* __restrict__ packed,
                            int32_t* __restrict__ start, int B, int R4, int W,
                            int r, int TL, int rows) {
  extern __shared__ __align__(16) uint8_t ring[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  uint8_t* buf = ring + (size_t)(threadIdx.x >> 5) * 2 * rows * W;
  int i = qlens[b];
  int j = tlens[b];
  // the first row the walk reads; every later one is at or below it
  int top;
  if constexpr (kDiag)
    top = min(max((i + j) >> 2, 0), R4 - 1);
  else
    top = min(max((i - 1) >> 2, 0), R4 - 1);
  int hi = top;  // the top row of the next chunk to stage
  for (int c = 0; c < 2; ++c, hi -= rows)
    stage_chunk<kCopy>(buf + c * rows * W, tb, hi, rows, B, b, W, lane);
  int k = TL;
  uint32_t word = 0;
  int32_t* out = packed + (size_t)b * (TL / 16);
  int chunk_hi = top, slot = 0;
  for (;;) {
    const int lo = max(chunk_hi - rows + 1, 0);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();  // every lane's copies of this chunk have landed
    // the whole warp walks in step (every lane reads the same byte, a
    // broadcast), so no lane waits on a branch of another; lane 0 stores
    const uint8_t* cur = buf + slot * rows * W;
    while ((i > 0 || j > 0) && k > 0) {
      int code = kDeletion;  // row 0: the rest are deletions
      if (i > 0) {
        int row, ln, shift;
        cell<kDiag>(i, j, r, W, R4, row, ln, shift);
        if (row < lo) break;  // the walk goes on in the next chunk
        code = (cur[(chunk_hi - row) * W + ln] >> shift) & 3;
      }
      emit(code, k, word, out, lane == 0);
      i -= (code != kDeletion);
      j -= (code != kInsertion);
    }
    if (!((i > 0 || j > 0) && k > 0)) break;
    __syncwarp();  // every lane is done with this slot: stage the chunk
                   // after the one in flight into it
    stage_chunk<kCopy>(buf + slot * rows * W, tb, hi, rows, B, b, W, lane);
    hi -= rows;
    slot ^= 1;
    chunk_hi = lo - 1;
  }
  if (lane == 0) {
    if ((k & 15) != 0) out[k >> 4] = (int32_t)word;
    start[b] = k;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // none outlives us
}

template <bool kDiag>
int launch(const void* tb, const void* qlen, const void* tlen, void* packed,
           void* start, int B, int R4, int W, int r, int TL, int copy,
           int problems, int rows, cudaStream_t stream) {
  const auto* t = static_cast<const uint8_t*>(tb);
  const auto* ql = static_cast<const int32_t*>(qlen);
  const auto* tl = static_cast<const int32_t*>(tlen);
  auto* pk = static_cast<int32_t*>(packed);
  auto* st = static_cast<int32_t*>(start);
  if (copy == 0) {  // a thread a problem
    const int threads = 128;
    tb_decode_thread_kernel<kDiag><<<(B + threads - 1) / threads, threads, 0,
                                     stream>>>(t, ql, tl, pk, st, B, R4, W, r,
                                               TL);
    return (int)cudaGetLastError();
  }
  if ((copy != 8 && copy != 16) || W % copy || problems < 1 || problems > 4 ||
      rows < 1 || (reinterpret_cast<uintptr_t>(tb) % copy))
    return (int)cudaErrorInvalidValue;
  auto kernel = copy == 16 ? tb_decode_staged_kernel<kDiag, 16>
                           : tb_decode_staged_kernel<kDiag, 8>;
  const long long smem = 2LL * problems * rows * W;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + problems - 1) / problems, 32 * problems, (size_t)smem,
           stream>>>(t, ql, tl, pk, st, B, R4, W, r, TL, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the decoder on `stream` and returns cudaGetLastError() as an int.
// tb (R4, B, W) int8 from cga_nw_diag, qlen and tlen (B,) int32, packed
// (B, TL / 16) int32 zeroed by the caller, start (B,) int32.  The plan: copy
// 0 for a thread a problem, else a warp a problem staging `rows` rows a chunk
// with copies of `copy` bytes (8 or 16, dividing W and tb's address),
// `problems` (1-4) a block.
extern "C" int cga_tb_decode_diag(const void* tb, const void* qlen,
                                  const void* tlen, void* packed, void* start,
                                  int B, int R4, int W, int r, int TL,
                                  int copy, int problems, int rows,
                                  void* stream) {
  return launch<true>(tb, qlen, tlen, packed, start, B, R4, W, r, TL, copy,
                      problems, rows, (cudaStream_t)stream);
}

// Launches the row-layout decoder on `stream` and returns
// cudaGetLastError() as an int.  tb (R4, B, W) int8 from cga_nw_row, the rest
// as for cga_tb_decode_diag.
extern "C" int cga_tb_decode_row(const void* tb, const void* qlen,
                                 const void* tlen, void* packed, void* start,
                                 int B, int R4, int W, int r, int TL, int copy,
                                 int problems, int rows, void* stream) {
  return launch<false>(tb, qlen, tlen, packed, start, B, R4, W, r, TL, copy,
                       problems, rows, (cudaStream_t)stream);
}
