// Walks each problem's packed traceback from (qlen, tlen) back to (0, 0) and
// emits its edit path, 2 bits per move.  Two kernels, one per traceback
// layout: the anti-diagonal one of csrc/nw_diag.cu (B1) and the row one of
// csrc/nw_row.cu (B3).
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
// qlen + tlen dependent loads, and the time is load latency, not bandwidth or
// arithmetic.  The bytes written are 1/16 of one int32 per move, which also
// cuts the device-to-host copy of the paths 16 times.
//
// Design.  One thread per problem: the walks of a batch overlap each other's
// load latency, and nothing in a walk needs a barrier.  Each thread keeps the
// word it is filling in a register and stores it once, when the walk leaves
// it; the wrapper hands in a zeroed output, so words before `start` are 0.

#include "common.cuh"

namespace {

__global__ void tb_decode_diag_kernel(const uint8_t* __restrict__ tb,
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
    const int d = i + j;
    const int par = (d + r) & 1;
    const int lane = min(max((r + j - i - par) >> 1, 0), W - 1);
    const int row = min(max(d >> 2, 0), R4 - 1);
    int code = (tb[((size_t)row * B + b) * W + lane] >> (2 * (d & 3))) & 3;
    if (i == 0) code = cga::kDeletion;  // row 0: the rest are deletions
    --k;
    word |= (uint32_t)code << (2 * (k & 15));
    if ((k & 15) == 0) {
      out[k >> 4] = (int32_t)word;
      word = 0;
    }
    i -= (code != cga::kDeletion);  // MATCH, MISMATCH, INSERTION
    j -= (code != cga::kInsertion);  // MATCH, MISMATCH, DELETION
  }
  if ((k & 15) != 0) out[k >> 4] = (int32_t)word;
  start[b] = k;
}

// The row layout: cell (i, j) at lane r + j - i of packed row (i - 1) / 4,
// bits 2 * ((i - 1) % 4).
__global__ void tb_decode_row_kernel(const uint8_t* __restrict__ tb,
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
    int code = cga::kDeletion;  // row 0: the rest are deletions
    if (i > 0) {
      const int lane = min(max(r + j - i, 0), W - 1);
      const int row = min((i - 1) >> 2, R4 - 1);
      code = (tb[((size_t)row * B + b) * W + lane] >> (2 * ((i - 1) & 3))) &
             3;
    }
    --k;
    word |= (uint32_t)code << (2 * (k & 15));
    if ((k & 15) == 0) {
      out[k >> 4] = (int32_t)word;
      word = 0;
    }
    i -= (code != cga::kDeletion);
    j -= (code != cga::kInsertion);
  }
  if ((k & 15) != 0) out[k >> 4] = (int32_t)word;
  start[b] = k;
}

}  // namespace

// Launches the decoder on `stream` and returns cudaGetLastError() as an int.
// tb (R4, B, W) int8 from cga_nw_diag, qlen and tlen (B,) int32, packed
// (B, TL / 16) int32 zeroed by the caller, start (B,) int32.
extern "C" int cga_tb_decode_diag(const void* tb, const void* qlen,
                                  const void* tlen, void* packed, void* start,
                                  int B, int R4, int W, int r, int TL,
                                  void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  tb_decode_diag_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(tb), static_cast<const int32_t*>(qlen),
      static_cast<const int32_t*>(tlen), static_cast<int32_t*>(packed),
      static_cast<int32_t*>(start), B, R4, W, r, TL);
  return (int)cudaGetLastError();
}

// Launches the row-layout decoder on `stream` and returns
// cudaGetLastError() as an int.  tb (R4, B, W) int8 from cga_nw_row, the rest
// as for cga_tb_decode_diag.
extern "C" int cga_tb_decode_row(const void* tb, const void* qlen,
                                 const void* tlen, void* packed, void* start,
                                 int B, int R4, int W, int r, int TL,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  tb_decode_row_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(tb), static_cast<const int32_t*>(qlen),
      static_cast<const int32_t*>(tlen), static_cast<int32_t*>(packed),
      static_cast<int32_t*>(start), B, R4, W, r, TL);
  return (int)cudaGetLastError();
}
