// Batched Myers bit-vector edit distance (Hyyrö's blocked formulation):
// the bottom DP row D[qlen, j] of every problem, for every column j.
//
// Replaces: claragenomicsanalysis_tpu/ops/myers_pallas.py::_kernel, the TPU
// kernel behind myers_bottom_row_pallas.  The outputs are the same arrays:
// rows (B, Lt + 1) int32 with rows[b, 0] = qlen and rows[b, j] = D[qlen, j]
// for every column, those past tlen included; scores (B,) int32 =
// rows[b, tlen].  A query of length 0 gives rows[b, j] = j.  A negative code
// (PAD or N) matches nothing.
//
// The recurrence.  The query is cut into 32-base words; word w holds the
// vertical deltas of rows 32w+1 .. 32w+32 as bit masks Pv (+1) and Mv (-1),
// initially all +1.  Column j's update of word w reads the column's match
// mask Eq (bit p set iff q[32w + p] == t[j]) and the horizontal delta hin in
// {-1, 0, +1} that word w - 1 hands up in the same column (+1 into word 0,
// since D[0, j] - D[0, j - 1] = 1), and hands its own up: bit 31 of the
// pre-shift Ph / Mh.  The bottom row moves by bit (qlen - 1) % 32 of word
// (qlen - 1) / 32's pre-shift Ph / Mh.  No word above that one feeds it, so a
// problem computes words 0 .. (qlen - 1) / 32 and stops there.
//
// What bounds it on Hopper.  Integer ALU work: a word update is about 27
// 32-bit logic, add and shift operations for 32 DP cells
// (ops/myers_pallas.py:5-8), with no multiply and almost no memory traffic
// (q and t once, 4 bytes of output per column).  The card's int32 rate is
// 132 SMs x 64 lanes x the SM clock.  What keeps a block from that rate is
// the dependence chain: within a column the carry ripples up the words, and
// a word's column j + 1 waits for its column j.
//
// Design.  One block per problem, so the chain's synchronisation is a
// __syncthreads and never a grid-wide one.  Thread i owns K = 4 consecutive
// words (up to 1024 threads: 4096 words, 131,072 query bases), keeps their
// Pv and Mv in registers and their Peq rows in shared memory, laid out
// [k][sigma][thread] so a warp's reads hit 32 banks.  The block sweeps the
// (thread, column) wavefront: at step s thread i does column s - i for its
// K words in order, the carry passing between them in registers, reads
// thread i - 1's carry of that column from a double-buffered shared byte
// array and writes its own: Lt + threads - 1 steps, one barrier each.  The
// thread holding the last word keeps the running score in a register and
// writes rows[b, j + 1] as the column completes; after the last barrier
// thread 0 reads rows[b, tlen] back as the score.  Row offsets are size_t:
// B * (Lt + 1) exceeds 2^31 at large batches of long targets.  Many
// problems run at once (one block each, 96 threads and 6.2 KB of shared
// memory at 10 kb), which is what fills the 132 SMs; a problem of one word
// (Hirschberg's deep levels) uses one lane of its warp, which is right but
// wasteful.  Shared memory is 66 bytes a thread, 66 KB at 1024 threads, so
// every launch raises the kernel's dynamic shared-memory limit to what it
// asks for.

#include "common.cuh"

namespace {

constexpr int kWord = 32;
constexpr int K = 4;  // words a thread owns

__global__ void myers_kernel(const int8_t* __restrict__ q,
                             const int32_t* __restrict__ qlens,
                             const int8_t* __restrict__ t,
                             const int32_t* __restrict__ tlens,
                             int32_t* __restrict__ rows,
                             int32_t* __restrict__ scores, int Lq, int Lt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  uint32_t* peq = reinterpret_cast<uint32_t*>(smem);  // [K][4][nthreads]
  uint8_t* carry = reinterpret_cast<uint8_t*>(peq + 4 * K * nthreads);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // clamped so that a bad length can never take a word past the block's
  // shared memory; valid inputs have 0 <= qlen <= Lq
  const int qlen = min(max(qlens[b], 0), Lq);
  const int8_t* qb = q + (size_t)b * Lq;
  const int8_t* tb = t + (size_t)b * Lt;
  int32_t* row = rows + (size_t)b * (Lt + 1);

  const int nw = (qlen + kWord - 1) / kWord;  // words this problem needs
  const int active = (nw + K - 1) / K;        // threads that own a word
  const int wlast = nw - 1;
  const int bit_last = (qlen - 1) & (kWord - 1);
  const bool holds_last = nw > 0 && tid == wlast / K;

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = tid * K + k;
    uint32_t e[4] = {0u, 0u, 0u, 0u};
    if (w < nw) {
      for (int p = 0; p < kWord; ++p) {
        const int pos = w * kWord + p;
        const int c = pos < qlen ? qb[pos] : -1;
#pragma unroll
        for (int sigma = 0; sigma < 4; ++sigma)
          e[sigma] |= c == sigma ? 1u << p : 0u;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) peq[(k * 4 + c) * nthreads + tid] = e[c];
  }
  if (tid == 0) row[0] = qlen;
  if (qlen == 0)
    for (int j = 1 + tid; j <= Lt; j += nthreads) row[j] = j;

  uint32_t Pv[K], Mv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    Pv[k] = 0xFFFFFFFFu;
    Mv[k] = 0u;
  }
  int score = qlen;
  __syncthreads();

  const int steps = active > 0 ? Lt + active - 1 : 0;
  for (int s = 0; s < steps; ++s) {
    const int j = s - tid;
    if (tid < active && j >= 0 && j < Lt) {
      const int c = tb[j];
      uint32_t hp = 1u, hn = 0u;  // carry into this thread's first word
      if (tid > 0) {
        const uint32_t v = carry[((s - 1) & 1) * nthreads + tid - 1];
        hp = v & 1u;
        hn = v >> 1;
      }
      int delta = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int w = tid * K + k;
        if (w < nw) {
          const uint32_t eq =
              (unsigned)c < 4u ? peq[(k * 4 + c) * nthreads + tid] : 0u;
          const uint32_t pv = Pv[k], mv = Mv[k];
          const uint32_t eq2 = eq | hn;
          const uint32_t xv = eq | mv;
          const uint32_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
          const uint32_t ph = mv | ~(xh | pv);
          const uint32_t mh = pv & xh;
          if (w == wlast)
            delta = (int)((ph >> bit_last) & 1u) - (int)((mh >> bit_last) & 1u);
          const uint32_t ph1 = (ph << 1) | hp;
          const uint32_t mh1 = (mh << 1) | hn;
          Pv[k] = mh1 | ~(xv | ph1);
          Mv[k] = ph1 & xv;
          hp = ph >> 31;
          hn = mh >> 31;
        }
      }
      carry[(s & 1) * nthreads + tid] = (uint8_t)(hp | (hn << 1));
      if (holds_last) {
        score += delta;
        row[j + 1] = score;
      }
    }
    __syncthreads();
  }
  // every row entry of this block is written and visible after the barrier
  if (tid == 0) scores[b] = row[min(max(tlens[b], 0), Lt)];
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 is success).  q (B, Lq) and t (B, Lt) are int8 codes with -1 PAD, qlen
// and tlen (B,) int32, rows (B, Lt + 1) int32, scores (B,) int32;
// Wq = max(1, ceil(Lq / 32)) <= 4096.
extern "C" int cga_myers(const void* q, const void* qlen, const void* t,
                         const void* tlen, void* rows, void* scores, int B,
                         int Lq, int Lt, int Wq, void* stream) {
  const int threads = ((Wq + K - 1) / K + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const int smem = 16 * K * threads + 2 * threads;
  const cudaError_t err = cudaFuncSetAttribute(
      myers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  myers_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int32_t*>(qlen),
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tlen),
      static_cast<int32_t*>(rows), static_cast<int32_t*>(scores), Lq, Lt);
  return (int)cudaGetLastError();
}
