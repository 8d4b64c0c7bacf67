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
// wlast = (qlen - 1) / 32's pre-shift Ph / Mh.  No word above wlast feeds
// it, so a problem computes words 0 .. wlast and stops there.
//
// What bounds it on Hopper.  Integer ALU work: a word update is about 27
// 32-bit logic, add and shift operations for 32 DP cells
// (ops/myers_pallas.py:5-8), with no multiply and almost no memory traffic
// (q and t once, 4 bytes of output per column).  The card's int32 rate is
// 132 SMs x 64 lanes x the SM clock.  The dependence chain (within a
// column the carry ripples up the words, and a word's column j + 1 waits
// for its column j) has to be spread over enough lanes and problems to
// keep that rate.
//
// Design.
// - G lanes of a warp a problem (G = 1, 2, ..., 32, a template chosen by
//   the wrapper from the query's words, ops/myers.py myers_plan), 32 / G
//   problems a warp, no shared memory and no block barrier.  On a pass,
//   lane g owns KP consecutive words, their Pv, Mv and Peq rows in
//   registers: KP = K on a full pass (16 words for G = 32, else 8), and on
//   a problem's last pass ceil(its remaining words / G), so a short query
//   in a batch padded to a long one costs only its own words.  KP is a
//   template of the sweep, picked by a switch outside the column loop, so a
//   step issues exactly KP word updates.  The lanes of a group sweep the
//   (lane, column) wavefront: at step s lane g does column s - g for its
//   words in order, the carry passing between them in registers, and takes
//   lane g - 1's carry of that column by one __shfl_up_sync inside the
//   group.  Lt + G - 1 steps.
// - The lane holding word wlast keeps the running score and writes
//   rows[b, j + 1] as its column completes, and the score at column tlen.
// - Passes for long queries: a query of more than G K words runs in passes
//   of G K words (G = 32, K = 16: 16,384 bases a pass).  A pass reads the
//   horizontal delta that the word band below it handed up in each column,
//   2 bits a column packed four to a byte, from a device buffer, and writes
//   the one for the band above into the other of two buffers.  Only the
//   pass that holds word wlast writes rows and scores, and no pass above it
//   runs.  So no query length is refused.
// Row offsets are size_t: B * (Lt + 1) exceeds 2^31 at large batches of
// long targets.

#include "common.cuh"

namespace {

constexpr int kWord = 32;

// One pass of a problem's group: lane g holds KP words from word w0, sweeps
// the (lane, column) wavefront and, on the top pass, moves the bottom row.
// KP is a template, so each lane's words live in registers and a step
// issues exactly KP word updates.
template <int G, int KP>
__device__ __forceinline__ void sweep(const int8_t* qb, const int8_t* tb,
                                      int qlen, int tlen, int Lt, int g,
                                      unsigned mask, int w0, int wlast,
                                      int bit_last, bool first, bool top,
                                      const uint8_t* cin, uint8_t* cout,
                                      int32_t* row, int32_t* score_out) {
  uint32_t peq[KP][4];
  uint32_t Pv[KP], Mv[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    uint32_t e0 = 0, e1 = 0, e2 = 0, e3 = 0;
    const int w = w0 + k;
    if (w <= wlast) {
      for (int p = 0; p < kWord; ++p) {
        const int pos = w * kWord + p;
        const int c = pos < qlen ? __ldg(qb + pos) : -1;
        const uint32_t bit = 1u << p;
        e0 |= c == 0 ? bit : 0u;
        e1 |= c == 1 ? bit : 0u;
        e2 |= c == 2 ? bit : 0u;
        e3 |= c == 3 ? bit : 0u;
      }
    }
    peq[k][0] = e0;
    peq[k][1] = e1;
    peq[k][2] = e2;
    peq[k][3] = e3;
    Pv[k] = 0xFFFFFFFFu;
    Mv[k] = 0u;
  }
  const int kl = wlast - w0;  // in 0..KP-1 on the lane holding word wlast
  const bool holds = top && kl >= 0 && kl < KP;
  int score = qlen;
  uint32_t packed_in = 0, packed_out = 0;
  uint32_t up = 0;  // this lane's carry of its last column, 2 bits
  // the target base of the next step is loaded a step ahead, so that no
  // step waits for its load
  int c_next = __ldg(tb + min(max(-g, 0), Lt - 1));
  for (int s = 0; s < Lt + G - 1; ++s) {
    const uint32_t from_below = __shfl_up_sync(mask, up, 1, G);
    const int j = s - g;
    const int c = c_next;
    c_next = __ldg(tb + min(max(j + 1, 0), Lt - 1));
    if (j < 0 || j >= Lt) continue;
    uint32_t hp = 1u, hn = 0u;  // the carry into this lane's first word
    if (g > 0) {
      hp = from_below & 1u;
      hn = from_below >> 1;
    } else if (!first) {
      if ((j & 3) == 0) packed_in = cin[j >> 2];  // written in this launch
      const uint32_t v = packed_in >> (2 * (j & 3));
      hp = v & 1u;
      hn = (v >> 1) & 1u;
    }
    int delta = 0;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const uint32_t eq = c == 0   ? peq[k][0]
                          : c == 1 ? peq[k][1]
                          : c == 2 ? peq[k][2]
                          : c == 3 ? peq[k][3]
                                   : 0u;
      const uint32_t pv = Pv[k], mv = Mv[k];
      const uint32_t eq2 = eq | hn;
      const uint32_t xv = eq | mv;
      const uint32_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
      const uint32_t ph = mv | ~(xh | pv);
      const uint32_t mh = pv & xh;
      if (k == kl)
        delta = (int)((ph >> bit_last) & 1u) - (int)((mh >> bit_last) & 1u);
      const uint32_t ph1 = (ph << 1) | hp;
      const uint32_t mh1 = (mh << 1) | hn;
      Pv[k] = mh1 | ~(xv | ph1);
      Mv[k] = ph1 & xv;
      hp = ph >> 31;
      hn = mh >> 31;
    }
    up = hp | (hn << 1);
    if (holds) {
      score += delta;
      row[j + 1] = score;
      if (j + 1 == tlen) *score_out = score;
    }
    if (!top && g == G - 1) {  // hand the band above its carries
      packed_out |= up << (2 * (j & 3));
      if ((j & 3) == 3 || j == Lt - 1) {
        cout[j >> 2] = (uint8_t)packed_out;
        packed_out = 0;
      }
    }
  }
  if (holds && tlen == 0) *score_out = qlen;
}

// KP words a lane, 1..KMAX, by a switch outside the column loop
template <int G, int KMAX>
__device__ __forceinline__ void sweep_kp(int kp, const int8_t* qb,
                                         const int8_t* tb, int qlen,
                                         int tlen, int Lt, int g,
                                         unsigned mask, int w0, int wlast,
                                         int bit_last, bool first, bool top,
                                         const uint8_t* cin, uint8_t* cout,
                                         int32_t* row, int32_t* score_out) {
#define CGA_SWEEP(KP)                                                        \
  case KP:                                                                   \
    if constexpr (KP <= KMAX)                                                \
      sweep<G, KP>(qb, tb, qlen, tlen, Lt, g, mask, w0, wlast, bit_last,     \
                   first, top, cin, cout, row, score_out);                   \
    return;
  switch (kp) {
    CGA_SWEEP(1) CGA_SWEEP(2) CGA_SWEEP(3) CGA_SWEEP(4)
    CGA_SWEEP(5) CGA_SWEEP(6) CGA_SWEEP(7) CGA_SWEEP(8)
    CGA_SWEEP(9) CGA_SWEEP(10) CGA_SWEEP(11) CGA_SWEEP(12)
    CGA_SWEEP(13) CGA_SWEEP(14) CGA_SWEEP(15) CGA_SWEEP(16)
    default: return;
  }
#undef CGA_SWEEP
}

// K words a lane on a full pass: 16 where a problem has a whole warp, else 8
template <int G>
__global__ void myers_kernel(const int8_t* __restrict__ q,
                             const int32_t* __restrict__ qlens,
                             const int8_t* __restrict__ t,
                             const int32_t* __restrict__ tlens,
                             int32_t* __restrict__ rows,
                             int32_t* __restrict__ scores,
                             uint8_t* __restrict__ carry, int B, int Lq,
                             int Lt) {
  constexpr int K = G == 32 ? 16 : 8;
  constexpr int kPass = G * K;  // words a full pass
  const int gid = threadIdx.x & 31;
  const int g = gid % G;  // lane within the group
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= B) return;  // whole groups leave together
  const unsigned mask =
      G == 32 ? 0xffffffffu : (((1u << (G % 32)) - 1u) << (gid - g));
  const int qlen = min(max(qlens[b], 0), Lq);
  const int tlen = min(max(tlens[b], 0), Lt);
  const int8_t* qb = q + (size_t)b * Lq;
  const int8_t* tb = t + (size_t)b * Lt;
  int32_t* row = rows + (size_t)b * (Lt + 1);
  const int Lt4 = (Lt + 3) / 4;
  uint8_t* cbuf[2] = {carry + (size_t)b * Lt4,
                      carry + ((size_t)B + b) * Lt4};

  if (qlen == 0) {
    for (int j = g; j <= Lt; j += G) row[j] = j;
    if (g == 0) scores[b] = tlen;
    return;
  }
  if (g == 0) row[0] = qlen;
  const int wlast = (qlen - 1) / kWord;
  const int bit_last = (qlen - 1) & (kWord - 1);
  const int passes = wlast / kPass + 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool top = pass == passes - 1;
    // words a lane: K, but on the top pass only as many as the problem's
    // own words need, so a short query of a long batch costs its own work
    const int kp = top ? (wlast + 1 - pass * kPass + G - 1) / G : K;
    sweep_kp<G, K>(kp, qb, tb, qlen, tlen, Lt, g, mask,
                   pass * kPass + g * kp, wlast, bit_last, pass == 0, top,
                   cbuf[(pass + 1) & 1], cbuf[pass & 1], row, scores + b);
    __syncwarp(mask);  // this pass's carries, before the next pass reads
  }
}

template <int G>
int launch(const void* q, const void* qlen, const void* t, const void* tlen,
           void* rows, void* scores, void* carry, int B, int Lq, int Lt,
           cudaStream_t stream) {
  const int threads = 128;
  const long long lanes = (long long)B * G;
  const int blocks = (int)((lanes + threads - 1) / threads);
  myers_kernel<G><<<blocks, threads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int32_t*>(qlen),
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tlen),
      static_cast<int32_t*>(rows), static_cast<int32_t*>(scores),
      static_cast<uint8_t*>(carry), B, Lq, Lt);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 is success).  q (B, Lq) and t (B, Lt) are int8 codes with -1 PAD, qlen
// and tlen (B,) int32, rows (B, Lt + 1) int32, scores (B,) int32; G lanes a
// problem and K words a lane on a full pass, 16 for G = 32, else 8
// (myers_plan); carry is two buffers of
// B x ceil(Lt / 4) bytes, used where a query needs more than one pass of
// G K words (it may be null where none does).
extern "C" int cga_myers(const void* q, const void* qlen, const void* t,
                         const void* tlen, void* rows, void* scores,
                         void* carry, int B, int Lq, int Lt, int G, int K,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K != (G == 32 ? 16 : 8)) return (int)cudaErrorInvalidValue;
  switch (G) {
    case 1: return launch<1>(q, qlen, t, tlen, rows, scores, carry, B, Lq, Lt, s);
    case 2: return launch<2>(q, qlen, t, tlen, rows, scores, carry, B, Lq, Lt, s);
    case 4: return launch<4>(q, qlen, t, tlen, rows, scores, carry, B, Lq, Lt, s);
    case 8: return launch<8>(q, qlen, t, tlen, rows, scores, carry, B, Lq, Lt, s);
    case 16: return launch<16>(q, qlen, t, tlen, rows, scores, carry, B, Lq, Lt, s);
    case 32: return launch<32>(q, qlen, t, tlen, rows, scores, carry, B, Lq, Lt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
