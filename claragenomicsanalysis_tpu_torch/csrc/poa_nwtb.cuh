// Device functions of the graph NW and its traceback, shared by poa_nwtb.cu
// (one launch per added sequence of the lockstep route) and poa_window.cu
// (the whole POA of a window in one kernel).  The rules and the design are
// described in poa_nwtb.cu: a window is one warp or one block (template
// kWarp), a ring of recent rows in shared memory, each row's facts loaded
// three rows ahead, the move in the plane word and a walk of one plane load
// a step.
#pragma once

#include <climits>

#include "poa_group.cuh"

// poa_window.cu's split build marks the forward pass's end and the end
// cell's; every other build compiles the marks away
#ifndef CGA_NW_MARK
#define CGA_NW_MARK(k) ((void)0)
#endif

namespace cga {

constexpr int kDiag = 0, kVert = 1, kHoriz = 2;
constexpr int kFar = 63;  // a move 63 or more rows back

// A plane word: the cell's value above the low byte (the move, bits 0-1,
// and how many rows back it goes, bits 2-7).  kRealMin: a real cell's value
// is above it.
template <typename Word>
struct Pack;

template <>
struct Pack<int32_t> {  // 24-bit values; a NEG-derived one stored as -2^23
  static constexpr int kRealMin = -(1 << 22);
  __device__ __forceinline__ static int32_t word(int here, int low) {
    const int v = min(max(here, -(1 << 23)), (1 << 23) - 1);
    return (int32_t)((unsigned)v << 8) | low;
  }
};

template <>
struct Pack<long long> {  // the int32 value exactly; the spec's NEG // 2
  static constexpr int kRealMin = cga::kNeg / 2;
  __device__ __forceinline__ static long long word(int here, int low) {
    return (long long)((unsigned long long)(long long)here << 8) | low;
  }
};

template <typename Word>
__device__ __forceinline__ int value_of(Word word) {
  return (int)(word >> 8);
}

// kLdg: the graph is read through the read-only cache (__ldg), which only a
// kernel that does not write the graph may do (B5); B10 writes it between
// its phases and reads it with plain loads.  A template parameter, so each
// load stays a global-memory instruction.
template <typename Word, bool kLdg>
struct Window {
  __device__ __forceinline__ int ld(const int32_t* p) const {
    if constexpr (kLdg)
      return __ldg(p);
    else
      return *p;
  }
  const int8_t* seq;  // the sequence, staged in shared memory
  const int32_t* order;
  const int32_t* rank;
  const int32_t* npred;
  const int32_t* base;
  const int32_t* nsucc;
  const int32_t* pred;
  Word* plane;     // (N + 1) x (L + 1) words
  Word* ring;      // R x RW words of shared memory
  int32_t* rows;   // 2 x (4 + 3P) ints of shared memory: two rows' facts
  int slen, nc, nce;
};

struct Dims {
  int N, P, L, R, RW, match, mismatch, g, half;
  bool banded;
};

// the band [lo, hi] of plane row ri = rank + 1 (all of 0..slen unbanded)
template <typename Word, bool kLdg>
__device__ __forceinline__ void band_of(const Window<Word, kLdg>& w, const Dims& d,
                                        int ri, int* lo, int* hi) {
  if (!d.banded) {
    *lo = 0;
    *hi = w.slen;
    return;
  }
  const long long num = (long long)ri * w.slen;
  const int c = num <= INT_MAX ? (int)num / (w.nc + 1)
                               : (int)(num / (w.nc + 1));
  *lo = max(0, c - d.half);
  *hi = min(w.slen, c + d.half);
}

// a row's facts, kept in shared memory one row ahead (two buffers of
// 4 + 3P ints): the in-degree, the base, the band [lo, hi], then for each
// pred slot its plane row (0, the virtual row, for an empty or invalid slot)
// and that row's band
constexpr int kRowK = 0, kRowB = 1, kRowLo = 2, kRowHi = 3, kRowPreds = 4;

template <typename Word, bool kLdg>
__device__ __forceinline__ int row_node(const Window<Word, kLdg>& w, const Dims& d,
                                        int r) {
  return min(max(w.ld(w.order + r), 0), d.N - 1);
}

// the plane row of pred id q (0 for an invalid id, as in the spec)
template <typename Word, bool kLdg>
__device__ __forceinline__ int plane_row(const Window<Word, kLdg>& w, const Dims& d,
                                         int q) {
  const int row = (q >= 0 && q < d.N) ? w.ld(w.rank + q) + 1 : 0;
  return min(max(row, 0), d.N);
}

// The facts of a row are loaded three rows ahead, so that their chain of
// dependent loads (the node, then its in-degree, base and pred ids, then
// the preds' ranks) overlaps the work of three rows instead of stalling
// one.  A thread carries slots gt and gt + gn (kSlots of them); slots past
// kSlots x gn are loaded when the row lands.
constexpr int kSlots = 2;

struct Flight {
  int u, k, b, q[kSlots];  // the node (clamped), its in-degree, base and
                           // pred ids
};

// Each load below is consumed only a row later: a GPU issues in order, so
// a load used at once would stall the row for its whole latency.  The
// loads are unconditional, at clamped addresses (a select on a load's
// value is a use); rows past the node count are dropped where they land.
template <typename Word, bool kLdg>
__device__ __forceinline__ int flight_node(const Window<Word, kLdg>& w,
                                           const Dims& d,
                                           int r) {
  return w.ld(w.order + min(r, d.N - 1));  // clamped where it is used
}

template <typename Word, bool kLdg>
__device__ __forceinline__ Flight flight_slots(const Window<Word, kLdg>& w,
                                               const Dims& d, int u_raw,
                                               int gt, int gn) {
  Flight f;
  const int u = min(max(u_raw, 0), d.N - 1);
  f.u = u;
  f.k = w.ld(w.npred + u);
  f.b = w.ld(w.base + u);
#pragma unroll
  for (int m = 0; m < kSlots; ++m)
    f.q[m] = w.ld(w.pred + u * d.P + min(gt + m * gn, d.P - 1));
  return f;
}

// the preds' ranks (raw: validity is applied when they land)
template <typename Word, bool kLdg>
__device__ __forceinline__ void flight_ranks(const Window<Word, kLdg>& w,
                                             const Dims& d,
                                             const Flight& f, int* rk) {
#pragma unroll
  for (int m = 0; m < kSlots; ++m)
    rk[m] = w.ld(w.rank + min(max(f.q[m], 0), d.N - 1));
}

// pred slot p of a row into its facts: q the pred id, rk_q its rank (raw)
template <typename Word, bool kLdg>
__device__ __forceinline__ void land_slot(const Window<Word, kLdg>& w,
                                          const Dims& d, int32_t* row, int p,
                                          int k, int q, int rk_q) {
  // an empty slot or an invalid id reads the virtual row, as the spec
  const int row_p = (p < k && q >= 0 && q < d.N)
                        ? min(max(rk_q + 1, 0), d.N) : 0;
  int lo = 0, hi = 0;
  if (row_p > 0) band_of(w, d, row_p, &lo, &hi);
  row[kRowPreds + p] = row_p;
  row[kRowPreds + d.P + p] = lo;
  row[kRowPreds + 2 * d.P + p] = hi;
}

// row r's facts into `row` (visible after the group's next sync)
template <typename Word, bool kLdg>
__device__ __forceinline__ void flight_land(const Window<Word, kLdg>& w,
                                            const Dims& d, int r,
                                            const Flight& f, const int* rk,
                                            int32_t* row, int gt, int gn) {
  if (r >= w.nce) return;
  if (gt == 0) {
    row[kRowK] = f.k;
    row[kRowB] = f.b;
    int lo, hi;
    band_of(w, d, r + 1, &lo, &hi);
    row[kRowLo] = lo;
    row[kRowHi] = hi;
  }
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int p = gt + m * gn;
    if (p < d.P) land_slot(w, d, row, p, f.k, f.q[m], rk[m]);
  }
  for (int p = gt + kSlots * gn; p < d.P; p += gn) {
    const int q = w.ld(w.pred + f.u * d.P + p);
    land_slot(w, d, row, p, f.k, q,
              w.ld(w.rank + min(max(q, 0), d.N - 1)));
  }
}

// A pred row as the current row reads it: its cells at columns [lo, hi],
// at base[j] (a ring row or a plane row, one generic pointer), or j * gap
// for the virtual row (base null); NEG elsewhere.  Built once a row, so a
// cell's pred read is a range test and one load.
template <typename Word>
struct View {
  const Word* base;
  int lo, hi;
};

template <typename Word, bool kLdg>
__device__ __forceinline__ View<Word> make_view(const Window<Word, kLdg>& w,
                                                const Dims& d, int pr, int lo,
                                                int hi, int ri) {
  if (pr == 0) return View<Word>{nullptr, 0, INT_MAX};
  if (pr >= ri) return View<Word>{nullptr, 1, 0};  // not computed yet: NEG
  if (ri - pr < d.R)
    return View<Word>{w.ring + (pr & (d.R - 1)) * d.RW - lo, lo, hi};
  return View<Word>{w.plane + (size_t)pr * (d.L + 1), lo, hi};
}

template <typename Word>
__device__ __forceinline__ int view_value(const View<Word>& v, const Dims& d,
                                          int j) {
  if (j < v.lo || j > v.hi) return cga::kNeg;
  return v.base ? value_of(v.base[j]) : j * d.g;
}

// the max over the row's k pred slots at column j and its first slot; the
// first two slots come as views (most nodes have one or two preds), the
// others from the row's facts
template <typename Word, bool kLdg>
__device__ __forceinline__ int pred_max2(const Window<Word, kLdg>& w,
                                         const Dims& d, const int32_t* row,
                                         int k, const View<Word>* sv, int j,
                                         int ri, int* slot) {
  *slot = 0;
  if (k == 0) return j * d.g;
  int m = k < d.P ? cga::kNeg : INT_MIN;
  const int n = min(k, d.P);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p < n) {
      const int x = view_value(sv[p], d, j);
      if (x > m) {
        m = x;
        *slot = p;
      }
    }
  }
  const int32_t* pr = row + kRowPreds;
  for (int p = 2; p < n; ++p) {
    const int x = view_value(
        make_view(w, d, pr[p], pr[d.P + p], pr[2 * d.P + p], ri), d, j);
    if (x > m) {
      m = x;
      *slot = p;
    }
  }
  return m;
}

// plane row ri's value at column j, once every row is computed (from the
// plane: the ring no longer holds it)
template <typename Word, bool kLdg>
__device__ __forceinline__ int end_value(const Window<Word, kLdg>& w,
                                         const Dims& d, int ri, int j) {
  if (ri == 0) return j * d.g;
  int lo, hi;
  band_of(w, d, ri, &lo, &hi);
  if (j < lo || j > hi) return cga::kNeg;
  return value_of(w.plane[(size_t)ri * (d.L + 1) + j]);
}

// cell j of row ri: its value `here` and the move the walk takes from it
// (diagonal through slot amp, else vertical through slot am, else
// horizontal, the spec's priority) as one word (Pack): the value above the
// low byte, the move in bits 0-1, and in bits 2-7 how many rows back the
// move goes (0 for the virtual row, 63 for 63 or more: the walk then finds
// the slot again by value); to the ring, or without a ring straight to the
// plane
template <typename Word>
__device__ __forceinline__ void emit_cell(const Dims& d, Word* ring_row,
                                          Word* out, int j, int ri,
                                          int here, int pmp, int sub, int pm,
                                          int amp, int am, const int* sp,
                                          const int32_t* row) {
  int move = kHoriz, s = -1;
  if (j > 0 && pmp + sub == here) {
    move = kDiag;
    s = amp;
  } else if (pm + d.g == here) {
    move = kVert;
    s = am;
  }
  int back = 0;
  if (s >= 0) {
    const int pr = s == 0 ? sp[0] : s == 1 ? sp[1] : row[kRowPreds + s];
    back = pr == 0 ? 0 : min(max(ri - pr, 1), kFar);
  }
  const Word word = Pack<Word>::word(here, move | (back << 2));
  if (d.R)
    ring_row[j] = word;  // copied to the plane whole, after the row
  else
    out[j] = word;
}

// exclusive prefix max of v over the group (INT_MIN for its first thread)
template <bool kWarp>
__device__ __forceinline__ int group_prefix_max(int v, int* wtot) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  int pre = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) pre = INT_MIN;
  if constexpr (!kWarp) {
    const int wid = threadIdx.x >> 5;
    if (lane == 31) wtot[wid] = incl;
    __syncthreads();
    int c = lane < wid ? wtot[lane] : INT_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c = max(c, __shfl_xor_sync(kFull, c, o));
    pre = max(pre, c);
  }
  return pre;
}

// max over the group; every thread gets it
template <bool kWarp>
__device__ __forceinline__ int group_max(int v, int* wtot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  if constexpr (!kWarp) {
    __syncthreads();  // wtot may still be read by a scan
    if ((threadIdx.x & 31) == 0) wtot[threadIdx.x >> 5] = v;
    __syncthreads();
    const int nw = (blockDim.x + 31) >> 5;
    v = (threadIdx.x & 31) < nw ? wtot[threadIdx.x & 31] : INT_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;
}

// the plane row a diagonal or vertical move from (r, j) goes to when it
// goes 63 or more rows back: the first pred slot whose cell plus the move's
// score gives the cell's value, as the spec's walk finds it
template <typename Word, bool kLdg>
__device__ __forceinline__ int far_pred_row(const Window<Word, kLdg>& w,
                                            const Dims& d, int r, int j,
                                            int move, Word word) {
  const int here = value_of(word);
  const int u = row_node(w, d, r);
  const int col = move == kDiag ? j - 1 : j;
  int want = here - d.g;
  if (move == kDiag) {
    const int sc = w.seq[j - 1];
    want = here - ((sc == w.ld(w.base + u) && sc >= 0) ? d.match
                                                         : d.mismatch);
  }
  const int n = min(w.ld(w.npred + u), d.P);
  for (int p = 0; p < n; ++p) {
    const int pr = plane_row(w, d, w.ld(w.pred + u * d.P + p));
    if (end_value(w, d, pr, col) == want) return pr;
  }
  return 0;
}

// the graph NW of one window by its group (gt of gn threads), then the walk
// by thread 0 of the group
template <bool kWarp, typename Word, bool kLdg>
__device__ __forceinline__ void nwtb_window(const Window<Word, kLdg>& w,
                                            const Dims& d, int gt, int gn,
                                            int* wtot, int32_t* pnw,
                                            int32_t* ppw, int32_t* k0_out,
                                            int32_t* band_ok_out) {
  const int L1 = d.L + 1;
  const int TL = d.N + d.L;
  const int slen = w.slen;
  const int RB = kRowPreds + 3 * d.P;  // ints of a row's facts
  int rk[kSlots];
  {  // row 0's facts now; rows 1 and 2 in flight
    const Flight f0 = flight_slots(w, d, flight_node(w, d, 0), gt, gn);
    flight_ranks(w, d, f0, rk);
    flight_land(w, d, 0, f0, rk, w.rows, gt, gn);
  }
  Flight f1 = flight_slots(w, d, flight_node(w, d, 1), gt, gn);
  int u2 = flight_node(w, d, 2);
  group_sync<kWarp>();

  for (int r = 0; r < w.nce; ++r) {
    const int ri = r + 1;
    const int32_t* cur = w.rows + (r & 1) * RB;
    int32_t* nxt = w.rows + ((r + 1) & 1) * RB;
    // in flight: row r + 3's node, row r + 2's slots, row r + 1's ranks
    const int u3 = flight_node(w, d, r + 3);
    const Flight f2 = flight_slots(w, d, u2, gt, gn);
    flight_ranks(w, d, f1, rk);
    const int k = cur[kRowK];
    const int b = cur[kRowB];
    const int lo = cur[kRowLo];
    const int hi = cur[kRowHi];
    int sp[2];  // the first two slots' plane rows, and their views
    View<Word> sv[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      sp[p] = p < d.P ? cur[kRowPreds + p] : 0;
      sv[p] = make_view(w, d, sp[p],
                        p < d.P ? cur[kRowPreds + d.P + p] : 0,
                        p < d.P ? cur[kRowPreds + 2 * d.P + p] : 0, ri);
    }
    const int cpt = (hi - lo + gn) / gn;  // ceil((hi - lo + 1) / gn)
    const int c0 = lo + gt * cpt;
    const int c1 = min(c0 + cpt, hi + 1);

    Word* ring_row = d.R ? w.ring + (ri & (d.R - 1)) * d.RW - lo : nullptr;
    Word* out = w.plane + (size_t)ri * L1;
    int amp0 = 0;
    const int pmp0 = (c0 >= 1 && c0 < c1)
        ? pred_max2(w, d, cur, k, sv, c0 - 1, ri, &amp0) : 0;
    // pass 1: the thread's running max of vals - j*g
    int slot;
    int run = INT_MIN, pmp = pmp0;
    for (int j = c0; j < c1; ++j) {
      const int pm = pred_max2(w, d, cur, k, sv, j, ri, &slot);
      int v = pm + d.g;
      if (j > 0) {
        const int sc = w.seq[j - 1];
        v = max(pmp + ((sc == b && sc >= 0) ? d.match : d.mismatch), v);
      }
      run = max(run, v - j * d.g);
      pmp = pm;
    }
    int run2 = group_prefix_max<kWarp>(run, wtot);
    // pass 2: the values from the carry, each cell's move, written out
    int amp = amp0;
    pmp = pmp0;
    for (int j = c0; j < c1; ++j) {
      int am;
      const int pm = pred_max2(w, d, cur, k, sv, j, ri, &am);
      int sub = 0;
      int v = pm + d.g;
      if (j > 0) {
        const int sc = w.seq[j - 1];
        sub = (sc == b && sc >= 0) ? d.match : d.mismatch;
        v = max(pmp + sub, v);
      }
      run2 = max(run2, v - j * d.g);
      emit_cell(d, ring_row, out, j, ri, run2 + j * d.g, pmp, sub, pm, amp,
                am, sp, cur);
      pmp = pm;
      amp = am;
    }
    flight_land(w, d, r + 1, f1, rk, nxt, gt, gn);
    f1 = f2;
    u2 = u3;
    group_sync<kWarp>();  // the row and the next row's facts are complete
    if (d.R) {  // the row's words to the plane, neighbouring threads on
                // neighbouring columns
      const Word* src = w.ring + (ri & (d.R - 1)) * d.RW;
      for (int e = gt; e <= hi - lo; e += gn) out[lo + e] = src[e];
    }
  }

  group_sync<kWarp>();  // the last row's words are in the plane
  if (gt == 0) CGA_NW_MARK(0);  // the forward pass's end
  // end cell: the best sink at column slen, ties to the smallest rank
  int vbest = cga::kNeg;
  for (int r = gt; r < d.N; r += gn) {
    const bool sink = r < w.nc &&
                      w.ld(w.nsucc + min(max(w.ld(w.order + r), 0),
                                          d.N - 1)) == 0;
    if (sink) vbest = max(vbest, end_value(w, d, r + 1, slen));
  }
  const int vmax = group_max<kWarp>(vbest, wtot);
  int rbest = INT_MAX;
  for (int r = gt; r < d.N; r += gn) {
    const bool sink = r < w.nc &&
                      w.ld(w.nsucc + min(max(w.ld(w.order + r), 0),
                                          d.N - 1)) == 0;
    if (sink && end_value(w, d, r + 1, slen) == vmax)
      rbest = min(rbest, r);
  }
  const int rend = -group_max<kWarp>(-max(rbest, -INT_MAX), wtot);
  const bool ok = vmax > Pack<Word>::kRealMin;
  if (gt != 0) return;
  CGA_NW_MARK(1);  // the end cell's
  *band_ok_out = ok;
  if (!ok) {
    *k0_out = TL;
    return;
  }

  // the walk: one plane word a step gives the move and the row it goes to
  int r = w.nc > 0 ? (rend == INT_MAX ? 0 : rend) : -1;
  int j = slen;
  int k = TL;
  while ((r >= 0 || j > 0) && k > 0) {
    int move = kHoriz, low = 0, u = -1;
    Word word = 0;
    if (r >= 0 && r < d.N) {
      word = w.plane[(size_t)(r + 1) * L1 + min(max(j, 0), d.L)];
      u = w.ld(w.order + r);  // loaded beside the word
      low = (int)(word & 255);
      move = low & 3;
    }
    --k;
    pnw[k] = move == kHoriz ? -1 : u;
    ppw[k] = move == kVert ? -1 : j - 1;
    if (move == kHoriz) {
      --j;
      continue;
    }
    const int back = low >> 2;
    const int pr = back == 0 ? 0
                   : back < kFar ? r + 1 - back
                                 : far_pred_row(w, d, r, j, move, word);
    r = pr - 1;
    if (move == kDiag) --j;
  }
  *k0_out = k;
}

// shared ints of one window's graph NW: the ring (R x RW words), two rows'
// facts and the sequence as bytes, then `extra` ints of the caller's;
// rounded up to an even count where a word is 8 bytes, so that the next
// window's ring stays aligned (ops/poa_nwtb.py nwtb_smem_bytes)
template <typename Word>
__host__ long long nwtb_smem_ints(int R, int RW, int P, int L,
                                  int extra = 0) {
  const long long n = (long long)R * RW * (long long)(sizeof(Word) / 4) +
                      2 * (kRowPreds + 3 * P) + (L + 3) / 4 + extra;
  return sizeof(Word) == 8 ? (n + 1) & ~1LL : n;
}

}  // namespace cga
