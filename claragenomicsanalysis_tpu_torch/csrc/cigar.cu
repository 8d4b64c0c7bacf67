// Run-length encodes edit paths that stay on the card, in the packed form B2
// (csrc/tb_decode.cu) writes, into CIGAR text.
//
// Replaces no TPU kernel: the JAX package reads every path back as a code
// list and formats its CIGAR on the host (cpu/nw_oracle.py path_to_cigar).
// It was added so that the pipeline's paths never reach the host as codes:
// only their text does.  The text is the one utils/cigar.py path_to_cigar
// writes for the same codes, ops from a table of four letters (compact
// "MMID" or extended "=XID"; MATCH, MISMATCH, INSERTION, DELETION).
//
// Input.  words: int32, 16 two-bit codes a word, code of slot s of a row at
// bits 2 (s & 15) of words[base + (s >> 4)].  A segment k is slots
// [first[k], end[k]) of the row at word base[k].  Path p is segments
// path_seg[p] .. path_seg[p + 1] - 1, read in order; a run that continues
// across a word or a segment is one run.  Output: each path's text followed
// by '\n', the paths one after the other.
//
// What bounds it on Hopper.  It reads each word once (16 codes a 4-byte
// word) and writes about one byte of text for every few moves: a launch of
// the pipeline moves a few MB, microseconds at 3.35 TB/s.  A path is a
// chain, though: a run's length needs where the run before it started, and
// its place in the text the bytes of every run before it.
//
// Design: two passes with an exclusive scan between them, each a warp a
// path (four a block).  The warp walks its path 32 codes at a time, a code a
// lane (the lanes' words are one or two, broadcast loads).  A lane whose
// letter differs from the code before it (its left lane's, or the run the
// warp carries from the last tile, segment or word) starts a run and closes
// the one before it: the ballot of those lanes gives each the start of the
// run it closes, so its length and bytes (digits + letter) are known in the
// lane.  The count pass sums the bytes over the warp (__reduce_add_sync) and
// writes each path's bytes; the wrapper scans them into offsets; the write
// pass takes an exclusive scan of the bytes across the lanes (shuffles) and
// each closing lane writes its run's digits and letter.  The run left open
// at the path's end is closed by lane 0, which also writes the separator.

#include "common.cuh"

namespace {

using cga::kFull;

__device__ __forceinline__ int ndigits(long long n) {
  int d = 1;
  while (n >= 10) {
    n /= 10;
    ++d;
  }
  return d;
}

// the run's `nd` digits of `len`, then its letter
__device__ __forceinline__ void write_run(uint8_t* dst, long long len,
                                          int letter, int nd) {
  dst[nd] = (uint8_t)letter;
  for (int k = nd - 1; k >= 0; --k) {
    dst[k] = (uint8_t)('0' + len % 10);
    len /= 10;
  }
}

// kWrite false: lengths[p] = the bytes of path p's text, separator included.
// kWrite true: lengths[p] = where path p's text starts; the text is written.
template <bool kWrite>
__global__ void __launch_bounds__(128)
    cigar_kernel(const uint32_t* __restrict__ words,
                 const long long* __restrict__ seg_base,
                 const long long* __restrict__ seg_first,
                 const long long* __restrict__ seg_end,
                 const long long* __restrict__ path_seg, int P,
                 unsigned letters, long long* __restrict__ lengths,
                 uint8_t* __restrict__ text) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp
  const unsigned below = (1u << lane) - 1u;
  long long g = 0;       // codes of the path walked so far
  long long run_at = 0;  // where the open run started
  int run_op = -1;       // its letter; -1 before the path's first code
  // the bytes of the closed runs (count), or where the next goes (write)
  long long at = kWrite ? lengths[p] : 0;
  const long long s_end = path_seg[p + 1];
  for (long long s = path_seg[p]; s < s_end; ++s) {
    const uint32_t* w = words + seg_base[s];
    const long long end = seg_end[s];
    long long tile = seg_first[s];
    if (tile < 0) tile = 0;
    for (; tile < end; tile += 32) {
      const long long slot = tile + lane;
      const bool live = slot < end;  // the live lanes are a prefix
      int op = -1;
      if (live)
        op = (letters >> (8 * ((w[slot >> 4] >> (2 * (slot & 15))) & 3))) &
             0xff;
      int prev = __shfl_up_sync(kFull, op, 1);
      if (lane == 0) prev = run_op;
      const bool starts = live && op != prev;
      const unsigned mask = __ballot_sync(kFull, starts);
      // a run starting here closes the one before it, if there is one
      int bytes = 0;
      long long len = 0;
      if (starts && prev >= 0) {
        const unsigned lower = mask & below;
        const long long from = lower ? g + (31 - __clz(lower)) : run_at;
        len = g + lane - from;
        bytes = ndigits(len) + 1;
      }
      if constexpr (kWrite) {
        int upto = bytes;  // inclusive scan of the bytes over the lanes
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kFull, upto, d);
          if (lane >= d) upto += v;
        }
        if (bytes) write_run(text + at + upto - bytes, len, prev, bytes - 1);
        at += __shfl_sync(kFull, upto, 31);
      } else {
        at += __reduce_add_sync(kFull, bytes);
      }
      if (mask) {
        const int top = 31 - __clz(mask);
        run_at = g + top;
        run_op = __shfl_sync(kFull, op, top);
      }
      g += min(32LL, end - tile);
    }
  }
  if (lane != 0) return;
  if (run_op >= 0) {  // the run open at the path's end
    const long long len = g - run_at;
    const int nd = ndigits(len);
    if constexpr (kWrite) write_run(text + at, len, run_op, nd);
    at += nd + 1;
  }
  if constexpr (kWrite)
    text[at] = '\n';
  else
    lengths[p] = at + 1;
}

}  // namespace

// Launches one pass on `stream` and returns cudaGetLastError() as an int.
// words (N,) int32; seg_base, seg_first, seg_end (S,) int64; path_seg
// (P + 1,) int64; letters: the op letter of code c in byte c.  write 0: the
// count pass, lengths (P,) int64 gets each path's bytes, text unused; write
// 1: lengths holds each path's offset (the exclusive scan of the counts) and
// text (their sum) uint8 gets the text.
extern "C" int cga_cigar(const void* words, const void* seg_base,
                         const void* seg_first, const void* seg_end,
                         const void* path_seg, void* lengths, void* text,
                         int P, int letters, int write, void* stream) {
  if (P <= 0) return 0;
  const int warps = 4;
  const dim3 grid((P + warps - 1) / warps);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* b = static_cast<const long long*>(seg_base);
  const auto* f = static_cast<const long long*>(seg_first);
  const auto* e = static_cast<const long long*>(seg_end);
  const auto* ps = static_cast<const long long*>(path_seg);
  auto* len = static_cast<long long*>(lengths);
  auto* out = static_cast<uint8_t*>(text);
  const auto st = (cudaStream_t)stream;
  if (write)
    cigar_kernel<true><<<grid, 32 * warps, 0, st>>>(
        w, b, f, e, ps, P, (unsigned)letters, len, out);
  else
    cigar_kernel<false><<<grid, 32 * warps, 0, st>>>(
        w, b, f, e, ps, P, (unsigned)letters, len, out);
  return (int)cudaGetLastError();
}
