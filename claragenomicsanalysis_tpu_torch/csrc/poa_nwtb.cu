// Sequence-to-graph Needleman-Wunsch and its canonical traceback, one added
// sequence per window.
//
// Replaces: claragenomicsanalysis_tpu/ops/poa_pallas2.py::_nwtb_pallas
// (kernel body built by _build_nwtb_kernel); spec poa_ops.graph_nw and
// poa_ops.nw_traceback.  The outputs equal the plain PyTorch version in
// ops/poa_nwtb.py.
//
// The score plane has N + 1 rows (row 0 the virtual source, j * gap; row
// r + 1 the node of rank r) of L + 1 columns.  Row r + 1 takes per column
// the max over its node's pred rows (a masked pred slot counting as NEG),
// then diag / vert and the in-row gap chain in closed form,
// row[j] = j*g + cummax(vals[j] - j*g), an inclusive max-scan; with a band
// only |j - ((r+1)*slen)//(nc+1)| <= band_width/2 is kept.  Only columns
// 0..slen are computed: no column past slen feeds one at or before it, and
// the traceback starts at column slen.  Rows of rank >= node_count read as
// NEG.  Unreachable cells hold NEG = -2^30 in the spec.
//
// What bounds it on Hopper.  Per live cell, a pred-slot load and max per
// pred, a compare, two adds and the scan step: integer work far below the
// card's int32 rate, and bytes far below its memory rate.  A window is a
// chain of node_count dependent rows and then a serial walk of about
// node_count + slen steps, so latency bounds it.  On the first design (one
// block a window, pred rows read back from device memory, two barriers and a
// serial loop over the warp totals a row, the walk testing every pred slot
// with 1 + 2k loads a step) a row took about 4,000 SM cycles and a walk
// step about 1,550; the forward pass was 74-78 % of a window, the walk
// 21-25 % (PERF.md, B5's split, H100).
//
// Design.
// - A window is one warp (several windows a block, no block barrier, the
//   in-row max-scan a 5-step __shfl_up_sync scan) or one block (the warp
//   totals scanned through shared memory, two barriers a row); the wrapper
//   picks (ops/poa_nwtb.py nwtb_plan): a warp where a row fits 512 columns
//   and the launch has more windows than 8 an SM, else a block of four
//   warps (or about four columns a thread for wider rows), since a row's
//   time is the serial work of the thread with the most columns.  Both are
//   one body, templated on the group.
// - A row is two passes over the thread's columns, as in nw_row.cu: the
//   running max of vals - j*g, the scan, then the values again from the
//   carry, written out.  Each thread loops over its contiguous run of
//   columns (the pred maxima read twice from shared memory), so no width
//   is refused and the loop's code stays small.
// - A row's facts (in-degree, base, band, each pred slot's plane row and
//   band) are loaded three rows ahead, a stage of their chain of dependent
//   loads a row, and land in shared memory one row ahead, so the loads
//   overlap the rows' work and no division runs per cell.
// - Only the band's columns are computed when banded.  A pred's cell
//   outside its own band, or in a row not yet computed, reads NEG, so no
//   column outside the band is ever written.
// - A shared-memory ring of the last R rows (R a power of two, 8 by
//   default) serves preds fewer than R ranks back, which at the measured
//   shapes is every pred (PERF.md); older preds are read from the plane in
//   device memory, which every row is written to.  R = 0 runs without the
//   ring.
// - The plane's word holds the cell's value in its high 24 bits and, in
//   the low 8, the move the traceback takes from the cell (diagonal,
//   vertical or horizontal, by the spec's priority) and how many rows back
//   it goes (0 for the virtual row), decided while the forward pass has
//   the value in hand.  A row's words go to the ring and, after the row,
//   to the plane with neighbouring threads on neighbouring columns.  The
//   walk then makes one dependent plane load a step, instead of 1 + 2k;
//   only a move 63 or more rows back looks its pred slot up again by value.
//   Where every real cell's value fits 24 bits (|score| x (N + L + 1) <
//   2^22, ops/poa_nwtb.py nwtb_word_bytes) the word is an int32 and a value
//   that derives from NEG is stored as -2^23; neither the walk nor the end
//   cell ever reads such a cell as real (a real cell never equals one
//   derived from NEG), so the outputs equal the spec's, which keeps NEG
//   sums unsaturated.  Past that the word is an int64 holding the int32
//   value exactly (template Word; the ring and the plane twice the bytes).
// - A pred slot count has no limit: a thread carries two slots of each row
//   in flight, and the slots past those (more than 64 on a warp) are loaded
//   when the row's facts land.
// - The end cell is a reduction over the sinks at column slen.
// A window that is not alive, or whose best sink lies outside the band,
// gets the inert path.

#include "poa_nwtb.cuh"

namespace {

using namespace cga;

#define NWTB_PARAMS                                                          \
  const int32_t *__restrict__ seq, const int32_t *__restrict__ order,        \
      const int32_t *__restrict__ rank, const int32_t *__restrict__ npred,   \
      const int32_t *__restrict__ base, const int32_t *__restrict__ nsucc,   \
      const int32_t *__restrict__ pred, const int32_t *__restrict__ slens,   \
      const int32_t *__restrict__ node_counts,                               \
      const int32_t *__restrict__ alive, Word *__restrict__ planes,          \
      int32_t *__restrict__ pn, int32_t *__restrict__ pp,                    \
      int32_t *__restrict__ k0s, int32_t *__restrict__ band_oks, int W,      \
      Dims d, int per
#define NWTB_ARGS                                                             \
  seq, order, rank, npred, base, nsucc, pred, slens, node_counts, alive,      \
      planes, pn, pp, k0s, band_oks, W, d, per

// kWarp: blockDim.x / 32 windows a block, one a warp; else one a block.
// per: the shared ints of a window (nwtb_smem_ints).
template <bool kWarp, typename Word>
__device__ __forceinline__ void nwtb_kernel_body(NWTB_PARAMS) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int wtot[32];
  const int slot = kWarp ? threadIdx.x >> 5 : 0;
  const int w = kWarp ? blockIdx.x * (blockDim.x >> 5) + slot : blockIdx.x;
  if (w >= W) return;  // a whole warp (kWarp) or block leaves
  const int gt = kWarp ? threadIdx.x & 31 : threadIdx.x;
  const int gn = kWarp ? 32 : blockDim.x;
  const int TL = d.N + d.L;
  int32_t* pnw = pn + (size_t)w * TL;
  int32_t* ppw = pp + (size_t)w * TL;
  for (int i = gt; i < TL; i += gn) {
    pnw[i] = -2;
    ppw[i] = -2;
  }
  if (!alive[w]) {
    if (gt == 0) {
      k0s[w] = TL;
      band_oks[w] = 0;
    }
    return;
  }
  const size_t wn = (size_t)w * d.N;
  Window<Word, true> win;

  win.order = order + wn;
  win.rank = rank + wn;
  win.npred = npred + wn;
  win.base = base + wn;
  win.nsucc = nsucc + wn;
  win.pred = pred + wn * d.P;
  win.plane = planes + (size_t)w * (d.N + 1) * (d.L + 1);
  win.ring = reinterpret_cast<Word*>(smem + slot * per);
  win.rows = reinterpret_cast<int32_t*>(win.ring + d.R * d.RW);
  int8_t* sq = reinterpret_cast<int8_t*>(win.rows + 2 * (kRowPreds + 3 * d.P));
  for (int i = gt; i < d.L; i += gn) sq[i] = (int8_t)seq[(size_t)w * d.L + i];
  win.seq = sq;  // visible after nwtb_window's first sync
  win.slen = slens[w];
  win.nc = node_counts[w];
  win.nce = min(max(win.nc, 0), d.N);
  nwtb_window<kWarp>(win, d, gt, gn, wtot, pnw, ppw, k0s + w, band_oks + w);
}

template <typename Word>
__global__ void nwtb_warp_kernel(NWTB_PARAMS) {
  nwtb_kernel_body<true, Word>(NWTB_ARGS);
}

// a block a window may have up to 1,024 threads: bound its registers so
// that such a block always fits an SM
template <typename Word>
__global__ void __launch_bounds__(1024) nwtb_block_kernel(NWTB_PARAMS) {
  nwtb_kernel_body<false, Word>(NWTB_ARGS);
}

template <typename Word>
int launch(const void* const* in, void* plane, void* const* out, int W,
           const Dims& d, int group, int threads, cudaStream_t stream) {
  const int windows = group == 0 ? threads / 32 : 1;
  const long long per = nwtb_smem_ints<Word>(d.R, d.RW, d.P, d.L);
  const long long smem = 4LL * windows * per;
  const int blocks = (W + windows - 1) / windows;
  auto kernel = group != 0 ? nwtb_block_kernel<Word> : nwtb_warp_kernel<Word>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const auto i32 = [&](int k) { return static_cast<const int32_t*>(in[k]); };
  const auto o32 = [&](int k) { return static_cast<int32_t*>(out[k]); };
  kernel<<<blocks, threads, (size_t)smem, stream>>>(
      i32(0), i32(1), i32(2), i32(3), i32(4), i32(5), i32(6), i32(7), i32(8),
      i32(9), static_cast<Word*>(plane), o32(0), o32(1), o32(2), o32(3), W, d,
      (int)per);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// seq (W, L), order, rank, npred, base, nsucc (W, N), pred (W, N, P), slen,
// node_count, alive (W,) int32; plane is a work buffer of W * (N + 1) *
// (L + 1) words of `word` bytes (4: int32, values in 24 bits; 8: int64);
// writes pn, pp (W, N + L), k0 and band_ok (W,) int32.  group is 0 for a
// warp a window (`threads` / 32 windows a block) and 1 for a block of
// `threads` a window; ring is R (0 or a power of two), rw the columns of a
// ring row.
extern "C" int cga_poa_nwtb(const void* seq, const void* order,
                            const void* rank, const void* npred,
                            const void* base, const void* nsucc,
                            const void* pred, const void* slen,
                            const void* node_count, const void* alive,
                            void* plane, void* pn, void* pp, void* k0,
                            void* band_ok, int W, int N, int P, int L,
                            int match, int mismatch, int gap, int band_width,
                            int group, int threads, int ring, int rw,
                            int word, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 ||
      (ring & (ring - 1)) || (word != 4 && word != 8))
    return (int)cudaErrorInvalidValue;
  const Dims d{N, P, L, ring, rw, match, mismatch, gap, band_width / 2,
               band_width > 0};
  const void* in[10] = {seq,  order, rank,       npred, base,
                        nsucc, pred, slen, node_count, alive};
  void* out[4] = {pn, pp, k0, band_ok};
  const cudaStream_t s = (cudaStream_t)stream;
  return word == 8 ? launch<long long>(in, plane, out, W, d, group, threads, s)
                   : launch<int32_t>(in, plane, out, W, d, group, threads, s);
}
