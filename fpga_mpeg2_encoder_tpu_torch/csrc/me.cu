// Motion estimation + prediction (stages X/Y/Z/F, RTL/mpeg2encoder.v:1310-1918).
//
// Three kernels.  The first two share their device functions and run one
// block of 128 threads per macroblock:
// * me_fused_kernel: luma search + luma prediction + U/V prediction.
//   Replaces ops/pallas/me.py::motion_estimate_fused_pallas of the JAX
//   package (body _kernel_fused); plain version
//   ops/motion.py::estimate_and_predict_local.
// * me_luma_kernel: the luma half alone.  Replaces motion_estimate_pallas
//   (body _me_body); plain version ops/motion.py::estimate_luma.
// * chroma_pred_kernel: the U/V half from (inter, mvx, mvy) maps in device
//   memory.  Replaces chroma_pred_pallas (body _chroma_predict); plain
//   version ops/motion.py::chroma_pred.  Its own design, one warp per
//   macroblock (see chroma_pred_kernel): the fused kernel keeps its
//   chroma_predict stage.
//
// What bounds it: per P-frame macroblock the search does (2*yr+1)^2 * 256
// absolute differences (169 * 256 at yr = 6) against 640 bytes of input
// pixels and 384 bytes of uint8 predictions out, so it is bound by integer
// instructions, not by device memory (at 1920x1152: 398 M
// absolute-difference adds, four to a VABSDIFF4 instruction, against 8.3 MB).
// The design spends as few instructions as it can on each difference:
// * The 16x16 block (64 words) and the reference window sit in shared
//   memory as BYTES: 30 rows (-yr-1 .. 16+yr at yr = 6) of 32 bytes from
//   column x0 - 8, an 8-byte-aligned column since x0 is a multiple of 16.
//   The window is filled with one 8-byte load per thread, and the columns
//   outside the plane are whole 8-byte words, zeroed, as the reference's
//   padding reads.
// * The full-pel search runs on thread (dy, block rows r and r + 8): 8
//   lanes a dy, 13 dy on 104 of the 128 threads.  A thread loads each of
//   its two window rows' 8 words and block rows' 4 words once into
//   registers and forms the row SADs of all 13 dx from them: each dx takes
//   its 4 words of the window row aligned by funnel shifts (shared between
//   dx) and 4 byte-SIMD absolute-difference adds (__vsadu4's vabsdiff4 with
//   its accumulator).  The sums are packed two to a word, and an 8-lane
//   shuffle sum gives each candidate's SAD.  Warp 3 loads the block and
//   sums its pixels beside the window loads.
// * The half-pel stage takes two pixels a thread: their 3x3 neighbourhoods
//   around the winner come from the window bytes, 5 warp reductions of
//   packed pairs give the 10 sums, and one warp takes the decision.
// The predictions are written as uint8 (values 0..255), the transform
// kernel's input.  An I-frame skips the search: the reference returns
// inter 0, mv 0 and prediction 128 for it (me.py:268-281, and the chroma
// inter select at me.py:345).
//
// Signed right shifts of negative ints are arithmetic (nvcc's behaviour, and
// what the reference's >> means).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ME_THREADS = 128;       // two pixels of the 16x16 block each
constexpr int MAX_YR = 6;             // vector_level 3
constexpr int NCAND = 2 * MAX_YR + 1; // dx (and dy) values at MAX_YR
constexpr int WROWS = 18 + 2 * MAX_YR;   // window rows -MAX_YR-1 .. 16+MAX_YR
constexpr int WCOL0 = 8;              // window byte 0 is column x0 - 8
// Window row stride in words: 32 bytes used, 16 padding, so that the 16-byte
// loads of 8 lanes on 8 consecutive rows fall in 32 distinct banks.
constexpr int WSTR = 12;
constexpr unsigned BIG = 1u << 24;    // key of an invalid candidate (me.py:151)

struct __align__(16) LumaShared {
  uint32_t win[WROWS * WSTR];         // reference bytes, rows -7 .. 22
  uint32_t cur[64];                   // the 16x16 block, 4 words a row
  unsigned part[ME_THREADS / 32][5];  // per-warp half-pel sums, two to a word
  unsigned kpart[ME_THREADS / 32];    // per-warp minimum keys
  int32_t pixsum;
  int32_t idx;                        // the decision: 0..8 half-pel, 9 intra
};

struct LumaResult {
  int inter, mvx, mvy;
};

// acc + the sum of the four byte absolute differences of a and b: the PTX of
// __vsadu4 (vabsdiff4 with .add), given the running sum in place of 0 so
// that the add is part of the one instruction.
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// Bytes o .. o+3 of a window row held as 8 little-endian words.
__device__ __forceinline__ uint32_t win_word(const uint32_t (&wv)[8], int o) {
  const int q = o >> 2, sh = (o & 3) * 8;
  return sh ? __funnelshift_r(wv[q], wv[q + 1], sh) : wv[q];
}

// acc + the SAD of a block row (4 words) against the window row at byte o.
__device__ __forceinline__ uint32_t row_sad(const uint32_t (&wv)[8],
                                            const uint32_t (&cv)[4], int o,
                                            uint32_t acc) {
#pragma unroll
  for (int j = 0; j < 4; j++) acc = sad4(win_word(wv, o + 4 * j), cv[j], acc);
  return acc;
}

// The inter/intra decision from the 10 sums (the 9 half-pel candidates, then
// the mean deviation): the index 0..8 of the half-pel candidate, or 9, intra.
__device__ __forceinline__ int decide(const int (&hsum)[10], int pixsum, int yr,
                                      bool edge_l, bool edge_r, bool edge_t,
                                      bool edge_b, int mvx_full, int mvy_full) {
  // ---- candidate masks (me.py:233-245): a half step off the frame edge or
  // past the search range (mv_full == +-yr) is invalid; invalid or 12-bit
  // overflow -> the 0x1000 substitute -------------------------------------
  int vals[10];
#pragma unroll
  for (int hy = -1; hy <= 1; hy++) {
#pragma unroll
    for (int hx = -1; hx <= 1; hx++) {
      const int k = (hy + 1) * 3 + hx + 1;
      bool bad = false;
      if (hx < 0) bad = bad || edge_l || mvx_full == -yr;
      if (hx > 0) bad = bad || edge_r || mvx_full == yr;
      if (hy < 0) bad = bad || edge_t || mvy_full == -yr;
      if (hy > 0) bad = bad || edge_b || mvy_full == yr;
      const int s = hsum[k];
      vals[k] = (bad || s > 4095) ? 0x1000 : s;
    }
  }
  // f_Y_sum quirk: the 16-bit accumulator adds the pixel sum to the mean
  // deviation, clipped to 0xFFF (me.py:246-248, RTL:1659-1662/1774-1791)
  const int acc = (pixsum + hsum[9]) & 0xFFFF;
  vals[9] = acc < 4096 ? acc : 0xFFF;

  // ---- find_min_in_10_values (me.py:251-266, RTL:804-840): pairs keep the
  // low index on ties, and the 8/9 pair wins with <= against both halves ---
  int w01 = vals[0], i01 = 0, w23 = vals[2], i23 = 2, w45 = vals[4], i45 = 4;
  int w67 = vals[6], i67 = 6, w89 = vals[8], i89 = 8;
  if (vals[1] < w01) { w01 = vals[1]; i01 = 1; }
  if (vals[3] < w23) { w23 = vals[3]; i23 = 3; }
  if (vals[5] < w45) { w45 = vals[5]; i45 = 5; }
  if (vals[7] < w67) { w67 = vals[7]; i67 = 7; }
  if (vals[9] < w89) { w89 = vals[9]; i89 = 9; }
  const int x0123 = w23 < w01 ? w23 : w01, i0123 = w23 < w01 ? i23 : i01;
  const int x4567 = w67 < w45 ? w67 : w45, i4567 = w67 < w45 ? i67 : i45;
  const int left = x0123 < x4567 ? i0123 : i4567;
  return (w89 <= x0123 && w89 <= x4567) ? i89 : left;
}

// Luma search + prediction of macroblock (by, bx) of a band of nby rows.
// prev holds the band's reference with halo_rows extra rows above and below.
// All ME_THREADS threads call it; all get the macroblock's result.
__device__ LumaResult luma_me(
    LumaShared& sh, const uint8_t* __restrict__ cur,
    const uint8_t* __restrict__ prev, uint8_t* __restrict__ pred_y,
    int by, int bx, int nby, int nbx, int halo_rows, int yr, int iframe,
    int first_mb_row, int total_mb_rows, int as_plane) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int r = tid >> 4, c = tid & 15;           // pixels (r, c) and (r + 8, c)
  const int w = nbx * 16, y0 = by * 16, x0 = bx * 16;
  const size_t opix = as_plane ? (size_t)(y0 + r) * w + x0 + c
                               : ((size_t)by * nbx + bx) * 256 + tid;
  const size_t ostep = as_plane ? (size_t)8 * w : 128;   // to pixel (r + 8, c)
  if (iframe) {                       // me.py:268-281: intra, mv 0, pred 128
    pred_y[opix] = 128;
    pred_y[opix + ostep] = 128;
    return {0, 0, 0};
  }
  const int n = 2 * yr + 1;
  const int prev_rows = nby * 16 + 2 * halo_rows;

  // ---- the window and the block into shared memory, 8 bytes a thread ------
  if (tid < WROWS * 4) {
    const int i = tid >> 2, seg = tid & 3;
    const int py = y0 - MAX_YR - 1 + i + halo_rows, px = x0 - WCOL0 + seg * 8;
    uint2 v = make_uint2(0u, 0u);     // zero outside the plane (me.py:90-96)
    if (py >= 0 && py < prev_rows && px >= 0 && px < w)
      v = *reinterpret_cast<const uint2*>(prev + (size_t)py * w + px);
    *reinterpret_cast<uint2*>(sh.win + i * WSTR + seg * 2) = v;
  }
  if (wid == 3) {                     // the block, and its pixel sum for the intra term
    const int row = lane >> 1, half = lane & 1;
    const uint2 v = *reinterpret_cast<const uint2*>(cur + (size_t)(y0 + row) * w + x0 + half * 8);
    *reinterpret_cast<uint2*>(sh.cur + row * 4 + half * 2) = v;
    const unsigned ps = __reduce_add_sync(0xffffffffu, __vsadu4(v.x, 0u) + __vsadu4(v.y, 0u));
    if (lane == 0) sh.pixsum = (int)ps;
  }
  __syncthreads();

  // Frame edges on GLOBAL macroblock rows, so a band's seams are not edges
  // (me.py:111-112).
  const bool edge_l = bx == 0, edge_r = bx == nbx - 1;
  const bool edge_t = first_mb_row + by == 0;
  const bool edge_b = first_mb_row + by == total_mb_rows - 1;

  // ---- full-pel SADs (me.py:132-142): thread (dy, rows r8 and r8 + 8) ------
  const int r8 = lane & 7;
  const int dy = 4 * wid + (lane >> 3) - MAX_YR;   // -6 .. 9
  const bool search = dy >= -yr && dy <= yr;      // uniform per 8 lanes
  // SADs of dx = k - MAX_YR (window byte k + 2) over the thread's two rows,
  // two to a word: dx k in the low half, k + 1 in the high.  A row SAD is
  // at most 16 * 255 and 16 rows at most 65280, so the halves never carry
  // into each other.
  uint32_t rs[(NCAND + 1) / 2] = {};
  if (search) {
    uint32_t lo[(NCAND + 1) / 2] = {}, hi[NCAND / 2] = {};
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int row = r8 + 8 * h;
      const uint4* wr = reinterpret_cast<const uint4*>(sh.win + (row + dy + MAX_YR + 1) * WSTR);
      const uint4 a = wr[0], b = wr[1];
      const uint32_t wv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      const uint4 cq = reinterpret_cast<const uint4*>(sh.cur)[row];
      const uint32_t cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
      for (int k = 0; k < NCAND; k++) {
        if (k & 1) hi[k >> 1] = row_sad(wv, cv, k + WCOL0 - MAX_YR, hi[k >> 1]);
        else lo[k >> 1] = row_sad(wv, cv, k + WCOL0 - MAX_YR, lo[k >> 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < (NCAND + 1) / 2; j++) rs[j] = lo[j] | (j < NCAND / 2 ? hi[j] << 16 : 0u);
  }
  // the sum over the 8 lanes of each dy, in every warp (converged)
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < (NCAND + 1) / 2; j++) rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], off);

  // The key of candidate (dy, dx) with SAD s, BIG if it may not win.
  auto cand_key = [&](int s, int dx) -> unsigned {
    if (!search || dx < -yr || dx > yr) return BIG;
    // 12-bit SAD overflow -> invalid (me.py:148, RTL:1670); frame-edge
    // masks: no candidate left of the left edge, etc. (me.py:148-150)
    const bool invalid = s > 4095 || (edge_l && dx < 0) || (edge_r && dx > 0) ||
                         (edge_t && dy < 0) || (edge_b && dy > 0);
    // Tie-break: the least SAD, then the largest dy, then the largest dx,
    // i.e. the largest linear index: key sad*256 + (255 - lin)
    // (me.py:152-153).  The key orders candidates by itself, so the split
    // of the minimum over threads does not matter.
    const unsigned lin = (unsigned)((dy + yr) * n + dx + yr);
    return invalid ? BIG : (unsigned)s * 256u + (255u - lin);
  };
  // lane r8 of a dy takes the candidates k = r8 and k = r8 + 8
  const int j = r8 >> 1, hs = (r8 & 1) * 16;
  uint32_t p1 = rs[0], p2 = rs[4];
#pragma unroll
  for (int jj = 1; jj < 4; jj++)
    if (j == jj) p1 = rs[jj];
#pragma unroll
  for (int jj = 1; jj < 3; jj++)
    if (j == jj) p2 = rs[4 + jj];
  unsigned key = cand_key((int)((p1 >> hs) & 0xFFFFu), r8 - MAX_YR);
  if (r8 + 8 < NCAND) key = min(key, cand_key((int)((p2 >> hs) & 0xFFFFu), r8 + 8 - MAX_YR));
  const unsigned wmin = __reduce_min_sync(0xffffffffu, key);
  if (lane == 0) sh.kpart[wid] = wmin;
  __syncthreads();
  unsigned kmin = BIG;
  for (int k = 0; k < ME_THREADS / 32; k++) kmin = min(kmin, sh.kpart[k]);
  const int pixsum = sh.pixsum;
  // every candidate invalid -> the centre, mv (0, 0) (me.py:155)
  const int lin = kmin >= BIG ? yr * n + yr : 255 - (int)(kmin & 255u);
  const int mvy_full = lin / n - yr, mvx_full = lin % n - yr;

  // ---- half-pel candidates of the thread's two pixels (me.py:200-222) -----
  // Candidate (hy, hx) at pixel (r, c) is the rounded mean of the reference
  // at (r, c) + mv_full + {0, hy} x {0, hx}: (1+a+b)>>1 on a line,
  // (1+a+b+c+d)>>2 on a diagonal (me.py:200-204).
  // intra metric: mean = (pixsum >> 8) & 0xFF (me.py:159-160)
  const int mean = (pixsum >> 8) & 0xFF;
  int cand[2][9], dsum[10] = {};
#pragma unroll
  for (int h = 0; h < 2; h++) {
    int nb[3][3];
    const uint8_t* wc = reinterpret_cast<const uint8_t*>(sh.win) +
                        (r + 8 * h + mvy_full + MAX_YR + 1) * (WSTR * 4) + c + mvx_full + WCOL0;
#pragma unroll
    for (int i = 0; i < 3; i++)
#pragma unroll
      for (int jx = 0; jx < 3; jx++) nb[i][jx] = wc[(i - 1) * (WSTR * 4) + jx - 1];
    const int cp = reinterpret_cast<const uint8_t*>(sh.cur)[tid + 128 * h];
#pragma unroll
    for (int hy = -1; hy <= 1; hy++) {
#pragma unroll
      for (int hx = -1; hx <= 1; hx++) {
        const int a = nb[1][1], b = nb[1][1 + hx], cc = nb[1 + hy][1], d = nb[1 + hy][1 + hx];
        int v;
        if (hy == 0 && hx == 0) v = a;
        else if (hy == 0) v = (1 + a + b) >> 1;
        else if (hx == 0) v = (1 + a + cc) >> 1;
        else v = (1 + a + b + cc + d) >> 2;
        const int k = (hy + 1) * 3 + hx + 1;
        cand[h][k] = v;
        dsum[k] += abs(cp - v);
      }
    }
    dsum[9] += abs(cp - mean);
  }
  // The 10 sums two to a word: each is at most 256 * 255 < 2^16, so the
  // halves never carry into each other.
#pragma unroll
  for (int k = 0; k < 10; k += 2) {
    const unsigned s = __reduce_add_sync(0xffffffffu,
                                         (unsigned)dsum[k] | ((unsigned)dsum[k + 1] << 16));
    if (lane == 0) sh.part[wid][k >> 1] = s;
  }
  __syncthreads();
  if (wid == 0) {                     // the decision, by one warp
    int hsum[10];
#pragma unroll
    for (int jj = 0; jj < 5; jj++) {
      unsigned t = 0;
      for (int k = 0; k < ME_THREADS / 32; k++) t += sh.part[k][jj];
      hsum[2 * jj] = (int)(t & 0xFFFFu);
      hsum[2 * jj + 1] = (int)(t >> 16);
    }
    const int d = decide(hsum, pixsum, yr, edge_l, edge_r, edge_t, edge_b, mvx_full,
                         mvy_full);
    if (lane == 0) sh.idx = d;
  }
  __syncthreads();
  const int idx = sh.idx;

  // P-frame: the mv registers update even when intra wins (me.py:272-273,
  // RTL:1827-1828)
  const int inter = idx != 9;
  const int hy_sel = idx == 9 ? 0 : idx / 3 - 1;
  const int hx_sel = idx == 9 ? 0 : idx % 3 - 1;
#pragma unroll
  for (int h = 0; h < 2; h++) {
    int p = 128;
#pragma unroll
    for (int k = 0; k < 9; k++)
      if (inter && idx == k) p = cand[h][k];
    pred_y[opix + h * ostep] = (uint8_t)p;
  }
  return {inter, mvx_full * 2 + hx_sel, mvy_full * 2 + hy_sel};
}

// Reference pixel (fy, fx) of a chroma band with halo_rows extra rows above
// and below; zero outside the plane.
__device__ __forceinline__ int cpix(const uint8_t* __restrict__ plane, int fy,
                                    int fx, int rows, int halo_rows, int wc) {
  const int py = fy + halo_rows;
  return (py >= 0 && py < rows && fx >= 0 && fx < wc) ? plane[(size_t)py * wc + fx] : 0;
}

// U/V prediction of macroblock (by, bx): threads 0..63 the U tile, 64..127
// the V tile (me.py:299-345, RTL:1847-1917).
__device__ void chroma_predict(
    const uint8_t* __restrict__ prev_u, const uint8_t* __restrict__ prev_v,
    uint8_t* __restrict__ pred_u, uint8_t* __restrict__ pred_v,
    int by, int bx, int nby, int nbx, int halo_rows, int as_plane,
    int inter, int mvx, int mvy) {
  const int tid = threadIdx.x;
  const uint8_t* plane = tid < 64 ? prev_u : prev_v;
  uint8_t* out = tid < 64 ? pred_u : pred_v;
  const int p = tid & 63, r = p >> 3, c = p & 7;
  const int wc = nbx * 8, rows = nby * 8 + 2 * halo_rows;
  int v = 128;
  if (inter) {
    // arithmetic mv >> 2 and (mv >> 1) & 1 on negative mvs (me.py:363-364)
    const int fy = by * 8 + (mvy >> 2) + r, fx = bx * 8 + (mvx >> 2) + c;
    const bool hy = (mvy >> 1) & 1, hx = (mvx >> 1) & 1;
    const int a = cpix(plane, fy, fx, rows, halo_rows, wc);
    const int b = hx ? cpix(plane, fy, fx + 1, rows, halo_rows, wc) : 0;
    const int cc = hy ? cpix(plane, fy + 1, fx, rows, halo_rows, wc) : 0;
    const int d = hx && hy ? cpix(plane, fy + 1, fx + 1, rows, halo_rows, wc) : 0;
    // rounding as me.py:338-340
    if (hy && hx) v = (1 + a + b + cc + d) >> 2;
    else if (hx) v = (1 + a + b) >> 1;
    else if (hy) v = (1 + a + cc) >> 1;
    else v = a;
  }
  out[as_plane ? (size_t)(by * 8 + r) * wc + bx * 8 + c
               : ((size_t)by * nbx + bx) * 64 + p] = (uint8_t)v;
}

__global__ void __launch_bounds__(ME_THREADS) me_fused_kernel(
    const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev_y,
    const uint8_t* __restrict__ prev_u, const uint8_t* __restrict__ prev_v,
    const int32_t* __restrict__ i_frame, uint8_t* __restrict__ inter,
    int32_t* __restrict__ mvx, int32_t* __restrict__ mvy,
    uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_u,
    uint8_t* __restrict__ pred_v, int nby, int nbx, int yr, int first_mb_row,
    int total_mb_rows, int halo, int as_plane) {
  __shared__ LumaShared sh;
  const int mb = blockIdx.x, by = mb / nbx, bx = mb - by * nbx;
  const LumaResult res = luma_me(sh, cur, prev_y, pred_y, by, bx, nby, nbx,
                                 halo ? 8 : 0, yr, *i_frame == 0, first_mb_row,
                                 total_mb_rows, as_plane);
  if (threadIdx.x == 0) {
    inter[mb] = (uint8_t)res.inter;
    mvx[mb] = res.mvx;
    mvy[mb] = res.mvy;
  }
  // the mv and inter maps go to chroma in registers
  chroma_predict(prev_u, prev_v, pred_u, pred_v, by, bx, nby, nbx,
                 halo ? 4 : 0, as_plane, res.inter, res.mvx, res.mvy);
}

__global__ void __launch_bounds__(ME_THREADS) me_luma_kernel(
    const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev_y,
    const int32_t* __restrict__ i_frame, uint8_t* __restrict__ inter,
    int32_t* __restrict__ mvx, int32_t* __restrict__ mvy,
    uint8_t* __restrict__ pred_y, int nby, int nbx, int yr, int first_mb_row,
    int total_mb_rows, int halo, int as_plane) {
  __shared__ LumaShared sh;
  const int mb = blockIdx.x, by = mb / nbx, bx = mb - by * nbx;
  const LumaResult res = luma_me(sh, cur, prev_y, pred_y, by, bx, nby, nbx,
                                 halo ? 8 : 0, yr, *i_frame == 0, first_mb_row,
                                 total_mb_rows, as_plane);
  if (threadIdx.x == 0) {
    inter[mb] = (uint8_t)res.inter;
    mvx[mb] = res.mvx;
    mvy[mb] = res.mvy;
  }
}

// C, chroma_pred_kernel: bound by its 2.3 MB at 1920x1152 (U and V read,
// the predictions written), a few bytes per macroblock.  One warp per
// macroblock, CHROMA_WARPS macroblocks a block: lane (plane, row 0-7, half
// 0-1) is 32 lanes, U and V of one macroblock.  A lane forms its 4 output
// bytes as one word: it loads the two aligned words under bytes fx .. fx+4
// of its reference row (and of the next row when hy is set) and aligns them
// with funnel shifts; a word outside the plane reads as 0, as cpix reads.
// The two-tap average is __vavgu4 ((1 + a + b) >> 1 a byte); the four-tap one
// is summed in 16-bit lanes, even and odd bytes apart, since two rounded
// pair averages round twice.  The word is stored aligned, in tiles or in
// the plane.
constexpr int CHROMA_WARPS = 8;

// Word w (bytes 4w .. 4w+3) of row py of a chroma plane of wc4 words a row
// and `rows` rows; 0 outside the plane.
__device__ __forceinline__ uint32_t cword(const uint32_t* __restrict__ plane, int py, int w,
                                          int rows, int wc4) {
  return py >= 0 && py < rows && w >= 0 && w < wc4 ? __ldg(plane + (size_t)py * wc4 + w) : 0u;
}

// Bytes fx .. fx+3 of row py (a) and their right neighbours fx+1 .. fx+4 (b),
// byte k of the word the pixel at column fx + k.
__device__ __forceinline__ void crow(const uint32_t* __restrict__ plane, int py, int fx,
                                     int rows, int wc4, uint32_t& a, uint32_t& b) {
  const int w = fx >> 2, sh = 8 * (fx & 3);        // fx >> 2 floors negative columns
  const uint32_t w0 = cword(plane, py, w, rows, wc4), w1 = cword(plane, py, w + 1, rows, wc4);
  a = __funnelshift_r(w0, w1, sh);
  b = __funnelshift_rc(w0, w1, sh + 8);            // a shift of 32 gives w1
}

// (1 + a + b + c + d) >> 2 of each byte, in 16-bit lanes
__device__ __forceinline__ uint32_t avg4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t m = 0x00FF00FFu;
  const uint32_t even = (a & m) + (b & m) + (c & m) + (d & m) + 0x00010001u;
  const uint32_t odd = ((a >> 8) & m) + ((b >> 8) & m) + ((c >> 8) & m) + ((d >> 8) & m) +
                       0x00010001u;
  return ((even >> 2) & m) | (((odd >> 2) & m) << 8);
}

__global__ void __launch_bounds__(32 * CHROMA_WARPS) chroma_pred_kernel(
    const uint8_t* __restrict__ prev_u, const uint8_t* __restrict__ prev_v,
    const uint8_t* __restrict__ inter, const int32_t* __restrict__ mvx,
    const int32_t* __restrict__ mvy, uint8_t* __restrict__ pred_u,
    uint8_t* __restrict__ pred_v, int nby, int nbx, int halo, int as_plane) {
  const int mb = blockIdx.x * CHROMA_WARPS + (threadIdx.x >> 5);
  if (mb >= nby * nbx) return;
  const int lane = threadIdx.x & 31, is_v = lane >> 4, r = (lane >> 1) & 7, half = lane & 1;
  const int by = mb / nbx, bx = mb - by * nbx;
  const int halo_rows = halo ? 4 : 0, rows = nby * 8 + 2 * halo_rows, wc4 = nbx * 2;
  // the three loads at once: the mvs do not wait for the inter flag
  const bool is_inter = inter[mb];
  const int m_x = mvx[mb], m_y = mvy[mb];
  uint32_t v = 0x80808080u;                        // intra predicts 128
  if (is_inter) {
    // arithmetic m_x >> 2 and (m_x >> 1) & 1 on negative mvs (me.py:363-364)
    const int fy = by * 8 + (m_y >> 2) + r + halo_rows, fx = bx * 8 + (m_x >> 2) + 4 * half;
    const bool hx = (m_x >> 1) & 1, hy = (m_y >> 1) & 1;
    const uint32_t* plane = reinterpret_cast<const uint32_t*>(is_v ? prev_v : prev_u);
    uint32_t a, b, c = 0, d = 0;
    crow(plane, fy, fx, rows, wc4, a, b);
    if (hy) crow(plane, fy + 1, fx, rows, wc4, c, d);
    // rounding as me.py:338-340
    if (hx && hy) v = avg4(a, b, c, d);
    else if (hx) v = __vavgu4(a, b);
    else if (hy) v = __vavgu4(a, c);
    else v = a;
  }
  uint8_t* out = is_v ? pred_v : pred_u;
  const size_t at = as_plane ? (size_t)(by * 8 + r) * (nbx * 8) + bx * 8 + 4 * half
                             : (size_t)mb * 64 + r * 8 + 4 * half;
  *reinterpret_cast<uint32_t*>(out + at) = v;
}

}  // namespace

// i_frame: the frame's GOP position in device memory, 0 for an I-frame,
// so that the I/P branch needs no value from the host (a CUDA graph replays
// the launch with the position the step wrote there).
extern "C" int mpeg2_me_fused(const void* cur, const void* prev_y,
                              const void* prev_u, const void* prev_v,
                              const void* i_frame, void* inter, void* mvx,
                              void* mvy, void* pred_y, void* pred_u,
                              void* pred_v, int nby, int nbx, int yr,
                              int first_mb_row, int total_mb_rows, int halo,
                              int as_plane, void* stream) {
  if (yr < 1 || yr > MAX_YR) return (int)cudaErrorInvalidValue;
  me_fused_kernel<<<nby * nbx, ME_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)prev_y, (const uint8_t*)prev_u,
      (const uint8_t*)prev_v, (const int32_t*)i_frame, (uint8_t*)inter,
      (int32_t*)mvx, (int32_t*)mvy, (uint8_t*)pred_y, (uint8_t*)pred_u,
      (uint8_t*)pred_v, nby, nbx, yr, first_mb_row, total_mb_rows, halo,
      as_plane);
  return (int)cudaGetLastError();
}

extern "C" int mpeg2_me_luma(const void* cur, const void* prev_y,
                             const void* i_frame, void* inter, void* mvx,
                             void* mvy, void* pred_y, int nby, int nbx, int yr,
                             int first_mb_row, int total_mb_rows, int halo,
                             int as_plane, void* stream) {
  if (yr < 1 || yr > MAX_YR) return (int)cudaErrorInvalidValue;
  me_luma_kernel<<<nby * nbx, ME_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)prev_y, (const int32_t*)i_frame,
      (uint8_t*)inter, (int32_t*)mvx, (int32_t*)mvy, (uint8_t*)pred_y, nby,
      nbx, yr, first_mb_row, total_mb_rows, halo, as_plane);
  return (int)cudaGetLastError();
}

extern "C" int mpeg2_chroma_pred(const void* prev_u, const void* prev_v,
                                 const void* inter, const void* mvx,
                                 const void* mvy, void* pred_u, void* pred_v,
                                 int nby, int nbx, int halo, int as_plane,
                                 void* stream) {
  const int blocks = (nby * nbx + CHROMA_WARPS - 1) / CHROMA_WARPS;
  if (blocks == 0) return 0;
  chroma_pred_kernel<<<blocks, 32 * CHROMA_WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prev_u, (const uint8_t*)prev_v, (const uint8_t*)inter,
      (const int32_t*)mvx, (const int32_t*)mvy, (uint8_t*)pred_u,
      (uint8_t*)pred_v, nby, nbx, halo, as_plane);
  return (int)cudaGetLastError();
}
