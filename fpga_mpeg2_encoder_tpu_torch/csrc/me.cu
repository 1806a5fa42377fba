// Motion estimation + prediction (stages X/Y/Z/F, RTL/mpeg2encoder.v:1310-1918).
//
// Three kernels:
// * me_fused_kernel (F): luma search + luma prediction + U/V prediction.
//   Replaces ops/pallas/me.py::motion_estimate_fused_pallas of the JAX
//   package (body _kernel_fused); plain version
//   ops/motion.py::estimate_and_predict_local.
// * me_luma_kernel (L): the same code without the U/V stage.  Replaces
//   motion_estimate_pallas (body _me_body); plain version
//   ops/motion.py::estimate_luma.
// * chroma_pred_kernel (C): the U/V half from (inter, mvx, mvy) maps in
//   device memory.  Replaces chroma_pred_pallas (body _chroma_predict);
//   plain version ops/motion.py::chroma_pred.  F's U/V stage shares its
//   word routines (align_pair, chroma_word).
//
// What bounds it: per P-frame macroblock the search does (2*yr+1)^2 * 256
// absolute differences (169 * 256 at yr = 6) against 640 bytes of input
// pixels and 384 bytes of uint8 predictions out, so it is bound by integer
// instructions, not by device memory (at 1920x1152: 398 M
// absolute-difference adds, four to a VABSDIFF4 instruction, against 8.3 MB).
// The design spends the instruction slots on the search:
// * One warp a macroblock, and no block barrier after the set-up: a block
//   of S warps takes a strip of S macroblocks of one macroblock row (S from
//   the wrapper, ops/kernels/me.py::strip_width), and its warps share one
//   reference window in shared memory, loaded once for the strip in 16-byte
//   (chroma 8-byte) words, every load of a thread started before its first
//   store.  The luma window is the strip's rows -YRC-1 .. 16+YRC from
//   column x_s - 16, in four copies: copy k holds, as word q, bytes
//   4q + k .. 4q + k + 3 of the row, so that the 4 bytes at any column are
//   one aligned load and the search needs no funnel shift.  Outside the
//   plane the window reads 0, as the reference's padding does.
// * The full-pel search runs on lane (dx, row group): 2*YRC + 1 dx and
//   32 / (2*YRC + 1) groups of block rows (13 x 2 groups of 8 rows at
//   YRC = 6).  The lane keeps its block rows in registers, walks down the
//   window rows its group meets, and adds each window row's 4 words at its
//   dx against every block row that meets it at a dy in range (VABSDIFF4
//   with its accumulator): one accumulator a dy, each window row read once.
//   A shuffle sum over the groups gives each lane every dy of its dx, and
//   the warp's minimum key decides.
// * The half-pel stage runs on lane (two words of the block, one above the
//   other): their reference words around the winner come from the window
//   copies, the 9 candidates are formed four pixels to a word (__vavgu4 on
//   a line, diag4 in 16-bit lanes on a diagonal; the lower word's upward
//   candidates are the upper word's downward ones) and summed with
//   VABSDIFF4 beside the intra deviation against the mean in all four
//   bytes; 5 warp reductions of packed pairs give the 10 sums and every
//   lane takes the decision.
// * U/V: lane (plane, row, half) forms its 4 predicted bytes from the
//   strip's chroma window in shared memory, as chroma_pred_kernel does from
//   device memory.
// The predictions are written as uint8 (values 0..255), the transform
// kernel's input.  An I-frame reads nothing: the reference returns inter 0,
// mv 0 and prediction 128 for it (me.py:268-281, and the chroma inter
// select at me.py:345), and a strip stores them as whole words.
//
// Signed right shifts of negative ints are arithmetic (nvcc's behaviour, and
// what the reference's >> means).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_YR = 6;             // vector_level 3
constexpr int MAX_STRIP = 4;          // macroblocks (warps) a block
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned BIG = 1u << 24;    // key of an invalid candidate (me.py:151)
constexpr int LCOL0 = 16;             // luma window byte 0 is column x_s - 16

// The search of a window of +-YRC (search ranges yr <= YRC).
template <int YRC>
struct Search {
  static constexpr int NC = 2 * YRC + 1;            // dx (and dy) values
  static constexpr int NG = 32 / NC;                // row groups
  static constexpr int RPG = (16 + NG - 1) / NG;    // block rows a group
  static constexpr int WROWS = 18 + 2 * YRC;        // window rows -YRC-1 .. 16+YRC
  // rows held: the last group's rows past 16 read (and never use) rows
  // below the window
  static constexpr int WALLOC = NG * RPG + NC > WROWS ? NG * RPG + NC : WROWS;
};

// The shared memory of a strip of s macroblocks, in words.
struct Layout {
  int rs;       // luma row stride, 4s + 8 words used; 2 mod 4, so rows 8 apart lie 16 banks apart
  int plane;    // one copy of the luma window, 4 mod 32, so copy k lies 4k banks on
  int cur;      // the strip's 16 block rows, 4s words each
  int chroma;   // U then V: 16 rows (-4 .. 11) of cw words from word 2 bx_s - 2
  int cw;
  int words;
};

__host__ __device__ inline Layout layout(int s, int walloc) {
  Layout l;
  l.rs = 4 * s + 10;
  l.plane = (walloc * l.rs - 4 + 31) / 32 * 32 + 4;
  l.cur = 4 * l.plane;
  l.chroma = l.cur + 64 * s;
  l.cw = 2 * s + 4;
  l.words = l.chroma + 32 * l.cw;
  return l;
}

// acc + the sum of the four byte absolute differences of a and b: the PTX of
// __vsadu4 (vabsdiff4 with .add), given the running sum in place of 0 so
// that the add is part of the one instruction.
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// (1 + a + b + c + d) >> 2 of each byte, in 16-bit lanes: two rounded pair
// averages would round twice
__device__ __forceinline__ uint32_t avg4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t m = 0x00FF00FFu;
  const uint32_t even = (a & m) + (b & m) + (c & m) + (d & m) + 0x00010001u;
  const uint32_t odd = ((a >> 8) & m) + ((b >> 8) & m) + ((c >> 8) & m) + ((d >> 8) & m) +
                       0x00010001u;
  return ((even >> 2) & m) | (((odd >> 2) & m) << 8);
}

// (1 + a + b + c + d) >> 2 of each byte from the pair sums a + b and c + d
// of the even bytes (ab_e, cd_e) and of the odd bytes (ab_o, cd_o) in 16-bit
// lanes, as avg4 forms them: the half-pel diagonals, whose pairs two
// candidates share
__device__ __forceinline__ uint32_t diag4(uint32_t ab_e, uint32_t ab_o, uint32_t cd_e,
                                          uint32_t cd_o) {
  const uint32_t even = ab_e + cd_e + 0x00010001u, odd = ab_o + cd_o + 0x00010001u;
  return ((even >> 2) & 0x00FF00FFu) | ((odd << 6) & 0xFF00FF00u);
}

// From the two aligned words under bytes fx .. fx+4 of a row (sh = 8 (fx & 3)):
// bytes fx .. fx+3 (a) and their right neighbours fx+1 .. fx+4 (b), byte k of
// the word the pixel at column fx + k.
__device__ __forceinline__ void align_pair(uint32_t w0, uint32_t w1, int sh, uint32_t& a,
                                           uint32_t& b) {
  a = __funnelshift_r(w0, w1, sh);
  b = __funnelshift_rc(w0, w1, sh + 8);            // a shift of 32 gives w1
}

// The chroma prediction of 4 pixels from their row (a), its right
// neighbours (b) and the row below (c, d), with the half flags; rounding as
// me.py:338-340
__device__ __forceinline__ uint32_t chroma_word(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                                bool hx, bool hy) {
  if (hx && hy) return avg4(a, b, c, d);
  else if (hx) return __vavgu4(a, b);
  else if (hy) return __vavgu4(a, c);
  return a;
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

// Word w (bytes 4w .. 4w+3) of row py of a chroma plane of wc4 words a row
// and `rows` rows; 0 outside the plane.
__device__ __forceinline__ uint32_t cword(const uint32_t* __restrict__ plane, int py, int w,
                                          int rows, int wc4) {
  return py >= 0 && py < rows && w >= 0 && w < wc4 ? __ldg(plane + (size_t)py * wc4 + w) : 0u;
}

// The I-frame's outputs of the strip's n macroblocks from mb0 (me.py:268-281:
// intra, mv 0, prediction 128), stored as whole words; nothing is read.
__device__ __forceinline__ void iframe_strip(
    uint8_t* __restrict__ inter, int32_t* __restrict__ mvx, int32_t* __restrict__ mvy,
    uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_u,
    uint8_t* __restrict__ pred_v, int by, int bx_s, int n, int nbx, int as_plane) {
  const int tid = threadIdx.x, nt = blockDim.x, mb0 = by * nbx + bx_s;
  const uint4 grey = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
  for (int k = tid; k < 16 * n; k += nt) {         // luma: row k & 15 of macroblock k >> 4
    const int r = k & 15, m = k >> 4;
    const size_t at = as_plane ? (size_t)(by * 16 + r) * (nbx * 16) + (bx_s + m) * 16
                               : (size_t)(mb0 + m) * 256 + r * 16;
    *reinterpret_cast<uint4*>(pred_y + at) = grey;
  }
  if (pred_u != nullptr) {
    for (int k = tid; k < 16 * n; k += nt) {       // row k & 7 of U (V) of macroblock k >> 4
      const int r = k & 7, m = k >> 4;
      const size_t at = as_plane ? (size_t)(by * 8 + r) * (nbx * 8) + (bx_s + m) * 8
                                 : (size_t)(mb0 + m) * 64 + r * 8;
      *reinterpret_cast<uint2*>(((k >> 3) & 1 ? pred_v : pred_u) + at) =
          make_uint2(grey.z, grey.w);
    }
  }
  if (tid < n) {
    inter[mb0 + tid] = 0;
    mvx[mb0 + tid] = 0;
    mvy[mb0 + tid] = 0;
  }
}

// Motion estimation and prediction of the strip of S macroblocks from
// (blockIdx.y, S * blockIdx.x) of a band of nby rows; prev_y holds the
// band's reference with `halo` 8 extra rows above and below (the chroma
// planes 4).  Without the U/V stage (L) prev_u, prev_v, pred_u and pred_v
// are null.
template <int YRC>
__device__ __forceinline__ void motion_strip(
    const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev_y,
    const uint8_t* __restrict__ prev_u, const uint8_t* __restrict__ prev_v,
    const int32_t* __restrict__ i_frame, uint8_t* __restrict__ inter,
    int32_t* __restrict__ mvx, int32_t* __restrict__ mvy,
    uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_u,
    uint8_t* __restrict__ pred_v, int nby, int nbx, int yr, int first_mb_row,
    int total_mb_rows, int halo, int as_plane, int S) {
  using P = Search<YRC>;
  const int by = blockIdx.y, bx_s = blockIdx.x * S;
  const int n_here = min(S, nbx - bx_s);
  if (*i_frame == 0) {
    iframe_strip(inter, mvx, mvy, pred_y, pred_u, pred_v, by, bx_s, n_here, nbx, as_plane);
    return;
  }
  const bool chroma = pred_u != nullptr;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, i = tid >> 5;
  const Layout L = layout(S, P::WALLOC);
  extern __shared__ uint4 me_smem[];
  uint32_t* const sm = reinterpret_cast<uint32_t*>(me_smem);
  const int w = nbx * 16, y0 = by * 16, x_s = bx_s * 16;
  const int halo_rows = halo ? 8 : 0, prev_rows = nby * 16 + 2 * halo_rows;

  // ---- the strip's windows and block rows into shared memory -------------
  // Each thread starts all its loads before its first store, so that the
  // block waits for device memory once.  Luma: rows -YRC-1 .. 16+YRC of
  // S + 2 16-byte words from column x_s - 16, each with the row's next word
  // for the shifted copies; chroma: U and V rows -4 .. 11 of S + 2 8-byte
  // words from column 8 bx_s - 8, the bytes under every vector of +-(2 yr +
  // 1) half-pels.  Zero outside the plane (me.py:90-96).  Thread tid takes
  // words tid, tid + nt, ... of each window in row-major order: at most 3.
  constexpr int PER = 3;
  const int wq = S + 2, rstep = nt / wq, cstep = nt - rstep * wq;
  const int crows = nby * 8 + 2 * (halo ? 4 : 0), wc8 = nbx;   // chroma rows, 8-byte words
  uint4 lv[PER];
  uint32_t ln[PER];
  uint2 cv[PER];
  int lr[PER], lc[PER];
  {
    int row = tid / wq, col = tid - row * wq;
#pragma unroll
    for (int it = 0; it < PER; it++) {
      lr[it] = row;
      lc[it] = col;
      lv[it] = make_uint4(0u, 0u, 0u, 0u);
      ln[it] = 0u;
      cv[it] = make_uint2(0u, 0u);
      const int py = y0 - YRC - 1 + row + halo_rows, px = x_s - LCOL0 + 16 * col;
      if (row < P::WROWS && py >= 0 && py < prev_rows) {
        const uint8_t* src = prev_y + (size_t)py * w;
        if (px >= 0 && px < w) lv[it] = *reinterpret_cast<const uint4*>(src + px);
        if (px + 16 < w) ln[it] = *reinterpret_cast<const uint32_t*>(src + px + 16);
      }
      const int cy = by * 8 - 4 + (row & 15) + (halo ? 4 : 0), cx = bx_s - 1 + col;
      if (chroma && row < 32 && cy >= 0 && cy < crows && cx >= 0 && cx < wc8)
        cv[it] = reinterpret_cast<const uint2*>(row >> 4 ? prev_v : prev_u)[(size_t)cy * wc8 + cx];
      row += rstep;
      col += cstep;
      if (col >= wq) {
        col -= wq;
        row++;
      }
    }
  }
  // the block rows of the strip's macroblocks in the plane
  uint4 bv = make_uint4(0u, 0u, 0u, 0u);
  if (tid < 16 * n_here)
    bv = *reinterpret_cast<const uint4*>(cur + (size_t)(y0 + (tid & 15)) * w + x_s + 16 * (tid >> 4));
#pragma unroll
  for (int it = 0; it < PER; it++) {
    if (lr[it] < P::WROWS) {
      const uint32_t wv[5] = {lv[it].x, lv[it].y, lv[it].z, lv[it].w, ln[it]};
#pragma unroll
      for (int cp = 0; cp < 4; cp++) {             // copy cp: the row shifted by cp bytes
        uint32_t* dst = sm + cp * L.plane + lr[it] * L.rs + 4 * lc[it];
        uint32_t s[4];
#pragma unroll
        for (int j = 0; j < 4; j++) s[j] = __funnelshift_r(wv[j], wv[j + 1], 8 * cp);
        *reinterpret_cast<uint2*>(dst) = make_uint2(s[0], s[1]);
        *reinterpret_cast<uint2*>(dst + 2) = make_uint2(s[2], s[3]);
      }
    }
    if (chroma && lr[it] < 32)
      *reinterpret_cast<uint2*>(sm + L.chroma + lr[it] * L.cw + 2 * lc[it]) = cv[it];
  }
  if (tid < 16 * n_here)
    *reinterpret_cast<uint4*>(sm + L.cur + (tid & 15) * 4 * S + 4 * (tid >> 4)) = bv;
  __syncthreads();
  // a strip's macroblocks past nbx compute nothing and store nothing
  if (i >= n_here) return;

  const int bx = bx_s + i, mb = by * nbx + bx;
  // Frame edges on GLOBAL macroblock rows, so a band's seams are not edges
  // (me.py:111-112); a strip's ends are edges only at bx 0 and nbx - 1.
  const bool edge_l = bx == 0, edge_r = bx == nbx - 1;
  const bool edge_t = first_mb_row + by == 0;
  const bool edge_b = first_mb_row + by == total_mb_rows - 1;

  // the half-pel lanes' block words (rows 2 (lane >> 2) and 2 (lane >> 2)
  // + 1, bytes 4 (lane & 3) .. + 3) and the block's pixel sum, for the
  // intra term
  const int r = 2 * (lane >> 2), q = lane & 3;
  const uint32_t cw[2] = {sm[L.cur + r * 4 * S + 4 * i + q], sm[L.cur + (r + 1) * 4 * S + 4 * i + q]};
  const int pixsum = (int)__reduce_add_sync(FULL, sad4(cw[0], 0u, sad4(cw[1], 0u, 0u)));

  // ---- full-pel SADs (me.py:132-142): lane (dx, group g of block rows) ---
  const int dxi = lane % P::NC, g = min(lane / P::NC, P::NG - 1);  // lanes past NC * NG
  const int dx = dxi - YRC;                                       // repeat group NG - 1
  uint32_t bw[P::RPG][4];
#pragma unroll
  for (int ii = 0; ii < P::RPG; ii++) {
    const int row = min(g * P::RPG + ii, 15);
    const uint4 q = *reinterpret_cast<const uint4*>(sm + L.cur + row * 4 * S + 4 * i);
    bw[ii][0] = q.x; bw[ii][1] = q.y; bw[ii][2] = q.z; bw[ii][3] = q.w;
  }
  // window rows g * RPG + 1 + t: block row g * RPG + ii meets row t at dy
  // index t - ii (dy = t - ii - YRC); its bytes at dx are word o >> 2 of
  // copy o & 3
  const int o = LCOL0 + 16 * i + dx;
  const uint32_t* wrow = sm + (o & 3) * L.plane + (g * P::RPG + 1) * L.rs + (o >> 2);
  // A row SAD is at most 16 * 255 and a candidate's at most 65280.
  uint32_t acc[P::NC];
#pragma unroll
  for (int d = 0; d < P::NC; d++) acc[d] = 0u;
#pragma unroll
  for (int t = 0; t < P::RPG + P::NC - 1; t++) {
    uint32_t wv[4];
#pragma unroll
    for (int j = 0; j < 4; j++) wv[j] = wrow[t * L.rs + j];
#pragma unroll
    for (int ii = 0; ii < P::RPG; ii++) {
      const int d = t - ii;
      if (d < 0 || d >= P::NC) continue;
      if (P::NG * P::RPG > 16 && g * P::RPG + ii >= 16) continue;   // past the block
#pragma unroll
      for (int j = 0; j < 4; j++) acc[d] = sad4(wv[j], bw[ii][j], acc[d]);
    }
  }
  // The sum over the groups, split so that lane (dx, g) gets the dy indices
  // d = g + NG * m: its own share of each, and in round r the share of group
  // (g + r) % NG, which sends the d of group (its own group - r) % NG.
  // pick(g2, m): acc[g2 + NG * m] of this lane, 0 past the window.
  auto pick = [&](int g2, int m) -> uint32_t {
    uint32_t v = 0u;
#pragma unroll
    for (int gg = 0; gg < P::NG; gg++)
      if (gg + P::NG * m < P::NC && g2 == gg) v = acc[gg + P::NG * m];
    return v;
  };
  constexpr int NK = (P::NC + P::NG - 1) / P::NG;   // candidates a lane keys
  uint32_t tot[NK];
#pragma unroll
  for (int m = 0; m < NK; m++) tot[m] = pick(g, m);
#pragma unroll
  for (int rd = 1; rd < P::NG; rd++) {
    const int src = (g + rd) % P::NG * P::NC + dxi, to = (g + P::NG - rd) % P::NG;
#pragma unroll
    for (int m = 0; m < NK; m++) tot[m] += __shfl_sync(FULL, pick(to, m), src);
  }

  // The key of candidate (dy, dx) with SAD s, BIG if it may not win.
  // 12-bit SAD overflow -> invalid (me.py:148, RTL:1670); frame-edge masks:
  // no candidate left of the left edge, etc. (me.py:148-150); and none
  // outside +-yr, where the window is wider than the search.  Bitwise ors,
  // so that the masks are predicates and not branches.
  const bool dx_bad = (edge_l & (dx < 0)) | (edge_r & (dx > 0)) | (dx < -yr) | (dx > yr);
  auto cand_key = [&](unsigned s, int dy) -> unsigned {
    const bool invalid = (s > 4095) | dx_bad | (edge_t & (dy < 0)) | (edge_b & (dy > 0)) |
                         (dy < -yr) | (dy > yr);
    // Tie-break: the least SAD, then the largest dy, then the largest dx,
    // i.e. the largest linear index (me.py:152-153): key sad*256 + (255 -
    // lin), with lin = (dy + YRC) * 16 + dx + YRC, which orders (dy, dx) as
    // the reference's (dy + yr) * (2 yr + 1) + dx + yr does.  The key orders
    // candidates by itself, so the split of the minimum over lanes does not
    // matter.
    const unsigned lin = (unsigned)((dy + YRC) * 16 + dx + YRC);
    return invalid ? BIG : s * 256u + (255u - lin);
  };
  unsigned key = BIG;
#pragma unroll
  for (int m = 0; m < NK; m++) key = min(key, cand_key(tot[m], g + P::NG * m - YRC));
  // (lanes past NC * NG repeat group NG - 1's keys)
  const unsigned kmin = __reduce_min_sync(FULL, key);
  // every candidate invalid -> the centre, mv (0, 0) (me.py:155)
  const int lin = kmin >= BIG ? YRC * 16 + YRC : 255 - (int)(kmin & 255u);
  const int mvy_full = (lin >> 4) - YRC, mvx_full = (lin & 15) - YRC;

  // ---- half-pel candidates of the lane's 8 pixels (me.py:200-222) --------
  // Candidate (hy, hx), index (hy + 1) * 3 + hx + 1, at pixel (r, c) is the
  // rounded mean of the reference at (r, c) + mv_full + {0, hy} x {0, hx}:
  // (1+a+b)>>1 on a line, (1+a+b+c+d)>>2 on a diagonal (me.py:200-204).
  // The lane's two words lie one above the other, so they share their
  // reference rows, and the lower word's candidates upwards are the upper
  // word's downwards.
  // nb[row r - 1 .. r + 2][column L, C, R]: the reference words at (row +
  // mv_full, 4 q + mv_full + {-1, 0, 1})
  uint32_t nb[4][3];
  {
    const int oc = LCOL0 + 16 * i + 4 * q + mvx_full;
    const uint32_t* col[3];
#pragma unroll
    for (int xx = 0; xx < 3; xx++)
      col[xx] = sm + ((oc + xx - 1) & 3) * L.plane + ((oc + xx - 1) >> 2);
#pragma unroll
    for (int yy = 0; yy < 4; yy++)
#pragma unroll
      for (int xx = 0; xx < 3; xx++) nb[yy][xx] = col[xx][(r + mvy_full + YRC + yy) * L.rs];
  }
  // the even and odd bytes of each row's pairs (C, L) and (C, R) in 16-bit
  // lanes, for the diagonals
  uint32_t pe[4][2], po[4][2];
#pragma unroll
  for (int yy = 0; yy < 4; yy++)
#pragma unroll
    for (int sd = 0; sd < 2; sd++) {
      const uint32_t c = nb[yy][1], o = nb[yy][2 * sd];
      pe[yy][sd] = (c & 0x00FF00FFu) + (o & 0x00FF00FFu);
      po[yy][sd] = __byte_perm(c, 0u, 0x4341) + __byte_perm(o, 0u, 0x4341);
    }
  // cand[word][index]: word 0 on rows 0 .. 2 of nb, word 1 on rows 1 .. 3
  uint32_t cand[2][9];
#pragma unroll
  for (int u = 0; u < 2; u++) {
    const uint32_t mc = nb[u + 1][1];
    cand[u][4] = mc;
    cand[u][3] = __vavgu4(mc, nb[u + 1][0]);
    cand[u][5] = __vavgu4(mc, nb[u + 1][2]);
  }
  cand[0][1] = __vavgu4(nb[1][1], nb[0][1]);
  cand[0][7] = cand[1][1] = __vavgu4(nb[1][1], nb[2][1]);
  cand[1][7] = __vavgu4(nb[2][1], nb[3][1]);
  cand[0][0] = diag4(pe[1][0], po[1][0], pe[0][0], po[0][0]);
  cand[0][2] = diag4(pe[1][1], po[1][1], pe[0][1], po[0][1]);
  cand[0][6] = cand[1][0] = diag4(pe[1][0], po[1][0], pe[2][0], po[2][0]);
  cand[0][8] = cand[1][2] = diag4(pe[1][1], po[1][1], pe[2][1], po[2][1]);
  cand[1][6] = diag4(pe[2][0], po[2][0], pe[3][0], po[3][0]);
  cand[1][8] = diag4(pe[2][1], po[2][1], pe[3][1], po[3][1]);
  // intra metric: mean = (pixsum >> 8) & 0xFF (me.py:159-160), in all
  // four bytes
  const uint32_t meanw = 0x01010101u * (uint32_t)((pixsum >> 8) & 0xFF);
  uint32_t hs[10];
#pragma unroll
  for (int k = 0; k < 9; k++) hs[k] = sad4(cand[1][k], cw[1], sad4(cand[0][k], cw[0], 0u));
  hs[9] = sad4(meanw, cw[1], sad4(meanw, cw[0], 0u));
  // The 10 sums two to a word: each is at most 256 * 255 < 2^16, so the
  // halves never carry into each other.
  int hsum[10];
#pragma unroll
  for (int k = 0; k < 10; k += 2) {
    const unsigned s = __reduce_add_sync(FULL, hs[k] | (hs[k + 1] << 16));
    hsum[k] = (int)(s & 0xFFFFu);
    hsum[k + 1] = (int)(s >> 16);
  }
  const int idx = decide(hsum, pixsum, yr, edge_l, edge_r, edge_t, edge_b, mvx_full,
                         mvy_full);

  // P-frame: the mv registers update even when intra wins (me.py:272-273,
  // RTL:1827-1828)
  const int is_inter = idx != 9;
  const int hy_sel = idx == 9 ? 0 : idx / 3 - 1;
  const int hx_sel = idx == 9 ? 0 : idx % 3 - 1;
  const int mv_x = mvx_full * 2 + hx_sel, mv_y = mvy_full * 2 + hy_sel;
  auto pick3 = [](int h, uint32_t lo, uint32_t mid, uint32_t hi) {
    return h < 0 ? lo : h > 0 ? hi : mid;
  };
#pragma unroll
  for (int u = 0; u < 2; u++) {
    const uint32_t (&c)[9] = cand[u];
    const uint32_t p = is_inter ? pick3(hy_sel, pick3(hx_sel, c[0], c[1], c[2]),
                                        pick3(hx_sel, c[3], c[4], c[5]),
                                        pick3(hx_sel, c[6], c[7], c[8]))
                                : 0x80808080u;     // intra: 128
    *reinterpret_cast<uint32_t*>(pred_y + (as_plane ? (size_t)(y0 + r + u) * w + bx * 16 + 4 * q
                                                    : (size_t)mb * 256 + (r + u) * 16 + 4 * q)) = p;
  }
  if (lane == 0) {
    inter[mb] = (uint8_t)is_inter;
    mvx[mb] = mv_x;
    mvy[mb] = mv_y;
  }
  if (!chroma) return;

  // ---- U/V (me.py:299-345, RTL:1847-1917): lane (plane, row cr, half) ----
  // forms bytes 4 half .. 4 half + 3 of row cr from the chroma window (row
  // 0 is chroma row by * 8 - 4, byte 0 column 8 bx_s - 8)
  const int is_v = lane >> 4, cr = (lane >> 1) & 7, half = lane & 1;
  uint32_t v = 0x80808080u;                        // intra predicts 128
  if (is_inter) {
    // arithmetic mv_x >> 2 and (mv_x >> 1) & 1 on negative mvs (me.py:363-364)
    const int fy = cr + (mv_y >> 2) + 4, fx = 8 * i + 8 + (mv_x >> 2) + 4 * half;
    const bool hx = (mv_x >> 1) & 1, hy = (mv_y >> 1) & 1;
    const uint32_t* row = sm + L.chroma + (is_v * 16 + fy) * L.cw + (fx >> 2);
    uint32_t a, b, c = 0u, d = 0u;
    align_pair(row[0], row[1], 8 * (fx & 3), a, b);
    if (hy) align_pair(row[L.cw], row[L.cw + 1], 8 * (fx & 3), c, d);
    v = chroma_word(a, b, c, d, hx, hy);
  }
  *reinterpret_cast<uint32_t*>((is_v ? pred_v : pred_u) +
                               (as_plane ? (size_t)(by * 8 + cr) * (nbx * 8) + bx * 8 + 4 * half
                                         : (size_t)mb * 64 + cr * 8 + 4 * half)) = v;
}

template <int YRC>
__global__ void __launch_bounds__(32 * MAX_STRIP) me_fused_kernel(
    const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev_y,
    const uint8_t* __restrict__ prev_u, const uint8_t* __restrict__ prev_v,
    const int32_t* __restrict__ i_frame, uint8_t* __restrict__ inter,
    int32_t* __restrict__ mvx, int32_t* __restrict__ mvy,
    uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_u,
    uint8_t* __restrict__ pred_v, int nby, int nbx, int yr, int first_mb_row,
    int total_mb_rows, int halo, int as_plane, int strip) {
  motion_strip<YRC>(cur, prev_y, prev_u, prev_v, i_frame, inter, mvx, mvy, pred_y, pred_u,
                    pred_v, nby, nbx, yr, first_mb_row, total_mb_rows, halo, as_plane, strip);
}

template <int YRC>
__global__ void __launch_bounds__(32 * MAX_STRIP) me_luma_kernel(
    const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev_y,
    const int32_t* __restrict__ i_frame, uint8_t* __restrict__ inter,
    int32_t* __restrict__ mvx, int32_t* __restrict__ mvy,
    uint8_t* __restrict__ pred_y, int nby, int nbx, int yr, int first_mb_row,
    int total_mb_rows, int halo, int as_plane, int strip) {
  motion_strip<YRC>(cur, prev_y, nullptr, nullptr, i_frame, inter, mvx, mvy, pred_y, nullptr,
                    nullptr, nby, nbx, yr, first_mb_row, total_mb_rows, halo, as_plane, strip);
}

// C, chroma_pred_kernel: bound by its 2.3 MB at 1920x1152 (U and V read,
// the predictions written), a few bytes per macroblock.  One warp per
// macroblock, CHROMA_WARPS macroblocks a block: lane (plane, row 0-7, half
// 0-1) is 32 lanes, U and V of one macroblock.  A lane forms its 4 output
// bytes as one word: it loads the two aligned words under bytes fx .. fx+4
// of its reference row (and of the next row when hy is set) and aligns them
// with funnel shifts; a word outside the plane reads as 0, as the
// reference's padding does.  The two-tap average is __vavgu4 ((1 + a + b) >>
// 1 a byte); the four-tap one is summed in 16-bit lanes (avg4).  The word is
// stored aligned, in tiles or in the plane.
constexpr int CHROMA_WARPS = 8;

// Bytes fx .. fx+3 of row py (a) and their right neighbours fx+1 .. fx+4 (b).
__device__ __forceinline__ void crow(const uint32_t* __restrict__ plane, int py, int fx,
                                     int rows, int wc4, uint32_t& a, uint32_t& b) {
  const int w = fx >> 2;                           // fx >> 2 floors negative columns
  align_pair(cword(plane, py, w, rows, wc4), cword(plane, py, w + 1, rows, wc4),
             8 * (fx & 3), a, b);
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
  uint32_t v = 0x80808080u;                        // an intra macroblock predicts 128
  if (is_inter) {
    // arithmetic m_x >> 2 and (m_x >> 1) & 1 on negative mvs (me.py:363-364)
    const int fy = by * 8 + (m_y >> 2) + r + halo_rows, fx = bx * 8 + (m_x >> 2) + 4 * half;
    const bool hx = (m_x >> 1) & 1, hy = (m_y >> 1) & 1;
    const uint32_t* plane = reinterpret_cast<const uint32_t*>(is_v ? prev_v : prev_u);
    uint32_t a, b, c = 0, d = 0;
    crow(plane, fy, fx, rows, wc4, a, b);
    if (hy) crow(plane, fy + 1, fx, rows, wc4, c, d);
    v = chroma_word(a, b, c, d, hx, hy);
  }
  uint8_t* out = is_v ? pred_v : pred_u;
  const size_t at = as_plane ? (size_t)(by * 8 + r) * (nbx * 8) + bx * 8 + 4 * half
                             : (size_t)mb * 64 + r * 8 + 4 * half;
  *reinterpret_cast<uint32_t*>(out + at) = v;
}

// F or L for a window of +-YRC: a grid of ceil(nbx / strip) x nby blocks of
// `strip` warps.
template <int YRC>
int launch_me(const void* cur, const void* prev_y, const void* prev_u, const void* prev_v,
              const void* i_frame, void* inter, void* mvx, void* mvy, void* pred_y,
              void* pred_u, void* pred_v, int nby, int nbx, int yr, int first_mb_row,
              int total_mb_rows, int halo, int as_plane, int strip, void* stream) {
  const dim3 blocks((nbx + strip - 1) / strip, nby);
  if (nby == 0 || nbx == 0) return 0;
  const size_t bytes = 4 * (size_t)layout(strip, Search<YRC>::WALLOC).words;
  if (pred_u != nullptr)
    me_fused_kernel<YRC><<<blocks, 32 * strip, bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)prev_y, (const uint8_t*)prev_u,
        (const uint8_t*)prev_v, (const int32_t*)i_frame, (uint8_t*)inter, (int32_t*)mvx,
        (int32_t*)mvy, (uint8_t*)pred_y, (uint8_t*)pred_u, (uint8_t*)pred_v, nby, nbx, yr,
        first_mb_row, total_mb_rows, halo, as_plane, strip);
  else
    me_luma_kernel<YRC><<<blocks, 32 * strip, bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)prev_y, (const int32_t*)i_frame, (uint8_t*)inter,
        (int32_t*)mvx, (int32_t*)mvy, (uint8_t*)pred_y, nby, nbx, yr, first_mb_row,
        total_mb_rows, halo, as_plane, strip);
  return (int)cudaGetLastError();
}

// yr <= 4 searches the +-4 window (vector_level 1 and 2), yr 5 and 6 the +-6
int launch_me_any(const void* cur, const void* prev_y, const void* prev_u, const void* prev_v,
                  const void* i_frame, void* inter, void* mvx, void* mvy, void* pred_y,
                  void* pred_u, void* pred_v, int nby, int nbx, int yr, int first_mb_row,
                  int total_mb_rows, int halo, int as_plane, int strip, void* stream) {
  if (yr < 1 || yr > MAX_YR || strip < 1 || strip > MAX_STRIP) return (int)cudaErrorInvalidValue;
  return (yr <= 4 ? launch_me<4> : launch_me<MAX_YR>)(
      cur, prev_y, prev_u, prev_v, i_frame, inter, mvx, mvy, pred_y, pred_u, pred_v, nby, nbx,
      yr, first_mb_row, total_mb_rows, halo, as_plane, strip, stream);
}

}  // namespace

// i_frame: the frame's GOP position in device memory, 0 for an I-frame,
// so that the I/P branch needs no value from the host (a CUDA graph replays
// the launch with the position the step wrote there).  strip: macroblocks a
// block, 1 .. MAX_STRIP.
extern "C" int mpeg2_me_fused(const void* cur, const void* prev_y,
                              const void* prev_u, const void* prev_v,
                              const void* i_frame, void* inter, void* mvx,
                              void* mvy, void* pred_y, void* pred_u,
                              void* pred_v, int nby, int nbx, int yr,
                              int first_mb_row, int total_mb_rows, int halo,
                              int as_plane, int strip, void* stream) {
  if (prev_u == nullptr || pred_u == nullptr) return (int)cudaErrorInvalidValue;
  return launch_me_any(cur, prev_y, prev_u, prev_v, i_frame, inter, mvx, mvy, pred_y, pred_u,
                       pred_v, nby, nbx, yr, first_mb_row, total_mb_rows, halo, as_plane,
                       strip, stream);
}

extern "C" int mpeg2_me_luma(const void* cur, const void* prev_y,
                             const void* i_frame, void* inter, void* mvx,
                             void* mvy, void* pred_y, int nby, int nbx, int yr,
                             int first_mb_row, int total_mb_rows, int halo,
                             int as_plane, int strip, void* stream) {
  return launch_me_any(cur, prev_y, nullptr, nullptr, i_frame, inter, mvx, mvy, pred_y,
                       nullptr, nullptr, nby, nbx, yr, first_mb_row, total_mb_rows, halo,
                       as_plane, strip, stream);
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
