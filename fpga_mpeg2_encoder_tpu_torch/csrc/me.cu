// Motion estimation + prediction (stages X/Y/Z/F, RTL/mpeg2encoder.v:1310-1918).
//
// Three kernels over shared device functions, one block per macroblock:
// * me_fused_kernel: luma search + luma prediction + U/V prediction.
//   Replaces ops/pallas/me.py::motion_estimate_fused_pallas of the JAX
//   package (body _kernel_fused); plain version
//   ops/motion.py::estimate_and_predict_local.
// * me_luma_kernel: the luma half alone.  Replaces motion_estimate_pallas
//   (body _me_body); plain version ops/motion.py::estimate_luma.
// * chroma_pred_kernel: the U/V half from (inter, mvx, mvy) maps in device
//   memory.  Replaces chroma_pred_pallas (body _chroma_predict); plain
//   version ops/motion.py::chroma_pred.
//
// Per P-frame macroblock the search does (2*yr+1)^2 * 256 absolute
// differences (169 * 256 at yr = 6) against 640 bytes of input pixels and
// 1.5 KB of int32 predictions out, so it is bound by integer throughput, not
// by device memory (at 1920x1152: 398 M absolute-difference adds, 6.0 us at
// the INT32 peak with four byte differences per instruction as __vsadu4
// does, against 18.9 MB, 5.6 us at 3.35 TB/s).  The design keeps everything the
// search touches in shared memory: the 16x16 current block and the 30x30
// reference window (rows and columns -yr-1 .. 16+yr around the block, zero
// outside the plane as the reference's padding reads), so each reference
// pixel crosses device memory once per block.  One thread per full-pel
// candidate sums its 256 differences; one warp-level min-reduction over a key
// per candidate gives the winner; then one thread per pixel computes that
// pixel's 9 half-pel candidates and the intra term, and warp reductions give
// the 10 sums.  None of the TPU's layout work (segment folding, MXU
// lane<->MB conversions, byte-split matmuls, magic division, masked rolls)
// has a place here.  An I-frame skips the search: the
// reference returns inter 0, mv 0 and prediction 128 for it (me.py:268-281,
// and the chroma inter select at me.py:345).
//
// Signed right shifts of negative ints are arithmetic (nvcc's behaviour, and
// what the reference's >> means).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ME_THREADS = 256;       // one per pixel of the 16x16 block
constexpr int MAX_YR = 6;             // vector_level 3
constexpr int WSTR = 18 + 2 * MAX_YR + 1;   // window row stride (30 + 1 pad)
constexpr unsigned BIG = 1u << 24;    // key of an invalid candidate (me.py:151)

struct LumaShared {
  int32_t win[(18 + 2 * MAX_YR) * WSTR];   // reference rows/cols -yr-1 .. 16+yr
  int32_t cur[256];
  int32_t part[ME_THREADS / 32][10];       // per-warp partial sums
  unsigned kpart[ME_THREADS / 32];         // per-warp minimum keys
  int32_t hsum[10];
};

struct LumaResult {
  int inter, mvx, mvy;
};

// Luma search + prediction of macroblock (by, bx) of a band of nby rows.
// prev holds the band's reference with halo_rows extra rows above and below.
// All ME_THREADS threads call it; all get the macroblock's result.
__device__ LumaResult luma_me(
    LumaShared& sh, const uint8_t* __restrict__ cur,
    const uint8_t* __restrict__ prev, int32_t* __restrict__ pred_y,
    int by, int bx, int nby, int nbx, int halo_rows, int yr, int iframe,
    int first_mb_row, int total_mb_rows, int as_plane) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int r = tid >> 4, c = tid & 15;
  const int w = nbx * 16, y0 = by * 16, x0 = bx * 16;
  const size_t opix = as_plane ? (size_t)(y0 + r) * w + x0 + c
                               : ((size_t)by * nbx + bx) * 256 + tid;
  if (iframe) {                       // me.py:268-281: intra, mv 0, pred 128
    pred_y[opix] = 128;
    return {0, 0, 0};
  }
  const int n = 2 * yr + 1, nn = n * n, ws = 18 + 2 * yr;
  const int prev_rows = nby * 16 + 2 * halo_rows;

  const int cp = cur[(size_t)(y0 + r) * w + x0 + c];
  sh.cur[tid] = cp;
  for (int k = tid; k < ws * ws; k += ME_THREADS) {
    const int i = k / ws, j = k - i * ws;
    const int py = y0 - yr - 1 + i + halo_rows, px = x0 - yr - 1 + j;
    sh.win[i * WSTR + j] = (py >= 0 && py < prev_rows && px >= 0 && px < w)
                               ? prev[(size_t)py * w + px] : 0;
  }
  const int ps = __reduce_add_sync(0xffffffffu, cp);
  if (lane == 0) sh.part[wid][0] = ps;
  __syncthreads();
  int pixsum = 0;
  for (int k = 0; k < ME_THREADS / 32; k++) pixsum += sh.part[k][0];

  // Frame edges on GLOBAL macroblock rows, so a band's seams are not edges
  // (me.py:111-112).
  const bool edge_l = bx == 0, edge_r = bx == nbx - 1;
  const bool edge_t = first_mb_row + by == 0;
  const bool edge_b = first_mb_row + by == total_mb_rows - 1;

  // ---- full-pel SADs, one thread per candidate (me.py:132-142) ----------
  unsigned key = BIG;
  if (tid < nn) {
    const int dy = tid / n - yr, dx = tid % n - yr;
    const int32_t* wp = sh.win + (dy + yr + 1) * WSTR + dx + yr + 1;
    int s = 0;
    for (int rr = 0; rr < 16; rr++) {
#pragma unroll
      for (int cc = 0; cc < 16; cc++) s += abs(sh.cur[rr * 16 + cc] - wp[rr * WSTR + cc]);
    }
    // 12-bit SAD overflow -> invalid (me.py:148, RTL:1670); frame-edge masks:
    // no candidate left of the left edge, etc. (me.py:148-150)
    const bool invalid = s > 4095 || (edge_l && dx < 0) || (edge_r && dx > 0) ||
                         (edge_t && dy < 0) || (edge_b && dy > 0);
    // Tie-break: the least SAD, then the largest dy, then the largest dx,
    // i.e. the largest linear index: key sad*256 + (255 - lin) (me.py:152-153)
    if (!invalid) key = (unsigned)s * 256u + (255u - (unsigned)tid);
  }
  const unsigned wmin = __reduce_min_sync(0xffffffffu, key);
  if (lane == 0) sh.kpart[wid] = wmin;
  __syncthreads();
  unsigned kmin = BIG;
  for (int k = 0; k < ME_THREADS / 32; k++) kmin = min(kmin, sh.kpart[k]);
  // every candidate invalid -> the centre, mv (0, 0) (me.py:155)
  const int lin = kmin >= BIG ? yr * n + yr : 255 - (int)(kmin & 255u);
  const int mvy_full = lin / n - yr, mvx_full = lin % n - yr;

  // ---- half-pel candidates of this thread's pixel (me.py:200-222) ---------
  // Candidate (hy, hx) at pixel (r, c) is the rounded mean of the reference
  // at (r, c) + mv_full + {0, hy} x {0, hx}: (1+a+b)>>1 on a line,
  // (1+a+b+c+d)>>2 on a diagonal (me.py:200-204).
  int nb[3][3];
  const int32_t* wc = sh.win + (r + mvy_full + yr + 1) * WSTR + c + mvx_full + yr + 1;
#pragma unroll
  for (int i = 0; i < 3; i++)
#pragma unroll
    for (int j = 0; j < 3; j++) nb[i][j] = wc[(i - 1) * WSTR + j - 1];
  int cand[9];
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
      cand[(hy + 1) * 3 + hx + 1] = v;
    }
  }
  // intra metric: mean = (pixsum >> 8) & 0xFF (me.py:159-160)
  const int mean = (pixsum >> 8) & 0xFF;
#pragma unroll
  for (int k = 0; k < 10; k++) {
    const int d = abs(cp - (k < 9 ? cand[k] : mean));
    const int s = __reduce_add_sync(0xffffffffu, d);
    if (lane == 0) sh.part[wid][k] = s;
  }
  __syncthreads();
  if (tid < 10) {
    int s = 0;
    for (int k = 0; k < ME_THREADS / 32; k++) s += sh.part[k][tid];
    sh.hsum[tid] = s;
  }
  __syncthreads();

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
      const int s = sh.hsum[k];
      vals[k] = (bad || s > 4095) ? 0x1000 : s;
    }
  }
  // f_Y_sum quirk: the 16-bit accumulator adds the pixel sum to the mean
  // deviation, clipped to 0xFFF (me.py:246-248, RTL:1659-1662/1774-1791)
  const int acc = (pixsum + sh.hsum[9]) & 0xFFFF;
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
  const int idx = (w89 <= x0123 && w89 <= x4567) ? i89 : left;

  // P-frame: the mv registers update even when intra wins (me.py:272-273,
  // RTL:1827-1828)
  const int inter = idx != 9;
  const int hy_sel = idx == 9 ? 0 : idx / 3 - 1;
  const int hx_sel = idx == 9 ? 0 : idx % 3 - 1;
  int p = 128;
#pragma unroll
  for (int k = 0; k < 9; k++)
    if (inter && idx == k) p = cand[k];
  pred_y[opix] = p;
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
    int32_t* __restrict__ pred_u, int32_t* __restrict__ pred_v,
    int by, int bx, int nby, int nbx, int halo_rows, int as_plane,
    int inter, int mvx, int mvy) {
  const int tid = threadIdx.x;
  if (tid >= 128) return;
  const uint8_t* plane = tid < 64 ? prev_u : prev_v;
  int32_t* out = tid < 64 ? pred_u : pred_v;
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
               : ((size_t)by * nbx + bx) * 64 + p] = v;
}

__global__ void __launch_bounds__(ME_THREADS) me_fused_kernel(
    const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev_y,
    const uint8_t* __restrict__ prev_u, const uint8_t* __restrict__ prev_v,
    uint8_t* __restrict__ inter, int32_t* __restrict__ mvx,
    int32_t* __restrict__ mvy, int32_t* __restrict__ pred_y,
    int32_t* __restrict__ pred_u, int32_t* __restrict__ pred_v, int nby,
    int nbx, int yr, int iframe, int first_mb_row, int total_mb_rows,
    int halo, int as_plane) {
  __shared__ LumaShared sh;
  const int mb = blockIdx.x, by = mb / nbx, bx = mb - by * nbx;
  const LumaResult res = luma_me(sh, cur, prev_y, pred_y, by, bx, nby, nbx,
                                 halo ? 8 : 0, yr, iframe, first_mb_row,
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
    uint8_t* __restrict__ inter, int32_t* __restrict__ mvx,
    int32_t* __restrict__ mvy, int32_t* __restrict__ pred_y, int nby, int nbx,
    int yr, int iframe, int first_mb_row, int total_mb_rows, int halo,
    int as_plane) {
  __shared__ LumaShared sh;
  const int mb = blockIdx.x, by = mb / nbx, bx = mb - by * nbx;
  const LumaResult res = luma_me(sh, cur, prev_y, pred_y, by, bx, nby, nbx,
                                 halo ? 8 : 0, yr, iframe, first_mb_row,
                                 total_mb_rows, as_plane);
  if (threadIdx.x == 0) {
    inter[mb] = (uint8_t)res.inter;
    mvx[mb] = res.mvx;
    mvy[mb] = res.mvy;
  }
}

__global__ void __launch_bounds__(128) chroma_pred_kernel(
    const uint8_t* __restrict__ prev_u, const uint8_t* __restrict__ prev_v,
    const uint8_t* __restrict__ inter, const int32_t* __restrict__ mvx,
    const int32_t* __restrict__ mvy, int32_t* __restrict__ pred_u,
    int32_t* __restrict__ pred_v, int nby, int nbx, int halo, int as_plane) {
  const int mb = blockIdx.x, by = mb / nbx, bx = mb - by * nbx;
  chroma_predict(prev_u, prev_v, pred_u, pred_v, by, bx, nby, nbx,
                 halo ? 4 : 0, as_plane, inter[mb] != 0, mvx[mb], mvy[mb]);
}

}  // namespace

extern "C" int mpeg2_me_fused(const void* cur, const void* prev_y,
                              const void* prev_u, const void* prev_v,
                              void* inter, void* mvx, void* mvy, void* pred_y,
                              void* pred_u, void* pred_v, int nby, int nbx,
                              int yr, int iframe, int first_mb_row,
                              int total_mb_rows, int halo, int as_plane,
                              void* stream) {
  if (yr < 1 || yr > MAX_YR) return (int)cudaErrorInvalidValue;
  me_fused_kernel<<<nby * nbx, ME_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)prev_y, (const uint8_t*)prev_u,
      (const uint8_t*)prev_v, (uint8_t*)inter, (int32_t*)mvx, (int32_t*)mvy,
      (int32_t*)pred_y, (int32_t*)pred_u, (int32_t*)pred_v, nby, nbx, yr,
      iframe, first_mb_row, total_mb_rows, halo, as_plane);
  return (int)cudaGetLastError();
}

extern "C" int mpeg2_me_luma(const void* cur, const void* prev_y, void* inter,
                             void* mvx, void* mvy, void* pred_y, int nby,
                             int nbx, int yr, int iframe, int first_mb_row,
                             int total_mb_rows, int halo, int as_plane,
                             void* stream) {
  if (yr < 1 || yr > MAX_YR) return (int)cudaErrorInvalidValue;
  me_luma_kernel<<<nby * nbx, ME_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)prev_y, (uint8_t*)inter,
      (int32_t*)mvx, (int32_t*)mvy, (int32_t*)pred_y, nby, nbx, yr, iframe,
      first_mb_row, total_mb_rows, halo, as_plane);
  return (int)cudaGetLastError();
}

extern "C" int mpeg2_chroma_pred(const void* prev_u, const void* prev_v,
                                 const void* inter, const void* mvx,
                                 const void* mvy, void* pred_u, void* pred_v,
                                 int nby, int nbx, int halo, int as_plane,
                                 void* stream) {
  chroma_pred_kernel<<<nby * nbx, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prev_u, (const uint8_t*)prev_v, (const uint8_t*)inter,
      (const int32_t*)mvx, (const int32_t*)mvy, (int32_t*)pred_u,
      (int32_t*)pred_v, nby, nbx, halo, as_plane);
  return (int)cudaGetLastError();
}
