// Transform kernel: residual -> forward DCT -> quantise -> dequantise ->
// Chen-Wang inverse DCT -> reconstruction (stages G..P,
// RTL/mpeg2encoder.v:1924-2357), with the quantised coefficients written
// straight into zig-zag, tile-major order.
//
// Replaces ops/pallas/transform.py::transform_recon_pallas of the JAX
// package.  Plain version: ops/dct.py::transform_recon.
//
// What bounds it: per macroblock it reads 384 pixels and 384 uint8
// predictions and writes 384 int32 coefficients and 384 pixels, 2.7 KB,
// for about 6 K integer multiply-adds (the FDCT's 53 M at 1920x1152, 3 us
// at the INT32 rate), so it is bound by device memory: 23 MB, about 7 us at
// 3.35 TB/s.  The design moves each byte once, in wide accesses, and keeps
// every thread working between barriers:
// * one thread per (tile, row or column) in every phase: 8 threads a 8x8
//   tile, 48 a macroblock, 8 macroblocks a block of 384 threads.  A tile's
//   8 threads are 8 lanes of one warp, so the tile turns between passes
//   through shared memory (stride 9 words: no bank conflicts) under
//   __syncwarp, with no block barrier;
// * each thread reads its row's 8 pixels of cur and of pred with one 8-byte
//   load each and writes its 8 reconstructed pixels with one 8-byte store;
// * the FDCT passes, the quantiser and the two IDCT passes each run 8
//   independent sums or one butterfly stage per thread in registers;
// * the intra quantiser divides by a multiply with a per-position magic
//   reciprocal (__umulhi) and a shift, exact for every 16-bit numerator;
// * the block's 8 x 384 coefficients are staged in zig-zag order in shared
//   memory and written out with 16-byte stores.
// transform_stage_kernel runs the same device functions stage by stage on
// int32 tiles of any value, so that the tests can reach the wraps and
// clamps that pixels never reach.
//
// Wrapping arithmetic (the reference's 32-bit IDCT registers) runs in
// uint32; right shifts reinterpret as int32 for the arithmetic shift.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// core/tables.py DCTM, INTRA_Q and ZIGZAG (raster position -> zig-zag index)
__constant__ int32_t c_dctm[64] = {
    64, 64, 64, 64, 64, 64, 64, 64,
    89, 75, 50, 18, -18, -50, -75, -89,
    84, 35, -35, -84, -84, -35, 35, 84,
    75, -18, -89, -50, 50, 89, 18, -75,
    64, -64, -64, 64, 64, -64, -64, 64,
    50, -89, 18, 75, -75, -18, 89, -50,
    35, -84, 84, -35, -35, 84, -84, 35,
    18, -50, 75, -89, 89, -75, 50, -18};

__constant__ int32_t c_intra_q[64] = {
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83};

__constant__ uint8_t c_zigzag[64] = {
    0, 1, 5, 6, 14, 15, 27, 28,
    2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43,
    9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54,
    20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61,
    35, 36, 48, 49, 57, 58, 62, 63};

// core/tables.py intra_reciprocal(): for every 16-bit n,
// n / INTRA_Q[p] == __umulhi(n, c_intra_magic[p]) >> c_intra_shift[p]
__constant__ uint32_t c_intra_magic[64] = {
    2147483648u, 2147483648u, 3616814566u, 3123612579u, 2643056798u, 2545165806u, 2369637129u, 4042322161u,
    2147483648u, 2147483648u, 3123612579u, 2863311531u, 2545165806u, 2369637129u, 4042322161u, 3714566311u,
    3616814566u, 3123612579u, 2643056798u, 2545165806u, 2369637129u, 4042322161u, 4042322161u, 3616814566u,
    3123612579u, 3123612579u, 2643056798u, 2545165806u, 2369637129u, 4042322161u, 3714566311u, 3435973837u,
    3123612579u, 2643056798u, 2545165806u, 2369637129u, 2147483648u, 3926827243u, 3435973837u, 2863311531u,
    2643056798u, 2545165806u, 2369637129u, 2147483648u, 3926827243u, 3435973837u, 2863311531u, 2369637129u,
    2643056798u, 2545165806u, 2369637129u, 4042322161u, 3616814566u, 2987803337u, 2454267027u, 3983737782u,
    2545165806u, 2369637129u, 3926827243u, 3616814566u, 2987803337u, 2454267027u, 3983737782u, 3311782012u};

__constant__ int32_t c_intra_shift[64] = {
    2, 3, 4, 4, 4, 4, 4, 5,
    3, 3, 4, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 4, 5, 5, 5,
    4, 4, 4, 4, 4, 5, 5, 5,
    4, 4, 4, 4, 4, 5, 5, 5,
    4, 4, 4, 4, 5, 5, 5, 5,
    4, 4, 4, 5, 5, 5, 5, 6,
    4, 4, 5, 5, 5, 5, 6, 6};

constexpr int MB_PER_BLOCK = 8;
constexpr int TF_THREADS = MB_PER_BLOCK * 48;   // 6 tiles x 8 rows a macroblock
constexpr int TS = 9;     // row stride of a tile in shared memory, in words

// The per-position tables of the quantiser, staged in shared memory: a
// warp's lanes read 8 positions at once there, which constant memory would
// serialise.
struct QTables {
  int32_t q[64];
  uint32_t magic[64];
  int32_t shift[64];
  int32_t zig[64];
};

__device__ __forceinline__ void load_tables(QTables& qt) {
  const int k = threadIdx.x;
  if (k < 64) {
    qt.q[k] = c_intra_q[k];
    qt.magic[k] = c_intra_magic[k];
    qt.shift[k] = c_intra_shift[k];
    qt.zig[k] = c_zigzag[k];
  }
}

constexpr uint32_t W1 = 2841, W2 = 2676, W3 = 2408, W5 = 1609, W6 = 1108, W7 = 565;

__device__ __forceinline__ uint32_t sra(uint32_t v, int s) {
  return (uint32_t)((int32_t)v >> s);
}

// One Chen-Wang butterfly stage (RTL:844-905 rows, RTL:911-970 columns);
// the same arithmetic as ops/dct.py::_cw_stage, wrapping in uint32.
__device__ __forceinline__ void cw_stage(const int32_t* a, int32_t* o, bool rounding) {
  uint32_t x0 = a[0], x1 = a[4], x2 = a[6], x3 = a[2];
  uint32_t x4 = a[1], x5 = a[7], x6 = a[5], x7 = a[3], x8;
  uint32_t r4;
  int sh, fs;
  if (!rounding) {
    x0 = (x0 << 11) | 128u;
    x1 = x1 << 11;
    r4 = 0; sh = 0; fs = 8;
  } else {
    x0 = (x0 << 8) + 8192u;
    x1 = x1 << 8;
    r4 = 4; sh = 3; fs = 14;
  }
  x8 = W7 * (x4 + x5) + r4;
  x4 = sra(x8 + (W1 - W7) * x4, sh);
  x5 = sra(x8 - (W1 + W7) * x5, sh);
  x8 = W3 * (x6 + x7) + r4;
  x6 = sra(x8 - (W3 - W5) * x6, sh);
  x7 = sra(x8 - (W3 + W5) * x7, sh);
  x8 = x0 + x1;
  x0 = x0 - x1;
  x1 = W6 * (x3 + x2) + r4;
  x2 = sra(x1 - (W2 + W6) * x2, sh);
  x3 = sra(x1 + (W2 - W6) * x3, sh);
  x1 = x4 + x6;
  x4 = x4 - x6;
  x6 = x5 + x7;
  x5 = x5 - x7;
  x7 = x8 + x3;
  x8 = x8 - x3;
  x3 = x0 + x2;
  x0 = x0 - x2;
  x2 = sra(181u * (x4 + x5) + 128u, 8);
  x4 = sra(181u * (x4 - x5) + 128u, 8);
  o[0] = (int32_t)sra(x7 + x1, fs);
  o[1] = (int32_t)sra(x3 + x2, fs);
  o[2] = (int32_t)sra(x0 + x4, fs);
  o[3] = (int32_t)sra(x8 + x6, fs);
  o[4] = (int32_t)sra(x8 - x6, fs);
  o[5] = (int32_t)sra(x0 - x4, fs);
  o[6] = (int32_t)sra(x3 - x2, fs);
  o[7] = (int32_t)sra(x7 - x1, fs);
}

__device__ __forceinline__ int32_t clampi(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Forward DCT of one tile by its 8 threads: row i of the residual in, column
// i of round(M X M^T / 4096) with the 17-bit wrap out (RTL:2025-2062).  The
// reference rounds once, after both passes, so X M^T first is the same sum.
__device__ __forceinline__ void fdct8(const int32_t (&x)[8], int32_t* tl, int i,
                                      int32_t (&f)[8]) {
#pragma unroll
  for (int v = 0; v < 8; v++) {                   // row i of X M^T, |.| < 2^18
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) acc += c_dctm[v * 8 + k] * x[k];
    tl[v * TS + i] = acc;
  }
  __syncwarp();
  int32_t y[8];                                   // column i of X M^T
#pragma unroll
  for (int k = 0; k < 8; k++) y[k] = tl[i * TS + k];
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 8; u++) {                   // |M X M^T| < 2^27
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) acc += c_dctm[u * 8 + k] * y[k];
    acc = (acc >> 12) + ((acc >> 11) & 1);
    f[u] = ((acc & 0x1FFFF) ^ 0x10000) - 0x10000;
  }
}

// Quantise coefficient p (RTL:2064-2077): 16-bit wraps, the intra division
// as a multiply.
__device__ __forceinline__ int32_t quant(const QTables& qt, int32_t f, int p, bool is_inter,
                                         int q_level) {
  const uint32_t a = (uint32_t)(f < 0 ? -f : f) & 0xFFFFu;
  uint32_t q;
  if (is_inter) {
    q = ((a + 2u) & 0xFFFFu) >> (4 + q_level);
  } else if (p == 0) {
    q = (a >> 4) + ((a >> 3) & 1u);
  } else {
    const uint32_t wq = (uint32_t)qt.q[p];
    const uint32_t off = (wq * ((3u << q_level) + 2u)) >> 3;
    q = __umulhi(((a + off) & 0xFFFFu) >> q_level, qt.magic[p]) >> qt.shift[p];
  }
  if (q > 2047u) q = 2047u;
  return f < 0 ? -(int32_t)q : (int32_t)q;
}

// Dequantise coefficient p (RTL:2128-2150).
__device__ __forceinline__ int32_t dequant(const QTables& qt, int32_t qs, int p,
                                           bool is_inter, int q_level) {
  if (is_inter) {
    const int32_t x2 = qs * 2;
    return clampi((x2 + (x2 > 0) - (x2 < 0)) * (1 << q_level), -2047, 2047);
  }
  if (p == 0) return qs * 2;
  const int32_t xa = qs * qt.q[p];
  return clampi(q_level >= 3 ? xa * (1 << (q_level - 3)) : xa >> (3 - q_level),
                -2047, 2047);
}

// Chen-Wang IDCT of one tile by its 8 threads: column i of the dequantised
// coefficients in, row i of the residual in [-255, 255] out.  Rows with the
// 18-bit truncation (RTL:844-905), then columns (RTL:911-970).
__device__ __forceinline__ void idct8(const int32_t (&d)[8], int32_t* tl, int i,
                                      int32_t (&res)[8]) {
  int32_t v[8], o[8];
#pragma unroll
  for (int u = 0; u < 8; u++) tl[u * TS + i] = d[u];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; k++) v[k] = tl[i * TS + k];
  __syncwarp();
  cw_stage(v, o, false);
#pragma unroll
  for (int k = 0; k < 8; k++) tl[k * TS + i] = ((o[k] & 0x3FFFF) ^ 0x20000) - 0x20000;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; k++) v[k] = tl[i * TS + k];
  __syncwarp();
  cw_stage(v, o, true);
#pragma unroll
  for (int k = 0; k < 8; k++) tl[k * TS + i] = clampi(o[k], -255, 255);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; k++) res[k] = tl[i * TS + k];
}

__device__ __forceinline__ uint32_t byte_of(uint2 w, int k) {
  return ((k < 4 ? w.x : w.y) >> (8 * (k & 3))) & 255u;
}

__global__ void __launch_bounds__(TF_THREADS) transform_kernel(
    const uint8_t* __restrict__ cy, const uint8_t* __restrict__ cu,
    const uint8_t* __restrict__ cv, const uint8_t* __restrict__ py,
    const uint8_t* __restrict__ pu, const uint8_t* __restrict__ pv,
    const uint8_t* __restrict__ inter, int32_t* __restrict__ qzig,
    uint8_t* __restrict__ ry, uint8_t* __restrict__ ru, uint8_t* __restrict__ rv,
    int n_mb, int nbx, int q_level) {
  __shared__ int32_t tiles[MB_PER_BLOCK * 6][8 * TS];
  __shared__ __align__(16) int32_t zig[MB_PER_BLOCK][384];
  __shared__ QTables qt;
  load_tables(qt);
  const int tile = threadIdx.x >> 3, i = threadIdx.x & 7;
  const int m = tile / 6, t = tile - m * 6;
  const int mb0 = blockIdx.x * MB_PER_BLOCK;
  // the last block's missing macroblocks redo the last one and store nothing
  const bool live = mb0 + m < n_mb;
  const int mb = live ? mb0 + m : n_mb - 1;
  const int by = mb / nbx, bx = mb - by * nbx, w = nbx * 16;

  const uint8_t *cur, *pred;
  uint8_t* rec;
  size_t pix;                                     // first pixel of row i of tile t
  if (t < 4) {
    cur = cy; pred = py; rec = ry;
    pix = (size_t)(by * 16 + (t >> 1) * 8 + i) * w + bx * 16 + (t & 1) * 8;
  } else {
    cur = t == 4 ? cu : cv; pred = t == 4 ? pu : pv; rec = t == 4 ? ru : rv;
    pix = (size_t)(by * 8 + i) * (w / 2) + bx * 8;
  }
  const uint2 cw = *reinterpret_cast<const uint2*>(cur + pix);
  const uint2 pw = *reinterpret_cast<const uint2*>(pred + pix);
  int32_t x[8];
#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = (int32_t)byte_of(cw, k) - (int32_t)byte_of(pw, k);

  int32_t f[8], d[8], r[8];
  fdct8(x, tiles[tile], i, f);
  __syncthreads();                                // qt is loaded
  const bool is_inter = inter[mb] != 0;
#pragma unroll
  for (int u = 0; u < 8; u++) {                   // thread i holds column i
    const int p = u * 8 + i;
    const int32_t qs = quant(qt, f[u], p, is_inter, q_level);
    zig[m][t * 64 + qt.zig[p]] = qs;
    d[u] = dequant(qt, qs, p, is_inter, q_level);
  }
  idct8(d, tiles[tile], i, r);

  // ---- reconstruction (RTL:2350-2352), one 8-byte store ---------------------
  uint2 out = make_uint2(0u, 0u);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint32_t v = (uint32_t)clampi((int32_t)byte_of(pw, k) + r[k], 0, 255);
    if (k < 4) out.x |= v << (8 * k);
    else out.y |= v << (8 * (k - 4));
  }
  if (live) *reinterpret_cast<uint2*>(rec + pix) = out;

  // ---- the block's coefficients: contiguous in qzig, 16-byte stores --------
  __syncthreads();
  const int n4 = min(MB_PER_BLOCK, n_mb - mb0) * 96;
  const int4* zs = reinterpret_cast<const int4*>(&zig[0][0]);
  int4* zg = reinterpret_cast<int4*>(qzig + (size_t)mb0 * 384);
  for (int k = threadIdx.x; k < n4; k += TF_THREADS) zg[k] = zs[k];
}

// One stage of the transform on n_tiles raster int32 tiles: 0 the FDCT, 1
// quantise (out) and dequantise (out2) with inter[tile], 2 the IDCT.
__global__ void __launch_bounds__(TF_THREADS) transform_stage_kernel(
    const int32_t* __restrict__ in, const uint8_t* __restrict__ inter,
    int32_t* __restrict__ out, int32_t* __restrict__ out2, int n_tiles, int stage,
    int q_level) {
  __shared__ int32_t tiles[TF_THREADS / 8][8 * TS];
  __shared__ QTables qt;
  load_tables(qt);
  __syncthreads();
  const int tl = threadIdx.x >> 3, i = threadIdx.x & 7;
  const int first = blockIdx.x * (TF_THREADS / 8);
  const bool live = first + tl < n_tiles;
  const size_t base = (size_t)(live ? first + tl : n_tiles - 1) * 64;
  int32_t v[8], o[8];
  if (stage == 0) {
#pragma unroll
    for (int k = 0; k < 8; k++) v[k] = in[base + i * 8 + k];
    fdct8(v, tiles[tl], i, o);
    if (live)
      for (int u = 0; u < 8; u++) out[base + u * 8 + i] = o[u];
  } else if (stage == 1) {
    const bool is_inter = inter[base / 64] != 0;
    for (int u = 0; u < 8; u++) {
      const int p = u * 8 + i;
      const int32_t qs = quant(qt, in[base + p], p, is_inter, q_level);
      if (live) {
        out[base + p] = qs;
        out2[base + p] = dequant(qt, qs, p, is_inter, q_level);
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; u++) v[u] = in[base + u * 8 + i];
    idct8(v, tiles[tl], i, o);
    if (live)
      for (int k = 0; k < 8; k++) out[base + i * 8 + k] = o[k];
  }
}

}  // namespace

extern "C" int mpeg2_transform(const void* cy, const void* cu, const void* cv,
                               const void* py, const void* pu, const void* pv,
                               const void* inter, void* qzig, void* ry, void* ru,
                               void* rv, int nby, int nbx, int q_level,
                               void* stream) {
  const int n_mb = nby * nbx;
  transform_kernel<<<(n_mb + MB_PER_BLOCK - 1) / MB_PER_BLOCK, TF_THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)cy, (const uint8_t*)cu, (const uint8_t*)cv,
      (const uint8_t*)py, (const uint8_t*)pu, (const uint8_t*)pv,
      (const uint8_t*)inter, (int32_t*)qzig, (uint8_t*)ry, (uint8_t*)ru,
      (uint8_t*)rv, n_mb, nbx, q_level);
  return (int)cudaGetLastError();
}

extern "C" int mpeg2_transform_stage(const void* in, const void* inter, void* out,
                                     void* out2, int n_tiles, int stage, int q_level,
                                     void* stream) {
  const int per_block = TF_THREADS / 8;
  transform_stage_kernel<<<(n_tiles + per_block - 1) / per_block, TF_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)in, (const uint8_t*)inter, (int32_t*)out, (int32_t*)out2,
      n_tiles, stage, q_level);
  return (int)cudaGetLastError();
}
