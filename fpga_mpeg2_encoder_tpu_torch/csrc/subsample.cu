// 4:4:4 -> 4:2:0 chroma subsample kernel (stages A-C, RTL/mpeg2encoder.v:
// 1086-1171): both chroma planes in one launch.  Two mean2 reductions, each
// with its own +1 rounding, horizontal pairs first, then vertical pairs; not
// one mean of four, whose rounding differs.
//
// Replaces ops/colorspace.py::subsample_420 of the JAX package (plain XLA
// code of its jitted frame step, one fused elementwise pass there).  Plain
// version: ops/colorspace.py::subsample_420.
//
// Bound by device memory traffic: each input byte is read once and a quarter
// as many are written, with four byte-SIMD operations per 4 output bytes
// (4.4 MB in, 1.1 MB out at 1920x1152).  A thread takes 16 bytes of two
// adjacent rows in two 16-byte loads, splits each row's words into their even
// and odd bytes with byte permutes, averages them with __vavgu4 (per byte
// (a + b + 1) >> 1, exactly mean2), and writes its 8 output bytes in one
// 8-byte store.  A row of W input bytes (W a multiple of 16) is W / 16 such
// threads and its output row W / 2 bytes, 8-byte aligned, so no row needs a
// tail, whatever W / 2 is mod 16 (720 px: 360, 8 mod 16).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// Four output bytes from 8 bytes of the upper row (t0, t1) and 8 of the
// lower row (b0, b1): byte c is pixel pair (2c, 2c + 1).
__device__ __forceinline__ uint32_t half4(uint32_t t0, uint32_t t1, uint32_t b0,
                                          uint32_t b1) {
  const uint32_t te = __byte_perm(t0, t1, 0x6420), to = __byte_perm(t0, t1, 0x7531);
  const uint32_t be = __byte_perm(b0, b1, 0x6420), bo = __byte_perm(b0, b1, 0x7531);
  const uint32_t upper = __vavgu4(te, to), lower = __vavgu4(be, bo);   // horizontal
  return __vavgu4(lower, upper);                                       // vertical
}

__global__ void __launch_bounds__(THREADS) subsample_kernel(
    const uint8_t* __restrict__ u, const uint8_t* __restrict__ v, uint8_t* __restrict__ uo,
    uint8_t* __restrict__ vo, int ho, int w) {
  const int groups = w / 16;                  // threads a row pair
  const long long per_plane = (long long)ho * groups;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= 2 * per_plane) return;
  const bool second = i >= per_plane;
  const long long k = second ? i - per_plane : i;
  const int r = (int)(k / groups), g = (int)(k - (long long)r * groups);
  const uint8_t* src = (second ? v : u) + (long long)(2 * r) * w + 16 * g;
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint4 b = *reinterpret_cast<const uint4*>(src + w);
  uint8_t* dst = (second ? vo : uo) + (long long)r * (w / 2) + 8 * g;
  *reinterpret_cast<uint2*>(dst) = make_uint2(half4(a.x, a.y, b.x, b.y),
                                              half4(a.z, a.w, b.z, b.w));
}

}  // namespace

// u, v: (2 * ho, w) uint8, 16-byte aligned, w a multiple of 16; uo, vo:
// (ho, w / 2) uint8.
extern "C" int mpeg2_subsample(const void* u, const void* v, void* uo, void* vo, int ho,
                               int w, void* stream) {
  const long long n = 2LL * ho * (w / 16);
  if (n == 0) return 0;
  subsample_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>((const uint8_t*)u, (const uint8_t*)v,
                                             (uint8_t*)uo, (uint8_t*)vo, ho, w);
  return (int)cudaGetLastError();
}
