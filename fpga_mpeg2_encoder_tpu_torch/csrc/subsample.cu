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
//
// Two entries share that device code.  mpeg2_subsample takes the planes'
// addresses from the host.  mpeg2_subsample_stack is the first kernel of
// encode_gop_scan's captured frame step (models/encoder.py::_GopProgram): it
// reads frame k of the caller's (F, H, W) stacks in place, k and each
// plane's base address and frame stride loaded from device memory at its
// head (the program writes the table once a chunk; the carry kernel advances
// k), so a replay needs no copy of the frame into the program.  In the same
// launch it copies frame k's Y plane into the program's own Y plane, which
// the motion and transform kernels read, 16 bytes a thread: one thread a
// 16-byte group of Y beside each thread of the chroma, since a frame's
// 2 * ho * w Y bytes are as many groups as the chroma has threads.  At
// 1920x1152 it moves 9.9 MB (4.4 MB of chroma in, 1.1 MB out, 2.2 MB of Y
// each way), about 3 us at 3.35 TB/s, where the three copies of the frame's
// planes it replaces took 9.6 us.
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

// Thread i of 2 * ho * (w / 16): U's row pairs first, then V's.
__device__ __forceinline__ void subsample_thread(long long i, const uint8_t* __restrict__ u,
                                                 const uint8_t* __restrict__ v,
                                                 uint8_t* __restrict__ uo,
                                                 uint8_t* __restrict__ vo, int ho, int w) {
  const int groups = w / 16;                  // threads a row pair
  const long long per_plane = (long long)ho * groups;
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

__global__ void __launch_bounds__(THREADS) subsample_kernel(
    const uint8_t* __restrict__ u, const uint8_t* __restrict__ v, uint8_t* __restrict__ uo,
    uint8_t* __restrict__ vo, int ho, int w) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= 2LL * ho * (w / 16)) return;
  subsample_thread(i, u, v, uo, vo, ho, w);
}

// Frame f of plane p (0 Y, 1 U, 2 V) of the table: its base address at 2p,
// its frame stride in bytes at 2p + 1.
__device__ __forceinline__ const uint8_t* frame_of(const int64_t* __restrict__ planes, int p,
                                                   long long f) {
  return reinterpret_cast<const uint8_t*>(planes[2 * p] + f * planes[2 * p + 1]);
}

__global__ void __launch_bounds__(THREADS) subsample_kernel_stack(
    const int64_t* __restrict__ planes, const int64_t* __restrict__ k, uint8_t* __restrict__ yo,
    uint8_t* __restrict__ uo, uint8_t* __restrict__ vo, int ho, int w) {
  const long long f = *k;
  const long long chroma = 2LL * ho * (w / 16);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < chroma) {
    subsample_thread(i, frame_of(planes, 1, f), frame_of(planes, 2, f), uo, vo, ho, w);
  } else if (i < 2 * chroma) {
    const long long j = i - chroma;           // Y's 16-byte group
    const uint4* src = reinterpret_cast<const uint4*>(frame_of(planes, 0, f));
    reinterpret_cast<uint4*>(yo)[j] = src[j];
  }
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

// planes: (6,) int64, each of Y, U and V's base address and frame stride in
// bytes, every frame's rows contiguous, addresses and strides multiples of
// 16; k: (1,) int64, the frame; yo: (2 * ho, w) uint8, 16-byte aligned; uo,
// vo: (ho, w / 2) uint8; w a multiple of 16.
extern "C" int mpeg2_subsample_stack(const void* planes, const void* k, void* yo, void* uo,
                                     void* vo, int ho, int w, void* stream) {
  const long long n = 4LL * ho * (w / 16);
  if (n == 0) return 0;
  subsample_kernel_stack<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                           (cudaStream_t)stream>>>((const int64_t*)planes, (const int64_t*)k,
                                                   (uint8_t*)yo, (uint8_t*)uo, (uint8_t*)vo,
                                                   ho, w);
  return (int)cudaGetLastError();
}
