// Throughput loop of the byte-SIMD absolute-difference instruction that the
// motion search runs (PTX vabsdiff4 with .add, SASS VABSDIFF4), driven by
// vabsdiff4_rate.py.  Every thread runs 8 independent accumulator chains,
// so that with 32 warps on an SM the loop is bound by the instruction's
// issue rate and not by its latency; each block reads the SM clock around
// its loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t acc) {
  uint32_t d;
  asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

__global__ void vabsdiff4_loop(uint32_t* out, long long* cycles, int iters) {
  uint32_t acc[8];
#pragma unroll
  for (int k = 0; k < 8; k++) acc[k] = (threadIdx.x * (k + 1)) ^ blockIdx.x;
  const uint32_t b = 0x9E3779B9u ^ threadIdx.x;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int it = 0; it < iters; it++)
#pragma unroll
    for (int k = 0; k < 8; k++) acc[k] = sad4(acc[k], b, acc[k]);
  __syncthreads();
  const long long t1 = clock64();
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) s ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

extern "C" int vabsdiff4_rate(void* out, void* cycles, int blocks, int threads,
                              int iters, void* stream) {
  vabsdiff4_loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (long long*)cycles, iters);
  return (int)cudaGetLastError();
}
