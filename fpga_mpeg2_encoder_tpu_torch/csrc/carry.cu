// The GOP carry of encode_gop_scan's frame step (models/encoder.py::
// _GopProgram): what the step carries from one frame to the next once the
// frame's rows are in the sequence buffer, in one launch.
//
// Replaces no kernel of the JAX package: there XLA fuses the scan step's
// bookkeeping (JAX models/encoder.py:268, the scan's carry) into the jitted
// step.  Plain version: ops/kernels/carry.py::plain_carry, the torch ops the
// step ran before (the overflow ORs, the two scatters of the per-frame
// outputs, the GOP advance, the copies of the carry).
//
// Bound by its launch: it reads at most a few hundred bytes (a frame's row
// bit counts, 74 of them at 1920x1152, and a dozen scalars) and writes 28.
// One block of one warp: each lane tests every 32nd row's bits against the
// row cap, a ballot ORs them, and lane 0 writes the carry; the scalars are
// loaded with the rows, so the kernel waits on memory about once.  It runs
// after the merge kernel, in stream order, so it reads the frame's bits,
// overflow and new sequence bit count that the merge wrote, and it is the
// only writer of the GOP state in the step: the motion and glue kernels
// read the GOP position and the frame number before it runs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct CarryArgs {
  const int64_t* row_bits;     // (r,) the pack kernel's row bit counts
  const int64_t* fbits;        // () the merge kernel's frame bits
  const bool* frame_ovf;       // () the merge kernel's frame overflow
  const int64_t* new_bits;     // () the merge kernel's new sequence bit count
  int64_t* seq_bits;           // () the sequence bit count carried
  bool* overflow;              // () the chunk's overflow carried
  int32_t* i_frame;            // () the GOP position, 0 for an I-frame
  const int32_t* pframes;      // () P-frames a GOP
  int32_t* frame_no;           // () frames since the sequence start
  int64_t* k;                  // (1,) the frame's index in the chunk
  int64_t* frame_bits;         // (frames_cap,) each frame's bits
  int32_t* frame_ifs;          // (frames_cap,) each frame's GOP position
  int r, row_cap, frames_cap;
};

__global__ void __launch_bounds__(32) gop_carry_kernel(const CarryArgs a) {
  // Every load is issued before the first store, and the rows' loads are
  // not short-circuited: a store may alias a later load, so a load after one
  // would wait a full round trip to memory of its own.
  const int lane = threadIdx.x;
  const long long cap_bits = 32LL * a.row_cap;
  bool row_over = false;
#pragma unroll 4
  for (int i = lane; i < a.r; i += 32) row_over |= a.row_bits[i] > cap_bits;
  const bool over_before = *a.overflow, frame_over = *a.frame_ovf;
  const long long new_bits = *a.new_bits, fbits = *a.fbits, k = *a.k;
  const int32_t pos = *a.i_frame, pframes = *a.pframes, frame_no = *a.frame_no;
  row_over = __any_sync(0xffffffffu, row_over);
  if (lane != 0) return;
  *a.overflow = over_before || row_over || frame_over;
  *a.seq_bits = new_bits;
  if (k >= 0 && k < a.frames_cap) {          // the plain scatter raises outside
    a.frame_bits[k] = fbits;
    a.frame_ifs[k] = pos;
  }
  // the GOP wraps to an I-frame after pframes P-frames (RTL/mpeg2encoder.v:
  // 1060-1068); int32 adds wrap, as torch's do
  *a.i_frame = pos >= pframes ? 0 : (int32_t)((uint32_t)pos + 1u);
  *a.frame_no = (int32_t)((uint32_t)frame_no + 1u);
  *a.k = k + 1;
}

}  // namespace

// Every pointer is device memory; row_bits (r,) int64, k (1,) int64,
// frame_bits (frames_cap,) int64, frame_ifs (frames_cap,) int32, the rest
// 0-d (bool, int32 or int64 as CarryArgs says).
extern "C" int mpeg2_gop_carry(const void* row_bits, const void* fbits, const void* frame_ovf,
                               const void* new_bits, void* seq_bits, void* overflow,
                               void* i_frame, const void* pframes, void* frame_no, void* k,
                               void* frame_bits, void* frame_ifs, int r, int row_cap,
                               int frames_cap, void* stream) {
  if (r < 0 || row_cap < 0 || frames_cap < 0) return (int)cudaErrorInvalidValue;
  const CarryArgs a{(const int64_t*)row_bits, (const int64_t*)fbits, (const bool*)frame_ovf,
                    (const int64_t*)new_bits, (int64_t*)seq_bits, (bool*)overflow,
                    (int32_t*)i_frame, (const int32_t*)pframes, (int32_t*)frame_no,
                    (int64_t*)k, (int64_t*)frame_bits, (int32_t*)frame_ifs, r, row_cap,
                    frames_cap};
  gop_carry_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
