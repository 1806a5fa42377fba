// AC symbolisation kernel: run lengths, Table B.14 codes or 24-bit escapes,
// and the sign bit for every AC coefficient (put_AC, RTL/mpeg2encoder.v:
// 2525-2547 and 2823-2834), routed straight into the frame's slot grid and
// merged with the pre-packed non-AC slots.
//
// Replaces ops/pallas/acsym.py::ac_slot_grid_pallas of the JAX package.
// Plain version: ops/entropy.py::ac_slot_grid.
//
// Bound by device memory traffic: per macroblock 1.5 KB of coefficients and
// 64 B of non-AC slots in, 1.6 KB of slots out, with a handful of integer
// operations per coefficient.  The design keeps many bytes in flight and
// writes whole lines:
// * 4 macroblocks a block, 16 threads a tile, 4 coefficients a thread in one
//   16-byte load, so a warp reads 512 contiguous bytes;
// * a tile's 64-bit emit mask is the OR of its 16 threads' 4-bit nibbles
//   (two 32-bit halves, each a warp reduction); a coefficient's run is its
//   distance to the highest emit below it;
// * the B.14 entries are staged in shared memory (the lookups diverge);
// * the block's slots (its macroblocks, and the 3 slice-header slots of a
//   row that starts in it) form one contiguous span of the grid: staged in
//   shared memory, then written in aligned 16-byte stores, with 4-byte
//   stores at the unaligned head and tail.
// The TPU kernel's routing barrel and one-hot table matmuls are not needed:
// each AC slot index is computed directly, so every slot is written once.
//
// Slots are int32 holding the uint32 code | len << 27; zero coefficients get
// a zero slot.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ops/entropy.py AC_TABLE: compact B.14 key -> valid<<22 | code<<6 | len
__device__ const uint32_t c_ac_table[144] = {
    4194498, 4194564, 4194629, 4194695, 4196744, 4196424,
    4194954, 4196172, 4194499, 4194694, 4196680, 4195082,
    4196044, 4195725, 4195661, 4196303, 4194628, 4194567,
    4195018, 4195596, 4195597, 0, 0, 0,
    4194757, 4196616, 4196108, 4195533, 0, 0,
    0, 0, 4194693, 4195274, 4195468, 0,
    0, 0, 0, 0, 4194758, 4194890,
    4195469, 0, 0, 0, 0, 0,
    4194630, 4196236, 4195600, 0, 0, 0,
    0, 0, 4194566, 4195660, 0, 0,
    0, 0, 0, 0, 4195852, 4195532,
    4195340, 4195981, 4195917, 4195853, 4195789, 4196302,
    4196238, 4196174, 4196110, 4196046, 4195982, 4195918,
    4195854, 4195790, 4195726, 4195662, 4195598, 4195534,
    4195470, 4195406, 4195342, 4195855, 4195791, 4195727,
    4195663, 4195599, 4195535, 4195471, 4195407, 4195343,
    4196239, 4196175, 4196111, 4196047, 4195983, 4195919,
    4195536, 4195472, 4195408, 4195344, 4194759, 4195404,
    4194631, 4195405, 4196808, 4195341, 4196552, 4195984,
    4196488, 4195920, 4196360, 4195856, 4195210, 4195792,
    4195146, 4195728, 4194826, 4195664, 4196300, 4195980,
    4195916, 4195788, 4195724, 4196301, 4196237, 4196173,
    4196109, 4196045, 4196304, 4196240, 4196176, 4196112,
    4196048, 0, 0, 0, 0, 0};

constexpr int SLOTS_PER_MB = 4 + 6 * 65;
constexpr int HDR_SLOTS = 3;
constexpr int MBB = 4;                        // macroblocks per block
constexpr int THREADS = MBB * 96;             // 6 tiles x 16 threads each
// the staged span: MBB macroblocks, a slice header before each (nbx = 1),
// and up to 3 words in front of the span's first slot to align it
constexpr int SPAN_WORDS = MBB * (SLOTS_PER_MB + HDR_SLOTS) + 4;

// ops/entropy.py::_ac_key
__device__ __forceinline__ int ac_key(int run, int am1) {
  if (run <= 7 && am1 <= 7) return run * 8 + am1;
  if (run == 0 && am1 >= 8 && am1 <= 39) return 64 + am1 - 8;
  if (run == 1 && am1 >= 8 && am1 <= 17) return 96 + am1 - 8;
  if (run >= 8 && run <= 16 && am1 <= 1) return 106 + (run - 8) * 2 + am1;
  if (run >= 17 && run <= 31 && am1 == 0) return 124 + run - 17;
  return 143;
}

// The slot of nonzero coefficient z at zig-zag position p of a tile whose
// emit mask is `mask`; 0 for z == 0.
__device__ __forceinline__ uint32_t ac_slot(int z, int p, uint64_t mask,
                                            const uint32_t* tab) {
  if (z == 0) return 0;
  const uint64_t below = mask & ((1ull << p) - 1);
  const int prev = below ? 63 - __clzll((long long)below) : -1;
  const int run = p - prev - 1;
  const int am1 = (z < 0 ? -z : z) - 1;
  const uint32_t e = tab[ac_key(run, am1)];
  uint32_t code, len;
  if (e >= (1u << 22)) {
    code = (((e >> 6) & 0xFFFFu) << 1) | (z < 0 ? 1u : 0u);
    len = (e & 63u) + 1u;
  } else {                                    // 24-bit escape (RTL:2541-2543)
    code = (1u << 18) | ((uint32_t)run << 12) | ((uint32_t)z & 0xFFFu);
    len = 24u;
  }
  return code | (len << 27);
}

// Flat grid index of macroblock mb's first slot: the slice headers of rows
// 0..by and the slots of macroblocks 0..mb-1 come before it.
__device__ __forceinline__ int mb_first_slot(int mb, int nbx) {
  return HDR_SLOTS * (mb / nbx + 1) + SLOTS_PER_MB * mb;
}

__global__ void __launch_bounds__(THREADS) acsym_kernel(
    const int32_t* __restrict__ zmod, const uint32_t* __restrict__ small,
    uint32_t* __restrict__ out, int nbx, int n_mb) {
  __shared__ uint32_t tab[144];
  __shared__ __align__(16) uint32_t stage[SPAN_WORDS];
  const int tid = threadIdx.x, lane = tid & 31;
  const int mb0 = blockIdx.x * MBB, nmb = min(MBB, n_mb - mb0);
  // the block's span of the grid: [first, end), staged at stage[i - base]
  const int first = mb_first_slot(mb0, nbx) - (mb0 % nbx == 0 ? HDR_SLOTS : 0);
  const int end = mb_first_slot(mb0 + nmb - 1, nbx) + SLOTS_PER_MB;
  const int base = first & ~3;
  for (int i = tid; i < 144; i += THREADS) tab[i] = c_ac_table[i];

  // thread (macroblock mbl, tile t, quad q) holds positions 4q..4q+3
  const int mbl = tid / 96, w = tid - mbl * 96, t = w >> 4, q = w & 15;
  const int mb = mb0 + mbl;
  const bool valid = mbl < nmb;
  int4 z4 = make_int4(0, 0, 0, 0);
  if (valid) z4 = *reinterpret_cast<const int4*>(zmod + (long long)mb * 384 + t * 64 + 4 * q);
  const int z[4] = {z4.x, z4.y, z4.z, z4.w};

  // The tile's emit mask.  Position 0 carries the emit flag, which only
  // feeds the runs.  A warp holds two tiles; lanes 0-7 hold positions 0-31
  // of the first, 8-15 its 32-63, 16-23 and 24-31 the same of the second.
  const uint32_t nib = (z[0] != 0) | (z[1] != 0) << 1 | (z[2] != 0) << 2 | (z[3] != 0) << 3;
  const uint32_t v = nib << ((lane & 7) * 4);
  const int g = lane >> 3;
  const uint32_t r0 = __reduce_or_sync(0xffffffffu, g == 0 ? v : 0u);
  const uint32_t r1 = __reduce_or_sync(0xffffffffu, g == 1 ? v : 0u);
  const uint32_t r2 = __reduce_or_sync(0xffffffffu, g == 2 ? v : 0u);
  const uint32_t r3 = __reduce_or_sync(0xffffffffu, g == 3 ? v : 0u);
  const uint32_t lo = lane < 16 ? r0 : r2, hi = lane < 16 ? r1 : r3;
  const uint64_t mask = ((uint64_t)hi << 32) | lo;
  __syncthreads();                            // tab

  if (valid) {
    const int mbs = mb_first_slot(mb, nbx) - base;
    // non-AC slots of this macroblock: type, mv x, mv y, cbp, then each
    // tile's DC and EOB; and, at bx = 0, the slice header
    if (w < 16) {
      const int i = w < 4 ? w : w < 10 ? 4 + 65 * (w - 4) : 4 + 65 * (w - 10) + 64;
      stage[mbs + i] = small[base + mbs + i];
    } else if (w < 16 + HDR_SLOTS && mb % nbx == 0) {
      const int i = mbs - HDR_SLOTS + (w - 16);
      stage[i] = small[base + i];
    }
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int p = 4 * q + i;
      if (p != 0) stage[mbs + 4 + 65 * t + p] = ac_slot(z[i], p, mask, tab);
    }
  }
  __syncthreads();

  // the span out: 4-byte stores at the unaligned head and tail, 16-byte
  // stores between (a span is at least 394 slots, so a0 <= a1)
  const int a0 = (first + 3) & ~3, a1 = end & ~3;
  if (tid < a0 - first) out[first + tid] = stage[first + tid - base];
  if (tid < end - a1) out[a1 + tid] = stage[a1 + tid - base];
  for (int j = a0 + 4 * tid; j < a1; j += 4 * THREADS)
    *reinterpret_cast<uint4*>(out + j) = *reinterpret_cast<const uint4*>(stage + j - base);
}

}  // namespace

extern "C" int mpeg2_acsym(const void* zmod, const void* small, void* out,
                           int nby, int nbx, void* stream) {
  const int n_mb = nby * nbx;
  if (n_mb == 0) return 0;
  acsym_kernel<<<(n_mb + MBB - 1) / MBB, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)zmod, (const uint32_t*)small, (uint32_t*)out, nbx, n_mb);
  return (int)cudaGetLastError();
}
