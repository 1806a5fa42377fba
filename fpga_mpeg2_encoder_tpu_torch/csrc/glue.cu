// Symbol glue kernel: everything of a frame's symbolisation but the AC
// symbols, in one launch.  Per macroblock: the coded-block pattern, the
// macroblock type, the two motion-vector differentials, the DC differentials
// of its six tiles (intra: size code and value; inter: put_AC of run 0), the
// EOB slots, and the AC operands that the acsym kernel reads (zmod: the
// coefficients with position 0 replaced by the emit flag); per slice row its
// 3 header slots; and, when asked, the GOP and picture header rows
// (RTL/mpeg2encoder.v:2650-2834).
//
// Replaces the non-AC part of ops/entropy.py::symbolize_frame of the JAX
// package (plain XLA code of its jitted frame step, fused there into a few
// passes).  Plain version: ops/entropy.py::ac_inputs and _header_rows.
//
// Bound by device memory traffic: per macroblock 1.5 KB of coefficients in,
// 1.5 KB of zmod and 1.6 KB of slots out, a few dozen integer operations.
// Every value depends only on the macroblock and its left neighbour in the
// same row (the MV predictor, luma tile 3 and the chroma DCs), so there is no
// scan: a warp takes a macroblock, reads its 384 coefficients in three
// 16-byte loads a lane and writes zmod the same way; a tile's nonzero flag is
// a ballot; the left neighbour's few values are read from device memory.
// A block's slots (8 macroblocks, and the slice headers of the rows that
// start among them) form one contiguous span of the grid: staged in shared
// memory, zero at the AC slots, then written in aligned 16-byte stores with
// 4-byte stores at the unaligned head and tail.  The VLC tables are the
// cached device copies of ops/entropy.py's, staged in shared memory (the
// lookups diverge).  Header-row blocks follow the macroblock blocks in the
// grid; with no macroblock (nby = 0) the launch writes the header rows alone.
//
// Slots are uint32 code | len << 27, stored into int32.  The GOP position and
// the frame number are read from device memory, so a captured graph replays
// the launch with the values of its step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SLOTS_PER_MB = 4 + 6 * 65;
constexpr int HDR_SLOTS = 3;
constexpr int MBB = 8;                        // macroblocks per block, a warp each
constexpr int THREADS = 32 * MBB;
// MBB macroblocks, a slice header before each (nbx = 1), and up to 3 words in
// front of the span's first slot to align it
constexpr int SPAN_WORDS = MBB * (SLOTS_PER_MB + HDR_SLOTS) + 4;
constexpr int HDR_CHUNK = 16 * THREADS;       // header-row words a block writes
// table sizes: ops/entropy.py _TABLES (the header table is 2 x 14)
constexpr int MV_N = 17, CBP_N = 64, DC_N = 13, AC_N = 144;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t slot(uint32_t code, uint32_t len) {
  return code | (len << 27);
}

// put_AC (RTL:2525-2547) of a level v != 0 at run 0: ops/entropy.py::_ac_symbol
__device__ __forceinline__ uint32_t put_ac_run0(int v, const uint32_t* ac) {
  const long long am1 = (v < 0 ? -(long long)v : (long long)v) - 1;
  const int key = am1 <= 7 ? (int)am1 : am1 <= 39 ? (int)am1 + 56 : AC_N - 1;
  const uint32_t e = ac[key];
  if (e >= (1u << 22))
    return slot((((e >> 6) & 0xFFFFu) << 1) | (v < 0 ? 1u : 0u), (e & 63u) + 1u);
  return slot((1u << 18) | ((uint32_t)v & 0xFFFu), 24u);   // the 24-bit escape
}

// Flat grid index of macroblock mb's first slot: the slice headers of rows
// 0..by and the slots of macroblocks 0..mb-1 come before it.
__device__ __forceinline__ int mb_first_slot(int mb, int nbx) {
  return HDR_SLOTS * (mb / nbx + 1) + SLOTS_PER_MB * mb;
}

// The 14 header slots (GOP row, then picture row; ops/entropy.py::_header_rows):
// the table's constant slots of the frame's kind plus the timecode and the
// GOP position on the codes.
__device__ uint32_t header_slot(int k, int i_f, int fno, const long long* tab) {
  const uint32_t is_p = i_f != 0;
  uint32_t dyn = 0;
  switch (k) {
    case 2: dyn = (uint32_t)min(fno / (24 * 3600), 63); break;     // hour
    case 3: dyn = (uint32_t)((fno / (24 * 60)) % 60); break;       // minute
    case 4: dyn = (uint32_t)((fno / 24) % 60); break;              // second
    case 5: dyn = (uint32_t)(fno % 24); break;                     // picture
    case 8: dyn = (uint32_t)i_f; break;                            // temporal ref
    case 9: dyn = is_p * 0x10000u; break;                          // coding type
    case 10: dyn = is_p * 0x380u; break;                           // f_code bits
  }
  return (uint32_t)tab[is_p * 14 + k] + dyn;
}

__global__ void __launch_bounds__(THREADS) glue_kernel(
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ inter,
    const int32_t* __restrict__ mvx, const int32_t* __restrict__ mvy,
    const int32_t* __restrict__ i_frame, const int32_t* __restrict__ frame_no,
    const long long* __restrict__ t_mv, const long long* __restrict__ t_cbp,
    const long long* __restrict__ t_dcy, const long long* __restrict__ t_dcuv,
    const long long* __restrict__ t_hdr, const long long* __restrict__ t_ac,
    int32_t* __restrict__ zmod, uint32_t* __restrict__ small, uint32_t* __restrict__ hdr,
    int nbx, int n_mb, int n_mb_blocks, int q_level, int first_row, int hs) {
  const int tid = threadIdx.x;

  if ((int)blockIdx.x >= n_mb_blocks) {       // the GOP and picture header rows
    __shared__ uint32_t hv[14];
    if (tid < 14) hv[tid] = header_slot(tid, *i_frame, *frame_no, t_hdr);
    __syncthreads();
    const long long total = 2LL * hs;
    const long long start = (long long)(blockIdx.x - n_mb_blocks) * HDR_CHUNK;
    const long long stop = min(start + HDR_CHUNK, total);
    for (long long w = start + 4 * tid; w < stop; w += 4 * THREADS) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const long long j = w + i;
        const int r = j >= hs, c = (int)(j - (long long)r * hs);
        v[i] = c < 7 ? hv[7 * r + c] : 0u;
      }
      if (w + 4 <= stop) {
        *reinterpret_cast<uint4*>(hdr + w) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
        for (int i = 0; i < stop - w; i++) hdr[w + i] = v[i];
      }
    }
    return;
  }

  __shared__ uint32_t s_mv[MV_N], s_cbp[CBP_N], s_dcy[DC_N], s_dcuv[DC_N], s_ac[AC_N];
  __shared__ __align__(16) uint32_t stage[SPAN_WORDS];
  const int warp = tid >> 5, lane = tid & 31;
  const int mb0 = blockIdx.x * MBB, nmb = min(MBB, n_mb - mb0);
  const int mb = mb0 + warp;
  const bool valid = warp < nmb;

  // this warp's macroblock: lane l holds 16-byte quads l, l + 32 and l + 64,
  // so load i holds tile 2i in lanes 0-15 and tile 2i + 1 in lanes 16-31
  int4 z[3] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  if (valid) {
    const int4* src = reinterpret_cast<const int4*>(qz + (long long)mb * 384);
#pragma unroll
    for (int i = 0; i < 3; i++) z[i] = src[lane + 32 * i];
  }

  // the tables, and the staged span zeroed (the AC slots stay zero)
  for (int i = tid; i < MV_N; i += THREADS) s_mv[i] = (uint32_t)t_mv[i];
  for (int i = tid; i < CBP_N; i += THREADS) s_cbp[i] = (uint32_t)t_cbp[i];
  for (int i = tid; i < DC_N; i += THREADS) {
    s_dcy[i] = (uint32_t)t_dcy[i];
    s_dcuv[i] = (uint32_t)t_dcuv[i];
  }
  for (int i = tid; i < AC_N; i += THREADS) s_ac[i] = (uint32_t)t_ac[i];
  for (int i = tid; i < SPAN_WORDS / 4; i += THREADS)
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0u, 0u, 0u, 0u);

  // the block's span of the grid: [first, end), staged at stage[i - base]
  const int first = mb_first_slot(mb0, nbx) - (mb0 % nbx == 0 ? HDR_SLOTS : 0);
  const int end = mb_first_slot(mb0 + nmb - 1, nbx) + SLOTS_PER_MB;
  const int base = first & ~3;
  __syncthreads();

  if (valid) {
    const bool intra = !inter[mb];
    const bool is_p = *i_frame != 0;
    // nz: bit t set when tile t is coded (intra, or a nonzero coefficient)
    uint32_t nz = 0;
#pragma unroll
    for (int i = 0; i < 3; i++) {
      const uint32_t b = __ballot_sync(FULL, (z[i].x | z[i].y | z[i].z | z[i].w) != 0);
      nz |= (uint32_t)((b & 0xFFFFu) != 0) << (2 * i) | (uint32_t)((b >> 16) != 0) << (2 * i + 1);
    }
    if (intra) nz = 0x3Fu;
    const uint32_t cbp = __brev(nz) >> 26;   // tile t at bit 5 - t
    // lane t < 6 takes tile t's DC: element 0 of load t / 2, lane (t & 1) * 16
    const int src = (lane & 1) * 16;
    const int d0 = __shfl_sync(FULL, z[0].x, src), d1 = __shfl_sync(FULL, z[1].x, src),
              d2 = __shfl_sync(FULL, z[2].x, src);
    const int dc = lane < 2 ? d0 : lane < 4 ? d1 : d2;
    const int dc_prev_tile = __shfl_up_sync(FULL, dc, 1);

    // zmod: the coefficients with position 0 replaced by the emit flag
    int4* dst = reinterpret_cast<int4*>(zmod + (long long)mb * 384);
#pragma unroll
    for (int i = 0; i < 3; i++) {
      int4 o = z[i];
      if ((lane & 15) == 0) o.x = intra || o.x != 0;
      dst[lane + 32 * i] = o;
    }

    // the left neighbour in the slice (none at bx = 0: predictors 0)
    const int bx = mb % nbx;
    const bool left_inter = bx > 0 && inter[mb - 1];
    const bool left_intra = bx > 0 && !inter[mb - 1];
    const int mbs = mb_first_slot(mb, nbx) - base;

    if (lane < 6) {
      uint32_t dc_slot;
      if (!intra) {
        // inter DC: 0 emits nothing (it counts as run; the slot keeps the
        // dead code of put_AC(1)), +-1 is the 2-bit '1s', else put_AC(v, 0)
        if (dc == 0) dc_slot = put_ac_run0(1, s_ac) & ((1u << 27) - 1);
        else if (dc == 1 || dc == -1) dc_slot = slot(2u | (dc < 0 ? 1u : 0u), 2u);
        else dc_slot = put_ac_run0(dc, s_ac);
      } else {
        // intra DC against the previous tile in the slice's chain: luma tile
        // 0 against the left macroblock's tile 3, tiles 1-3 against tile
        // t - 1, chroma against the left macroblock's U or V
        long long pred;
        if (lane >= 1 && lane <= 3) {
          pred = dc_prev_tile;
        } else {
          const int t = lane == 0 ? 3 : lane;
          pred = left_intra ? qz[(long long)(mb - 1) * 384 + t * 64] : 0;
        }
        const long long diff = (long long)dc - pred;
        const unsigned long long mag = diff < 0 ? 0ull - (unsigned long long)diff
                                                : (unsigned long long)diff;
        uint32_t vallen = 0;
#pragma unroll
        for (int k = 0; k < 12; k++) vallen += mag >= (1ull << k);
        uint32_t val = (uint32_t)diff & 0xFFFu;
        if (diff < 0) val = (val + (1u << vallen) - 1u) & 0xFFFu;
        val &= (1u << vallen) - 1u;
        const uint32_t e = lane < 4 ? s_dcy[vallen] : s_dcuv[vallen];
        dc_slot = slot(((e >> 5) << vallen) | val, (e & 31u) + vallen);
      }
      stage[mbs + 4 + 65 * lane] = dc_slot;
      stage[mbs + 4 + 65 * lane + 64] = slot(2u, 2u * ((nz >> lane) & 1u));   // EOB
    } else if (lane == 6) {                   // macroblock type (RTL:2722-2731)
      stage[mbs] = intra && is_p ? slot(0x23u, 6u)
                 : !intra && cbp == 0 ? slot(0x09u, 4u) : slot(0x03u, 2u);
    } else if (lane == 7 || lane == 8) {      // MV differentials (RTL:2735-2763)
      const int32_t* mv = lane == 7 ? mvx : mvy;
      const uint32_t pred = left_inter ? (uint32_t)mv[mb - 1] : 0u;
      const int dmv = (int)(((uint32_t)mv[mb] - pred + 16u) & 31u) - 16;
      const uint32_t e = s_mv[dmv < 0 ? -dmv : dmv];
      const uint32_t s = dmv != 0;
      stage[mbs + lane - 6] = slot(((e >> 5) << s) | (dmv < 0 ? 1u : 0u),
                                   intra ? 0u : (e & 31u) + s);
    } else if (lane == 9) {                   // coded-block pattern
      const uint32_t e = s_cbp[cbp];
      stage[mbs + 3] = slot(e >> 5, intra ? 0u : e & 31u);
    } else if (lane < 10 + HDR_SLOTS && bx == 0) {   // the slice header
      const int k = lane - 10;
      const uint32_t y = (uint32_t)(first_row + mb / nbx);
      stage[mbs - HDR_SLOTS + k] = k == 0 ? slot(1u, 24u)
                                 : k == 1 ? slot(y + 1u, 8u) : slot(2u << q_level, 6u);
    }
  }
  __syncthreads();

  // the span out: 4-byte stores at the unaligned head and tail, 16-byte
  // stores between (a span is at least 394 slots, so a0 <= a1)
  const int a0 = (first + 3) & ~3, a1 = end & ~3;
  if (tid < a0 - first) small[first + tid] = stage[first + tid - base];
  if (tid < end - a1) small[a1 + tid] = stage[a1 + tid - base];
  for (int j = a0 + 4 * tid; j < a1; j += 4 * THREADS)
    *reinterpret_cast<uint4*>(small + j) = *reinterpret_cast<const uint4*>(stage + j - base);
}

}  // namespace

// nby = 0 writes the header rows alone; hs = 0 writes no header rows.
extern "C" int mpeg2_glue(const void* qz, const void* inter, const void* mvx,
                          const void* mvy, const void* i_frame, const void* frame_no,
                          const void* t_mv, const void* t_cbp, const void* t_dcy,
                          const void* t_dcuv, const void* t_hdr, const void* t_ac,
                          void* zmod, void* small, void* hdr, int nby, int nbx,
                          int q_level, int first_row, int hs, void* stream) {
  const int n_mb = nby * nbx;
  const int n_mb_blocks = (n_mb + MBB - 1) / MBB;
  const int n_hdr_blocks = (int)((2LL * hs + HDR_CHUNK - 1) / HDR_CHUNK);
  if (n_mb_blocks + n_hdr_blocks == 0) return 0;
  glue_kernel<<<n_mb_blocks + n_hdr_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qz, (const uint8_t*)inter, (const int32_t*)mvx, (const int32_t*)mvy,
      (const int32_t*)i_frame, (const int32_t*)frame_no, (const long long*)t_mv,
      (const long long*)t_cbp, (const long long*)t_dcy, (const long long*)t_dcuv,
      (const long long*)t_hdr, (const long long*)t_ac, (int32_t*)zmod, (uint32_t*)small,
      (uint32_t*)hdr, nbx, n_mb, n_mb_blocks, q_level, first_row, hs);
  return (int)cudaGetLastError();
}
