// Bit packing kernels (stages U/V, RTL/mpeg2encoder.v:2879-2956).
//
// pack_slots: concatenate each slot-grid row's symbols MSB first into a
//   left-justified, byte-aligned bit-string of cap words.  Replaces
//   ops/pallas/pack.py::pack_slots_pallas of the JAX package; plain version
//   ops/bitpack.py::pack_slots.  The grid may come as two operands, the
//   header rows and the slice rows apart (the gop program's form: no copy
//   of the grid into one tensor); the rows are numbered across both.
// merge_rows: concatenate R byte-aligned rows into one frame payload, and
//   merge_append: the same rows appended straight to the sequence buffer
//   (merge_rows then append_bitstring).  Both replace
//   ops/pallas/pack.py::merge_rows_pallas; plain versions
//   ops/bitpack.py::merge_rows and merge_append.
//
// pack_slots is bound by reading the slots (4 bytes each, 14 MB a 1920x1152
// frame, where a slot averages under half a bit) and writing the words.
// Every bit offset depends on all earlier lengths of its row; the TPU's
// bit-reversed merge tree existed because Mosaic has no scatter.  Here:
// * a row is cut into tiles of TILE slots, one block each, aligned to 16
//   bytes in its operand's flattened grid; a thread reads its SPT
//   contiguous slots in SPT / 4 16-byte loads, all in flight at once, and
//   holds them in registers, so the slots are read once; a 1920x1152 frame
//   gives 888 blocks, every SM busy;
// * a block scan gives each thread its bit offset in the tile, and the
//   tile's bit-string is formed in shared memory (shared atomicOr: symbols
//   of neighbouring threads may share a word);
// * the tile's offset in its row comes from a single-pass chained scan
//   (decoupled look-back).  Tiles take their index from an atomic ticket, so
//   a tile only waits on tiles that are already running.  Each tile
//   publishes, in one 64-bit status word, first its length and its last 32
//   bits (its aggregate), then its inclusive prefix and the row's last 32
//   bits up to its end (its carry).  Warp 0 reads 32 predecessors' words at
//   once; the nearest inclusive prefix ends the walk, and a shuffle scan
//   adds the lengths and merges the tails into the 32 bits before the tile;
// * each output word is written once, with a plain store, by the tile in
//   which its last bit lies (the row's last tile also writes the final
//   partial word, zero past the row's bits).  A tile's first word begins
//   with bits of earlier tiles: the look-back's window of the 32 bits before
//   the tile supplies them, so no word needs zeroing first and no global
//   atomic;
// * the words after a row's last partial word are written only with fill
//   (the public pack_slots: zeros up to cap, 20.6 MB a 1920x1152 frame at
//   the bounds' caps).  Without it (pack_rows, the gop program's) they keep
//   whatever the buffer held: the merge reads no word past a row's bits;
// * the last block to finish zeroes the status words and the counter, so
//   the next call on the buffer starts clean (also under graph replay).  It
//   clears each status word only after it has read that word's inclusive
//   publish, so no publish of the call can land after the clear and leak
//   into the next call (see the kernel's end).
// merge (merge_rows_kernel): bound by the launch.  A 1920x1152 frame is
//   about 42 000 words under its bits (0.5 MB read and written at 4 bytes a
//   word), against a 2 MB frame buffer.  So no frame buffer, no memset and no
//   atomics: one thread per OUTPUT word, in a fixed grid of a few blocks per
//   SM with a grid-stride loop, and the host never reads a count.
// * Every block scans the rows' bit counts into shared memory (a shuffle
//   scan, MERGE_THREADS rows at a time, for any R).
// * The thread of an output word finds the last row that starts before the
//   word's end by a binary search over the starts, and walks back over the
//   rows whose bits reach into the word, forming the word from at most two
//   words of each row with a funnel shift.  A row's words are read only
//   up to its last partial word, which must be zero past the row's bits,
//   as both pack_slots and pack_rows leave it; what lies after that word is
//   never read (the plain version masks it).
// * Two modes.  Store (merge_rows) writes every word of the (cap,) payload,
//   zeros included.  Append (merge_append) reads seq_bits on the device and
//   ORs each nonzero word into the sequence from word seq_bits >> 5 on,
//   shifted by seq_bits & 31, with append_bitstring's clamp of that offset:
//   one read-modify-write per word, and only the words under the frame's
//   bits.  Frame bits at or past 32 * cap are dropped, as merge_rows drops
//   them.  Block 0 writes the frame's bit count, the new seq_bits (to its own
//   tensor: other blocks read the old one) and the overflow flag.
//
// Slots are int32 holding uint32 code | len << 27 (len <= 31); every code is
// masked to its length, so a zero-length slot emits nothing whatever code it
// carries.  Words are int64 holding uint32 values.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PACK_THREADS = 512;
constexpr int SPT = 8;                                 // slots per thread, a multiple of 4
constexpr int TILE = SPT * PACK_THREADS;               // slots per tile
constexpr int TILE_WORDS = (TILE * 31 + 31) / 32 + 3;  // its longest string, and 2 zero words
constexpr uint32_t ST_AGG = 1, ST_INCL = 2;            // status states
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_BLOCKS_PER_SM = 2;
constexpr int MERGE_MAX_ROWS = 4096;                   // its starts in shared memory: 32 KB

// Look-back state, in one zeroed buffer per stream: one 64-bit counter,
// the tickets taken in its low half and the blocks done in its high half,
// then one status word per tile: bits or carry << 32 | value << 2 | state,
// 0 while unpublished.
struct LookBack {
  unsigned long long* ctl;
  unsigned long long* status;
};

__device__ __forceinline__ unsigned long long status_word(uint32_t state, uint32_t value,
                                                          uint32_t bits32) {
  return (unsigned long long)bits32 << 32 | value << 2 | state;
}

__global__ void __launch_bounds__(PACK_THREADS) pack_slots_kernel(
    const uint32_t* __restrict__ head, const uint32_t* __restrict__ body,
    int64_t* __restrict__ words, int64_t* __restrict__ bits, LookBack lb, int n_head,
    int r, int s, int cap, int tiles_per_row, int n_tiles, bool fill) {
  __shared__ uint32_t str[TILE_WORDS];
  __shared__ int warp_sums[PACK_THREADS / 32];
  __shared__ int s_ticket, s_off, s_last;
  __shared__ uint32_t s_win;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  volatile unsigned long long* st = lb.status;
  if (tid == 0) s_ticket = (int)(uint32_t)atomicAdd(lb.ctl, 1ull);
  __syncthreads();
  const int ticket = s_ticket;
  const int row = ticket / tiles_per_row, k = ticket - row * tiles_per_row;
  // rows 0 .. n_head - 1 are head's, the rest body's: each operand is
  // flattened from its own 16-byte aligned base
  const bool in_head = row < n_head;
  const uint32_t* __restrict__ slots = in_head ? head : body;
  const int n_slots = (in_head ? n_head : r - n_head) * s;
  const int r0 = (in_head ? row : row - n_head) * s, r1 = r0 + s;  // the row's slots there

  // this thread's SPT slots; those outside the row read as empty
  const int a = (r0 & ~3) + k * TILE + SPT * tid;
  uint32_t sl[SPT];
#pragma unroll
  for (int q = 0; q < SPT; q += 4) {
    if (a + q + 4 <= n_slots) {
      const uint4 v = *reinterpret_cast<const uint4*>(slots + a + q);
      sl[q] = v.x; sl[q + 1] = v.y; sl[q + 2] = v.z; sl[q + 3] = v.w;
    } else {
      for (int i = q; i < q + 4; i++) sl[i] = a + i < n_slots ? slots[a + i] : 0u;
    }
  }
  int own = 0;
#pragma unroll
  for (int i = 0; i < SPT; i++) {
    if (a + i < r0 || a + i >= r1) sl[i] = 0;
    own += (int)(sl[i] >> 27);
  }

  // block-wide exclusive scan of the per-thread length sums
  int x = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int y = lane < PACK_THREADS / 32 ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, d);
      if (lane >= d) y += z;
    }
    if (lane < PACK_THREADS / 32) warp_sums[lane] = y;
  }
  __syncthreads();
  int o = x - own + (wid > 0 ? warp_sums[wid - 1] : 0);
  const int total = warp_sums[PACK_THREADS / 32 - 1];    // the tile's bits

  // the tile's bit-string, from bit 0 of str, zero past its end
  for (int i = tid; i < (total + 31) / 32 + 2; i += PACK_THREADS) str[i] = 0;
  __syncthreads();
  if (own) {
#pragma unroll
    for (int i = 0; i < SPT; i++) {
      const int n = (int)(sl[i] >> 27);
      if (n == 0) continue;
      const uint32_t code = sl[i] & ((1u << 27) - 1) & ((1u << n) - 1);
      const int wi = o >> 5, e = (o & 31) + n;
      if (e <= 32) {
        atomicOr(&str[wi], code << (32 - e));
      } else {                                // straddles two words
        atomicOr(&str[wi], code >> (e - 32));
        atomicOr(&str[wi + 1], code << (64 - e));
      }
      o += n;
    }
  }
  __syncthreads();

  if (wid == 0) {
    // the tile's last min(total, 32) bits, right-justified
    uint32_t tail = 0;
    if (total >= 32) {
      const int b = total - 32;
      tail = __funnelshift_lc(str[(b >> 5) + 1], str[b >> 5], b & 31);
    } else if (total > 0) {
      tail = str[0] >> (32 - total);
    }
    uint32_t off = 0, win = 0;                // the row's bits before the tile: count, last 32
    if (k > 0) {
      if (lane == 0) st[ticket] = status_word(ST_AGG, total, tail);
      // predecessors ticket-1-lane, 32 at a time; before the row's first
      // tile reads as an inclusive prefix of 0 bits
      uint32_t have = 0;                      // bits of the window known so far
      for (int j = ticket - 1 - lane;; j -= 32) {
        unsigned long long sj;
        do {
          sj = j >= ticket - k ? st[j] : ST_INCL;
        } while (!__all_sync(0xffffffffu, (sj & 3) != 0));
        const unsigned incl = __ballot_sync(0xffffffffu, (sj & 3) == ST_INCL);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        const uint32_t val = lane <= stop ? (uint32_t)sj >> 2 : 0u;
        uint32_t sum = val;                   // lengths of this lane and nearer ones
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t y = __shfl_up_sync(0xffffffffu, sum, d);
          if (lane >= d) sum += y;
        }
        const uint32_t at = have + sum - val; // where this tile's bits sit in the window
        win |= __reduce_or_sync(0xffffffffu, lane <= stop && at < 32
                                ? (uint32_t)((sj >> 32) << at) : 0u);
        const uint32_t walked = __shfl_sync(0xffffffffu, sum, 31);
        off += walked;
        if (incl) break;
        have = min(32u, have + walked);
      }
    }
    if (lane == 0) {
      const uint32_t carry = total >= 32 ? tail
                                         : (uint32_t)(((unsigned long long)win << total) | tail);
      st[ticket] = status_word(ST_INCL, off + (uint32_t)total, carry);
      s_off = (int)off;
      s_win = win;
      s_last = atomicAdd(lb.ctl, 1ull << 32) >> 32 == (unsigned)n_tiles - 1;
    }
  }
  __syncthreads();

  // words whose last bit lies in this tile; the row's last tile also
  // writes the final partial word (zero past the row's bits: str is zero
  // past the tile's) and, with fill, the zeros after it up to cap
  const int off = s_off, end = off + total, pre = off & 31, w0 = off >> 5;
  const bool last = k == tiles_per_row - 1;
  const int w1 = min(cap, last ? (end + 31) >> 5 : end >> 5);
  int64_t* out = words + (long long)row * cap;
  for (int w = w0 + tid; w < w1; w += PACK_THREADS) {
    const int j = w - w0;
    out[w] = __funnelshift_lc(str[j], j ? str[j - 1] : s_win, 32 - pre);
  }
  if (last) {
    if (fill)
      for (int w = max(w1, 0) + tid; w < cap; w += PACK_THREADS) out[w] = 0;
    if (tid == 0) bits[row] = ((long long)end + 7) & ~7LL;
  }
  // Every block has read all the status words it needs: the last one
  // clears them and the counter for the next call.  No fence is needed: a
  // thread stores 0 to a status word only after it has read that word's
  // inclusive publish, the tile's last store to it, so by coherence on that
  // one word the 0 lands after every publish to it.  Likewise the counter's
  // reset follows, on the same word and in the same thread, the last
  // block's add, which every other block's adds (tickets and counts)
  // precede.
  if (s_last) {
    for (int i = tid; i < n_tiles; i += PACK_THREADS) {
      while ((st[i] & 3) != ST_INCL) {}
      st[i] = 0;
    }
    if (tid == 0) atomicExch(lb.ctl, 0ull);
  }
}

// The merge's operands.  seq_bits == nullptr is the store mode: out is the
// (frame_cap,) payload; else out is the sequence of out_words words.
struct MergeArgs {
  const int64_t* words;
  const int64_t* bits;
  int64_t* out;
  const int64_t* seq_bits;
  int64_t* seq_bits_out;
  int64_t* frame_bits;
  bool* overflow;
  int r, c, frame_cap;
  long long out_words;
};

__global__ void __launch_bounds__(MERGE_THREADS) merge_rows_kernel(MergeArgs m) {
  extern __shared__ long long start[];       // r + 1: the bits of rows 0 .. i-1
  __shared__ long long warp_sums[MERGE_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if (tid == 0) start[0] = 0;
  long long carry = 0;
  for (int base = 0; base < m.r; base += MERGE_THREADS) {
    const int i = base + tid;
    const long long own = i < m.r ? m.bits[i] : 0;
    long long x = own;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    long long before = carry;
    for (int k = 0; k < MERGE_THREADS / 32; k++) {
      if (k < wid) before += warp_sums[k];
      carry += warp_sums[k];
    }
    if (i < m.r) start[i + 1] = before + x;
    __syncthreads();
  }
  const long long total = carry;             // the frame's bits
  const long long cap_bits = 32LL * m.frame_cap;
  int s = 0;
  long long off = 0, n = m.frame_cap;        // store: every payload word
  if (m.seq_bits != nullptr) {
    const long long sb = *m.seq_bits;
    s = (int)(sb & 31);
    const long long last = m.out_words - m.frame_cap - 1;  // the window's last offset
    off = min(sb >> 5, last);                // append_bitstring's clamp
    n = (min(total + 31, cap_bits) + s + 31) >> 5;      // the words frame bits can reach
  }
  for (long long j = (long long)blockIdx.x * MERGE_THREADS + tid; j < n;
       j += (long long)gridDim.x * MERGE_THREADS) {
    const long long lo = 32 * j - s;         // this word holds frame bits lo .. lo + 31
    int k = -1;                              // the last row that starts before lo + 32
    for (int a = 0, b = m.r - 1; a <= b;) {
      const int mid = (a + b) >> 1;
      if (start[mid] < lo + 32) { k = mid; a = mid + 1; } else { b = mid - 1; }
    }
    uint32_t v = 0;
    for (; k >= 0 && start[k + 1] > lo; k--) {
      const long long q = lo - start[k];     // > -32: the word's first bit in row k
      const int nw = (int)min((start[k + 1] - start[k] + 31) >> 5, (long long)m.c);
      const int w0 = (int)(q >> 5), sh = (int)(q & 31);
      const int64_t* row = m.words + (long long)k * m.c;
      const uint32_t hi = w0 >= 0 && w0 < nw ? (uint32_t)row[w0] : 0u;
      const uint32_t lw = w0 + 1 < nw ? (uint32_t)row[w0 + 1] : 0u;
      v |= __funnelshift_l(lw, hi, sh);
    }
    const long long keep = cap_bits - lo;    // this word's bits before the cut at cap
    if (keep < 32) v = keep > 0 ? v & ~(0xffffffffu >> keep) : 0u;
    if (m.seq_bits == nullptr) {
      m.out[j] = v;
    } else if (v != 0) {
      m.out[off + j] |= v;                   // the sequence's bits before the frame stay
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    *m.frame_bits = total;
    if (m.seq_bits != nullptr) {
      *m.seq_bits_out = *m.seq_bits + total;
      *m.overflow = total > cap_bits;
    }
  }
}

}  // namespace

// The r rows: rows 0 .. n_head - 1 of head (n_head, s), then those of body
// (r - n_head, s), each operand 16-byte aligned.  fill: every row zero from
// its bits up to cap; else each row's words are written up to its last
// partial word and no further.  scratch: the look-back buffer of 16 + 8 *
// capacity bytes, zeroed when allocated and left zeroed by every call
// (ops/kernels/pack.py)
extern "C" int mpeg2_pack_slots(const void* head, const void* body, void* words,
                                void* bits, void* scratch, int n_head, int r, int s,
                                int cap, int fill, int capacity, void* stream) {
  const int tiles_per_row = (s + 3 + TILE - 1) / TILE;
  const int n_tiles = r * tiles_per_row;
  if (n_tiles == 0) return 0;
  if (n_tiles > capacity || n_head < 0 || n_head > r ||
      (long long)std::max(n_head, r - n_head) * s > (1LL << 31) - TILE)
    return (int)cudaErrorInvalidValue;
  const LookBack lb{(unsigned long long*)scratch, (unsigned long long*)scratch + 2};
  pack_slots_kernel<<<n_tiles, PACK_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)head, (const uint32_t*)body, (int64_t*)words, (int64_t*)bits, lb,
      n_head, r, s, cap, tiles_per_row, n_tiles, fill != 0);
  return (int)cudaGetLastError();
}

// merge_rows (seq_bits null: the (cap,) payload, every word written) or
// merge_append (out the sequence of out_words words, ORed into from word
// seq_bits >> 5; seq_bits_out and overflow written); frame_bits gets the
// frame's bit count either way
extern "C" int mpeg2_merge_rows(const void* words, const void* bits, void* out,
                                const void* seq_bits, void* seq_bits_out,
                                void* frame_bits, void* overflow, int r, int c,
                                int frame_cap, long long out_words, void* stream) {
  if (r < 0 || r > MERGE_MAX_ROWS || frame_cap < 0 || frame_cap >= (1 << 26) ||
      (seq_bits != nullptr && out_words < (long long)frame_cap + 1))
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int words_max = frame_cap + (seq_bits != nullptr);
  const int blocks = std::max(1, std::min((words_max + MERGE_THREADS - 1) / MERGE_THREADS,
                                          MERGE_BLOCKS_PER_SM * sms));
  const MergeArgs m{(const int64_t*)words, (const int64_t*)bits, (int64_t*)out,
                    (const int64_t*)seq_bits, (int64_t*)seq_bits_out,
                    (int64_t*)frame_bits, (bool*)overflow, r, c, frame_cap, out_words};
  merge_rows_kernel<<<blocks, MERGE_THREADS, (r + 1) * sizeof(long long),
                      (cudaStream_t)stream>>>(m);
  return (int)cudaGetLastError();
}
