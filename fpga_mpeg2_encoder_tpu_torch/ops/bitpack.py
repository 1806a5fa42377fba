"""Parallel variable-length bit packing by prefix sum: the plain PyTorch
versions of the pack and merge kernels (ops/kernels/pack.py) and of
pack_symbols, plus the per-frame sequence append (merge_append, the merge
kernel's append mode, is merge_rows then append_bitstring), its batched
form append_bitstrings_batched, and concat_bitstrings.

A bit-string is a row of 32-bit words, MSB first, left-justified and
zero-filled beyond its length (so OR is concatenation), held as int64 values
in [0, 2**32): torch on the CPU has no uint32 shifts.  Slots are int32
holding the uint32 pattern ``code | len << 27``; they are read through
entropy.slot_u32, widened and masked to 32 bits before any shift.  Packing
is the GPU idiom: an exclusive prefix sum of the symbol lengths gives every
symbol its bit offset, and each symbol (<= 25 bits) lands in one or two
words.  Symbols never share bits, so summing their word contributions
equals OR-ing them.
Lengths are byte-aligned per row (the stage-V rule, RTL:2940-2943).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .entropy import SLOT_CODE_MASK, SLOT_LEN_SHIFT, slot_u32

_MASK32 = 0xFFFFFFFF


def align_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Round bit-lengths up to a byte boundary (zero padding is already present)."""
    return (bits + 7) & ~7


def _scatter_bits(rows: int, cap_words: int, val: torch.Tensor,
                  nbits: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Place each right-justified ``val`` of ``nbits`` (<= 32) bits at bit
    offset ``off`` of its row of a zero (rows, cap_words) word array, MSB
    first.  val, nbits, off: (rows, N).  Bits past cap_words words are dropped."""
    out = torch.zeros(rows * cap_words, dtype=torch.int64, device=val.device)
    base = (torch.arange(rows, device=val.device) * cap_words)[:, None]
    word = off >> 5
    end = (off & 31) + nbits                          # <= 63
    hi = torch.where(end <= 32, val << (32 - end).clamp(min=0),
                     val >> (end - 32).clamp(min=0))
    lo = torch.where(end > 32, (val << (64 - end).clamp(max=31)) & _MASK32, 0)
    keep = (nbits > 0) & (word < cap_words)
    out.index_add_(0, (base + word)[keep], hi[keep])
    keep = (end > 32) & (word + 1 < cap_words)
    out.index_add_(0, (base + word + 1)[keep], lo[keep])
    return out.reshape(rows, cap_words)


def pack_slots(slots: torch.Tensor, cap_words: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the pack kernel.  slots (R, S) int32 ``code | len << 27``
    (the uint32 pattern) -> (words (R, cap_words) int64, bits (R,) int64
    byte-aligned, overflow () bool).  Each code is masked to its length, so
    a zero-length slot emits nothing whatever code it carries.  Content past
    cap_words words is dropped; overflow is set iff some row's bits exceed
    32 * cap_words."""
    slots = slot_u32(slots)
    lens = slots >> SLOT_LEN_SHIFT
    codes = slots & SLOT_CODE_MASK & ((torch.ones_like(lens) << lens) - 1)
    ends = lens.cumsum(dim=1)
    words = _scatter_bits(slots.shape[0], cap_words, codes, lens, ends - lens)
    bits = align_bytes(ends[:, -1])
    return words, bits, (bits > 32 * cap_words).any()


def symbol_slots(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(code, len) symbols -> int32 slots ``code | len << 27``, formed in int32:
    its shift wraps to the uint32 pattern."""
    return codes.to(torch.int32) | (lens.to(torch.int32) << SLOT_LEN_SHIFT)


def pack_symbols(codes: torch.Tensor, lens: torch.Tensor, cap_words: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack rows of (code, len) symbols, (R, S) codes < 2**len and len <= 24:
    as pack_slots on their slots."""
    return pack_slots(symbol_slots(codes, lens), cap_words)


def merge_rows(words: torch.Tensor, bits: torch.Tensor, cap_words: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the merge kernel: concatenate R byte-aligned rows
    (R, C) int64 with bit counts (R,) into one payload (cap_words,) int64;
    returns (payload, total bits).  Rows must be zero past their bit count, as
    pack_slots leaves them; content past cap_words words is dropped."""
    c = words.shape[1]
    bits = bits.to(torch.int64)
    start = bits.cumsum(0) - bits                               # (R,)
    k = torch.arange(c, device=words.device)
    nbits = torch.where(32 * k < bits[:, None], 32, 0)          # (R, C)
    payload = _scatter_bits(1, cap_words, words.to(torch.int64).reshape(1, -1),
                            nbits.reshape(1, -1),
                            (start[:, None] + 32 * k).reshape(1, -1))
    return payload[0], bits.sum()


def _shift_right(b: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Shift the bit-strings b (..., C) right by nbits (...,) bits each,
    within their C words: bits shifted past the last word are dropped."""
    c = b.shape[-1]
    s = (nbits & 31)[..., None]
    k = torch.arange(c, device=b.device) - (nbits >> 5)[..., None]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    cur = torch.where(k >= 0, b.gather(-1, k.clamp(min=0)), zero)
    prev = torch.where(k >= 1, b.gather(-1, (k - 1).clamp(min=0)), zero)
    return torch.where(s > 0, (cur >> s) | ((prev << (32 - s)) & _MASK32), cur)


def concat_bitstrings(a: torch.Tensor, bl_a: torch.Tensor, b: torch.Tensor,
                      bl_b: torch.Tensor, out_words: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate left-justified bit-strings: (..., Ca) of bl_a bits and
    (..., Cb) of bl_b bits -> ((..., out_words), bl_a + bl_b), for
    bl_a <= 32 * Ca.  Content beyond out_words words is dropped (callers
    size for the worst case or detect overflow from the returned lengths)."""
    def fit(x):
        n = x.shape[-1]
        if n >= out_words:
            return x[..., :out_words]
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (out_words - n,))], dim=-1)
    bl_a = bl_a.to(torch.int64)
    return fit(a) | _shift_right(fit(b), bl_a), bl_a + bl_b


def check_append_window(seq_words: int, c: int) -> None:
    """Raise unless an accumulator of seq_words words can take a window of
    c + 1 words (append_bitstring's sizing contract)."""
    if c + 1 > seq_words:
        raise ValueError(
            f"append_bitstring accumulator ({seq_words} words) must "
            f"exceed the appended width + 1 ({c} + 1); allocate "
            f"seq_cap + C + 1 words (see sizing contract)")


def append_bitstring(seq: torch.Tensor, seq_bits: torch.Tensor,
                     b: torch.Tensor, b_bits: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append a left-justified bit-string b (C words) to a left-justified
    accumulator seq (cap words), in place: funnel-shift b by (seq_bits & 31)
    and OR it in at word offset seq_bits >> 5.  Touches only C+1 words, and
    reads the offset on the device (no host round trip).

    SIZING CONTRACT: the accumulator must be at least C+1 words LARGER than
    the logical capacity checked for overflow, i.e. allocate
    ``seq_cap + C + 1`` words and check ``seq_bits > 32 * seq_cap``.  The
    C+1-word window can then sit at any in-range offset; only a genuinely
    overflowing append (off > seq_cap words, which the check flags) is
    clamped to the buffer's end and corrupts the (discarded) content.
    Without the margin the clamp bites BELOW the overflow threshold - in the
    worst case (C + 1 == buffer width) every append lands at word 0 and the
    corruption is silent - so undersized accumulators are rejected."""
    append_bitstrings_batched(seq[None], seq_bits.reshape(1), b[None], b_bits.reshape(1))
    return seq, seq_bits + b_bits


def merge_append(seq: torch.Tensor, seq_bits: torch.Tensor, words: torch.Tensor,
                 bits: torch.Tensor, frame_cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the merge kernel's append mode: merge_rows(words,
    bits, frame_cap) appended to seq by append_bitstring, in place.  Returns
    (seq, the new seq_bits, the frame's bits, its overflow flag: bits beyond
    32 * frame_cap, which the payload dropped)."""
    payload, fbits = merge_rows(words, bits, frame_cap)
    seq, seq_bits = append_bitstring(seq, seq_bits, payload, fbits)
    return seq, seq_bits, fbits, fbits > 32 * frame_cap


def append_bitstrings_batched(seq: torch.Tensor, seq_bits: torch.Tensor,
                              b: torch.Tensor, b_bits: torch.Tensor,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """append_bitstring for B independent streams, in place: seq (B, N),
    seq_bits (B,), b (B, C), b_bits (B,) -> (seq, seq_bits + b_bits).  Each
    stream's C + 1 word window sits at its own offset, clamped; the same
    sizing contract holds (allocate seq_cap + C + 1 words a stream, check
    seq_bits > 32 * seq_cap).  append_bitstring is this with B = 1."""
    nb, n = seq.shape
    c = b.shape[-1]
    check_append_window(n, c)
    s = (seq_bits & 31)[:, None]
    zero = torch.zeros((nb, 1), dtype=torch.int64, device=b.device)
    bpad = torch.cat([b, zero], dim=1)
    prev = torch.cat([zero, b], dim=1)
    sh = torch.where(s > 0, (bpad >> s) | ((prev << (32 - s)) & _MASK32), bpad)
    off = (seq_bits >> 5).clamp(max=n - c - 1)
    idx = off[:, None] + torch.arange(c + 1, device=seq.device)
    seq.scatter_(1, idx, seq.gather(1, idx) | sh)
    return seq, seq_bits + b_bits
