"""Bit packing kernels (csrc/pack.cu).

pack_slots replaces ops/pallas/pack.py::pack_slots_pallas and merge_rows
replaces ops/pallas/pack.py::merge_rows_pallas of the JAX package;
pack_symbols replaces pack_symbols_pallas, which on the TPU as here forms the
slots and calls the pack kernel, and launches nothing of its own.
merge_append is merge_rows followed by bitpack.append_bitstring, the frame
loop's per-frame append, in one launch of the same merge kernel.  pack_rows
is the compiled gop program's pack_slots: the header rows and the slice rows
as two operands (no copy of them into one grid), rows defined only up to
their last partial word (no zeros written up to the cap) and no overflow
flag (the program's carry kernel tests the row bits itself).

pack_slots is bound by reading the slots (at 1920x1152: 3.5 M int32 slots,
14 MB) and writing the words.  Each row is cut into tiles of 4096 slots, one
block of 512 threads each (888 blocks at 1920x1152): 8 slots a thread in
two 16-byte loads held in registers, a block scan and the tile's bit-string
in shared memory, and the tile's offset in its row from a single-pass
chained scan (decoupled look-back), warp 0 reading 32 predecessors' status
words at once.  Each output word is written once by a plain store; a row's
last tile writes its last partial word and, for pack_slots alone, the zeros
after it up to the cap (at 1920x1152 and the bounds' caps 20.6 MB, more
than the 14 MB of slots read).  The look-back's state lives in a buffer per
device and stream, zeroed when it is allocated; the kernel's last block
leaves it zeroed for the next call.  A buffer is never freed: a CUDA graph captured
with it holds its address (runtime/graphs.py), so a call that needs more
tiles gets a larger buffer and the old one is kept.  The merge kernel gives each output word one
thread, in a fixed grid of two blocks per SM: every block scans the row
lengths, and a thread finds the rows under its word by a binary search and
funnel-shifts at most two words of each.  merge_rows stores every word of
its (cap,) payload; merge_append ORs only the words under the frame's bits
into the sequence buffer at the offset it reads on the device, and writes
the new bit count to a tensor of its own: no memset, no atomics, no frame
buffer and no host round trip.
On CPU tensors the plain versions in ops/bitpack.py run instead.

Unlike the JAX package there is no statistical level budget: a row overflows
exactly when its bits exceed 32 * cap_words.  Outputs that do not overflow
are identical to the JAX package's; overflow flags are never compared across
backends.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .. import bitpack
from . import _build

TILE = 4096                  # slots per pack_slots block (csrc/pack.cu TILE)

# (device, stream) -> the look-back buffer of pack_slots as int64: the
# counter and a spare word, then one status word per tile, `capacity` of them
_lookback: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# the buffers that larger ones replaced, kept for the graphs that hold them
_retired: List[torch.Tensor] = []


def _lookback_buffer(device: torch.device, tiles: int) -> Tuple[torch.Tensor, int]:
    """The look-back buffer for a call of ``tiles`` tiles on the current
    stream of ``device``, and its capacity in tiles.  A new buffer is zeroed;
    the kernel leaves it zeroed for the next call on the same stream.  One
    that is too small is replaced by one at least twice its capacity and
    kept in ``_retired``, never freed: a graph captured with it replays with
    its address."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _lookback.get(key)
    if buf is None or buf.numel() - 2 < tiles:
        grown = 0
        if buf is not None:
            _retired.append(buf)
            grown = 2 * (buf.numel() - 2)
        buf = torch.zeros(2 + max(tiles, 1024, grown), dtype=torch.int64, device=device)
        _lookback[key] = buf
    return buf, buf.numel() - 2


def _launch(head: Optional[torch.Tensor], body: torch.Tensor, cap_words: int,
            fill: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the pack kernel over the rows of ``head`` (none without
    it), then those of ``body``: (words, bits)."""
    rb, s = body.shape
    _build.check(body, "slots", torch.int32, (rb, s), align=16)
    rh = 0
    if head is not None:
        rh = head.shape[0]
        _build.check(head, "header rows", torch.int32, (rh, s), align=16)
    r, dev = rh + rb, body.device
    words = torch.empty((r, cap_words), dtype=torch.int64, device=dev)
    bits = torch.empty((r,), dtype=torch.int64, device=dev)
    buf, capacity = _lookback_buffer(dev, r * ((s + 3 + TILE - 1) // TILE))
    _build.launch("mpeg2_pack_slots", "pack_slots", dev, body if head is None else head,
                  body, words, bits, buf, rh, r, s, cap_words, int(fill), capacity)
    return words, bits


def pack_slots(slots: torch.Tensor, cap_words: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """slots (R, S) int32 (the uint32 pattern) -> (words (R, cap_words) int64,
    each row zero from its bits up to cap_words, bits (R,) int64
    byte-aligned, overflow () bool); see bitpack.pack_slots.  The slots'
    data must be 16-byte aligned (the kernel's vector loads)."""
    if _build.on_cpu(slots):
        return bitpack.pack_slots(slots, cap_words)
    words, bits = _launch(None, slots, cap_words, fill=True)
    return words, bits, (bits > 32 * cap_words).any()


def pack_rows(head: torch.Tensor, slots: torch.Tensor, cap_words: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of ``head`` (H, S) then those of ``slots`` (R, S), both int32
    and 16-byte aligned, packed as pack_slots packs them stacked, in one
    launch and no other operation: (words (H + R, cap_words), bits).  On a
    card a row's words are defined only up to its last partial word (zero
    past the row's bits within it, as merge_rows and merge_append read
    them); the words after it keep what the buffer held.  No overflow
    flag: a row overflows where its bits exceed 32 * cap_words, which the
    compiled gop program's carry kernel tests."""
    if _build.on_cpu(head, slots):
        return bitpack.pack_slots(torch.cat([head, slots]), cap_words)[:2]
    return _launch(head, slots, cap_words, fill=False)


def pack_symbols(codes: torch.Tensor, lens: torch.Tensor, cap_words: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, S) codes < 2**len and lens <= 24 -> as pack_slots, through the
    pack_slots kernel; see bitpack.pack_symbols."""
    if _build.on_cpu(codes, lens):
        return bitpack.pack_symbols(codes, lens, cap_words)
    return pack_slots(bitpack.symbol_slots(codes, lens), cap_words)


def _merge_checks(words: torch.Tensor, bits: torch.Tensor):
    """Check the rows' operands; the kernel refuses more than 4096 rows or a
    cap of 2**26 words or more (a launch error)."""
    r, c = words.shape
    _build.check(words, "words", torch.int64, (r, c))
    _build.check(bits, "bits", torch.int64, (r,))
    return r, c


def merge_rows(words: torch.Tensor, bits: torch.Tensor, cap_words: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """words (R, C) int64, bits (R,) int64 byte-aligned -> (payload
    (cap_words,) int64, total bits); see bitpack.merge_rows."""
    if _build.on_cpu(words, bits):
        return bitpack.merge_rows(words, bits, cap_words)
    r, c = _merge_checks(words, bits)
    out = torch.empty((cap_words,), dtype=torch.int64, device=words.device)
    total = torch.empty((), dtype=torch.int64, device=words.device)
    _build.launch("mpeg2_merge_rows", "merge_rows", words.device, words, bits, out,
                  None, None, total, None, r, c, cap_words, cap_words)
    return out, total


def merge_append(seq: torch.Tensor, seq_bits: torch.Tensor, words: torch.Tensor,
                 bits: torch.Tensor, frame_cap: int, new_bits: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """merge_rows(words, bits, frame_cap) appended to the sequence buffer seq
    (N,) int64 at seq_bits () int64, in place, with append_bitstring's
    sizing contract and clamp -> (seq, new seq_bits, frame bits, overflow
    () bool: frame bits beyond 32 * frame_cap); see bitpack.merge_append.
    The new seq_bits is written to ``new_bits`` () int64 where the caller
    gives one (a buffer of its own, such as a CUDA graph's carry; not
    seq_bits, which every block of the kernel reads), else to a new tensor."""
    if new_bits is not None:
        _build.check(new_bits, "new_bits", torch.int64, ())
        if new_bits.data_ptr() == seq_bits.data_ptr():
            raise ValueError("new_bits must not be seq_bits: the kernel reads seq_bits "
                             "in every block")
    if _build.on_cpu(seq, seq_bits, words, bits, *(() if new_bits is None else (new_bits,))):
        seq, nb, fbits, ovf = bitpack.merge_append(seq, seq_bits, words, bits, frame_cap)
        return seq, nb if new_bits is None else new_bits.copy_(nb), fbits, ovf
    r, c = _merge_checks(words, bits)
    _build.check(seq, "seq", torch.int64, (seq.numel(),))
    _build.check(seq_bits, "seq_bits", torch.int64, ())
    bitpack.check_append_window(seq.numel(), frame_cap)
    dev = words.device
    if new_bits is None:
        new_bits = torch.empty((), dtype=torch.int64, device=dev)
    fbits = torch.empty((), dtype=torch.int64, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    _build.launch("mpeg2_merge_rows", "merge_rows", dev, words, bits, seq, seq_bits,
                  new_bits, fbits, ovf, r, c, frame_cap, seq.numel())
    return seq, new_bits, fbits, ovf
