"""MPEG-2 elementary-stream bit templates and the reference bit writer.

The header templates reproduce, chunk for chunk, the emission FSM of the reference
entropy back-end (RTL/mpeg2encoder.v:2589-2715).  Every chunk is ``(value, nbits)``
emitted MSB-first; chunks marked "aligned" are preceded by zero-padding of the pending
bitstream to a byte boundary (RTL/mpeg2encoder.v:2940-2943).

Fixed stream parameters baked into the templates (decoded meaning, for reference):
  aspect_ratio=1 (square), frame_rate_code=2 (24 fps), bit_rate=4 Mbps, MP@HL,
  chroma 4:2:0, all f_codes=1, intra_dc_precision=10 bit, frame_pred_frame_dct=1.
"""
from __future__ import annotations

from typing import List, Tuple

Chunk = Tuple[int, int]   # (value, nbits), value occupies the low nbits, emitted MSB-first


def sequence_header_chunks(size_x: int, size_y: int) -> List[Chunk]:
    """Sequence header + sequence extension + display extension.

    Mirrors PUT_ENDED/PUT_SEQ_HEADER2 (RTL/mpeg2encoder.v:2598-2617): 152 + 117 bits.
    """
    return [
        (0x000001, 24), (0xB3, 8),
        ((size_x << 12) | size_y, 24),
        (0x1209C4, 24),              # aspect=1, frame_rate=24fps, bit_rate 4Mbps (hi)
        (0x200000, 24),              # bit_rate (lo), marker, vbv_buffer_size
        (0x0001B5, 24), (0x144200, 24),   # sequence extension (MP@HL, progressive)
        (0x010000, 24),              # sequence extension tail
        (0x000001, 24), (0xB52305, 24),   # sequence display extension
        (0x0505, 16),
        (size_x, 14), (1, 1), (size_y, 14),
    ]


def gop_header_chunks(hour: int, minute: int, second: int, insec: int) -> List[Chunk]:
    """GOP header, 59 bits (RTL/mpeg2encoder.v:2650-2656).  closed_gop=1, broken_link=0."""
    return [
        (0x000001, 24), (0xB8, 8),
        (hour, 6), (minute, 6), ((1 << 6) | second, 7), (insec, 6), (0x2, 2),
    ]


def picture_header_chunks(i_frame: int) -> List[Chunk]:
    """Picture header + picture coding extension (RTL/mpeg2encoder.v:2670-2682).

    136 bits for an I-frame, 144 for a P-frame; i_frame is the temporal reference
    (frame index within the GOP, 0 => I-frame).
    """
    chunks: List[Chunk] = [
        (0x000001, 24),
        (i_frame, 18),               # 8 bits of start code 0x00 + temporal_reference(10)
    ]
    if i_frame == 0:
        chunks += [(0x10000, 19), (0x0, 3)]      # I, vbv_delay=0, pad to byte
    else:
        chunks += [(0x20000, 19), (0x380, 11)]   # P, full_pel=0, f_code=111, pad
    chunks += [(0x000001, 24), (0xB58111, 24), (0x1BC000, 24)]   # coding extension
    return chunks


def slice_header_chunks(y16: int, q_level: int) -> List[Chunk]:
    """Slice header, 38 bits (RTL/mpeg2encoder.v:2708-2710)."""
    return [(0x000001, 24), (1 + y16, 8), (2 << q_level, 6)]


SEQUENCE_END_CHUNKS: List[Chunk] = [(0x000001, 24), (0xB7, 8)]


class BitWriter:
    """MSB-first bit accumulator reproducing the stage-U/V packer semantics.

    The reference packer (RTL/mpeg2encoder.v:2879-2956) byte-aligns *before* an aligned
    chunk and, at end of sequence, flushes the residue zero-padded so the stream length
    is the next multiple of 32 bytes (one extra zero word if already on a boundary).
    """

    __slots__ = ("_buf", "_acc", "_nacc")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0          # pending bits, left-justified semantics via count
        self._nacc = 0         # number of pending bits (< 8 after _drain)

    def put(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nacc += nbits
        while self._nacc >= 8:
            self._nacc -= 8
            self._buf.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def put_chunks(self, chunks: List[Chunk], align: bool = True) -> None:
        if align:
            self.align()
        for v, n in chunks:
            self.put(v, n)

    def align(self) -> None:
        """Zero-pad to a byte boundary (RTL/mpeg2encoder.v:2940-2943)."""
        if self._nacc:
            self.put(0, 8 - self._nacc)

    @property
    def bit_length(self) -> int:
        return len(self._buf) * 8 + self._nacc

    def finish_sequence(self) -> bytes:
        """End-of-sequence flush: byte-align then pad with zero bytes so the total
        length is ``(nbits // 256 + 1) * 32`` bytes - the reference always emits one
        final (possibly all-padding) 32-byte word (RTL/mpeg2encoder.v:2932-2937)."""
        self.align()
        nbits = len(self._buf) * 8
        target = (nbits // 256 + 1) * 32
        self._buf.extend(b"\x00" * (target - len(self._buf)))
        out = bytes(self._buf)
        self._buf = bytearray()
        return out

    def to_bytes_aligned(self) -> bytes:
        """Current content, byte-aligned, without end-of-sequence padding."""
        self.align()
        return bytes(self._buf)


def sequence_start(width: int, height: int) -> bytes:
    """The bytes that start a sequence: its header and extensions,
    byte-aligned."""
    bw = BitWriter()
    bw.put_chunks(sequence_header_chunks(width, height))
    return bw.to_bytes_aligned()


def sequence_end(length: int) -> bytes:
    """The bytes that close a sequence of ``length`` bytes so far: the end
    code, then zero bytes up to the next multiple of 32, 32 of them where the
    end code ends on one (``BitWriter.finish_sequence``)."""
    bw = BitWriter()
    bw.put_chunks(SEQUENCE_END_CHUNKS)
    end = bw.to_bytes_aligned()
    n = length + len(end)
    return end + bytes((n // 32 + 1) * 32 - n)
