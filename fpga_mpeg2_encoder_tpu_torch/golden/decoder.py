"""Minimal MPEG-2 elementary-stream decoder for verification.

Decodes the stream family this framework produces (MP@HL frame pictures,
frame_pred_frame_dct=1, f_code=1, intra_dc_precision=10, no skipped macroblocks,
default quantiser matrices) and reconstructs frames with the same fixed-point
dequant + Chen-Wang IDCT as the encoder's reconstruction loop, so the decoded frames
must equal the encoder's recon buffers bit-for-bit (MPEG-2 closed-loop property).

The reference has no decoder; its verification relies on external players
(README.md:350-353).  This module is the framework-native replacement so the test
suite needs no ffmpeg/VLC.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import EncoderConfig
from ..core import tables as T
from .encoder import dequantize, idct, predict_block, add_clip, MacroblockDecision


def _prefix_dict(bits: np.ndarray, lens: np.ndarray, skip_zero_len: bool = True
                 ) -> Dict[Tuple[int, int], int]:
    d: Dict[Tuple[int, int], int] = {}
    for i, (b, l) in enumerate(zip(bits.tolist(), lens.tolist())):
        if l == 0 and skip_zero_len:
            continue
        d[(int(l), int(b))] = i
    return d


_DC_Y = _prefix_dict(T.BITS_DC_Y, T.LENS_DC_Y, skip_zero_len=False)
_DC_UV = _prefix_dict(T.BITS_DC_UV, T.LENS_DC_UV, skip_zero_len=False)
_MV = {}
for _i in range(17):
    _MV.setdefault((int(T.LENS_MOTION_VECTOR[_i]), int(T.BITS_MOTION_VECTOR[_i])), _i)
_CBP = _prefix_dict(T.BITS_NZ_FLAGS, T.LENS_NZ_FLAGS)
_AC: Dict[Tuple[int, int], Tuple[int, int]] = {}
for _r in range(32):
    for _a in range(41):
        if T.AC_VALID[_r, _a]:
            _AC[(int(T.AC_LEN[_r, _a]), int(T.AC_CODE[_r, _a]))] = (_r, _a + 1)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                      # bit position

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def peek(self, n: int) -> int:
        p = self.pos
        v = self.read(n)
        self.pos = p
        return v

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def at_start_code(self) -> bool:
        if self.pos & 7:
            return False
        b = self.pos >> 3
        return self.data[b:b + 3] == b"\x00\x00\x01"

    def next_start_code(self) -> int:
        """Align and skip zero-stuffing to the next 00 00 01 xx; return xx."""
        self.align()
        while not self.at_start_code():
            if self.read(8) != 0:
                raise ValueError(f"nonzero stuffing before start code @bit {self.pos}")
        self.read(24)
        return self.read(8)

    def decode_prefix(self, table: Dict[Tuple[int, int], int], max_len: int):
        for l in range(1, max_len + 1):
            v = self.peek(l)
            hit = table.get((l, v))
            if hit is not None:
                self.read(l)
                return hit
        raise ValueError(f"prefix decode failed @bit {self.pos}")


@dataclasses.dataclass
class DecodedPicture:
    coding_type: int           # 1=I, 2=P
    temporal_reference: int
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray


@dataclasses.dataclass
class DecodedSequence:
    width: int
    height: int
    q_level: int
    pictures: List[DecodedPicture]


def _decode_ac_run_level(br: BitReader, first: bool, intra: bool) -> Optional[Tuple[int, int]]:
    """One B.14 event; None = EOB."""
    if br.peek(2) == 0b10 and not (first and not intra):
        br.read(2)
        return None
    if first and not intra and br.peek(1) == 1:
        br.read(1)
        sign = br.read(1)
        return 0, -1 if sign else 1
    if br.peek(6) == 1:                    # escape
        br.read(6)
        run = br.read(6)
        lvl = br.read(12)
        if lvl >= 2048:
            lvl -= 4096
        return run, lvl
    for l in range(2, 17):
        v = br.peek(l)
        hit = _AC.get((l, v))
        if hit is not None:
            br.read(l)
            sign = br.read(1)
            run, absv = hit
            return run, -absv if sign else absv
    raise ValueError(f"AC decode failed @bit {br.pos}")


def decode_sequence(data: bytes, enc_cfg: Optional[EncoderConfig] = None) -> DecodedSequence:
    if enc_cfg is None:
        enc_cfg = EncoderConfig()
    br = BitReader(data)

    code = br.next_start_code()
    if code != 0xB3:
        raise ValueError(f"expected sequence header, got {code:02x}")
    width = br.read(12)
    height = br.read(12)
    br.read(4)                             # aspect
    frame_rate = br.read(4)
    br.read(18)                            # bit_rate
    br.read(1)                             # marker
    br.read(10)                            # vbv_buffer_size
    br.read(3)                             # constrained + load matrices (must be 0)
    assert frame_rate == 2

    pictures: List[DecodedPicture] = []
    q_level = None
    prev: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    cur: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    cur_type = 0
    cur_tref = 0
    nbx, nby = width // 16, height // 16

    def close_picture():
        nonlocal cur
        if cur is not None:
            pictures.append(DecodedPicture(cur_type, cur_tref, *cur))
        cur = None

    while True:
        code = br.next_start_code()
        if code == 0xB7:                   # sequence end
            close_picture()
            break
        if code in (0xB8,):                # GOP header: consume fixed fields
            br.read(27)
            continue
        if code == 0xB5:                   # extension: skip to next start code
            while not br.at_start_code():
                if br.pos & 7:
                    br.align()
                else:
                    br.read(8)
            continue
        if code == 0x00:                   # picture header
            close_picture()
            cur_tref = br.read(10)
            cur_type = br.read(3)
            br.read(16)                    # vbv_delay
            if cur_type == 2:
                br.read(1)                 # full_pel_forward_vector
                br.read(3)                 # forward_f_code (legacy 111)
            prev_for_pred = pictures[-1] if pictures else None
            if cur_type == 2 and prev_for_pred is None:
                raise ValueError("P-picture without reference")
            cur = (np.zeros((height, width), np.uint8),
                   np.zeros((height // 2, width // 2), np.uint8),
                   np.zeros((height // 2, width // 2), np.uint8))
            continue
        if 0x01 <= code <= 0xAF:           # slice
            y16 = code - 1
            qsc = br.read(5)
            q_level = {2: 1, 4: 2, 8: 3, 16: 4}[qsc]
            br.read(1)                     # extra_bit_slice
            if pictures:
                p = pictures[-1]
                prev = (p.y, p.u, p.v)
            yr, ur = enc_cfg.yr, enc_cfg.ur
            if prev is not None:
                py = np.pad(prev[0], yr + 1)
                pu = np.pad(prev[1], ur + 1)
                pv = np.pad(prev[2], ur + 1)
            else:
                py = np.zeros((height + 2 * yr + 2, width + 2 * yr + 2), np.uint8)
                pu = np.zeros((height // 2 + 2 * ur + 2, width // 2 + 2 * ur + 2), np.uint8)
                pv = pu
            prev_mvx = prev_mvy = 0
            prev_dc = [0, 0, 0]
            for bx in range(nbx):
                inc = br.read(1)
                if inc != 1:
                    raise ValueError(f"macroblock_address_increment != 1 @bit {br.pos}")
                if cur_type == 1:
                    t = br.read(1)
                    if t != 1:
                        raise ValueError("bad I macroblock type")
                    intra, coded, mc = True, True, False
                else:
                    if br.peek(1) == 1:
                        br.read(1)
                        intra, coded, mc = False, True, True
                    elif br.peek(3) == 0b001:
                        br.read(3)
                        intra, coded, mc = False, False, True
                    elif br.peek(5) == 0b00011:
                        br.read(5)
                        intra, coded, mc = True, True, False
                    else:
                        raise ValueError(f"bad P macroblock type @bit {br.pos}")
                mvx = mvy = 0
                if mc:
                    for comp in ("x", "y"):
                        a = br.decode_prefix(_MV, 10)
                        if a != 0:
                            s = br.read(1)
                            d = -a if s else a
                        else:
                            d = 0
                        m = (prev_mvx if comp == "x" else prev_mvy) + d
                        if m > 15:
                            m -= 32
                        elif m < -16:
                            m += 32
                        if comp == "x":
                            mvx = prev_mvx = m
                        else:
                            mvy = prev_mvy = m
                if intra:
                    prev_mvx = prev_mvy = 0
                cbp = 0b111111 if intra else 0
                if not intra and coded:
                    cbp = br.decode_prefix(_CBP, 9)
                dec = MacroblockDecision(not intra, mvx, mvy)
                ypred, upred, vpred = predict_block(enc_cfg, dec, py, pu, pv, y16, bx)
                preds = [ypred[0:8, 0:8], ypred[0:8, 8:16], ypred[8:16, 0:8],
                         ypred[8:16, 8:16], upred, vpred]
                for t in range(6):
                    comp = 0 if t < 4 else (1 if t == 4 else 2)
                    q = np.zeros(64, np.int32)
                    if intra:
                        size = br.decode_prefix(_DC_Y if t < 4 else _DC_UV, 10)
                        if size:
                            raw = br.read(size)
                            diff = raw if raw >> (size - 1) else raw - ((1 << size) - 1)
                        else:
                            diff = 0
                        dc = prev_dc[comp] + diff
                        prev_dc[comp] = dc
                        q[0] = dc
                        pos = 1
                        while True:
                            ev = _decode_ac_run_level(br, first=False, intra=True)
                            if ev is None:
                                break
                            run, lvl = ev
                            pos += run
                            q[pos] = lvl
                            pos += 1
                    else:
                        prev_dc[comp] = 0
                        if (cbp >> (5 - t)) & 1:
                            pos = 0
                            first = True
                            while True:
                                ev = _decode_ac_run_level(br, first=first, intra=False)
                                if ev is None:
                                    break
                                run, lvl = ev
                                pos += run
                                q[pos] = lvl
                                pos += 1
                                first = False
                    coeff = q[T.ZIGZAG_FLAT].reshape(8, 8)     # zig -> raster
                    resid = idct(dequantize(coeff, not intra, q_level))
                    rec = add_clip(preds[t], resid)
                    if t < 4:
                        ry, rx = y16 * 16 + (t // 2) * 8, bx * 16 + (t % 2) * 8
                        cur[0][ry:ry + 8, rx:rx + 8] = rec
                    elif t == 4:
                        cur[1][y16 * 8:y16 * 8 + 8, bx * 8:bx * 8 + 8] = rec
                    else:
                        cur[2][y16 * 8:y16 * 8 + 8, bx * 8:bx * 8 + 8] = rec
            continue
        raise ValueError(f"unexpected start code {code:02x}")

    return DecodedSequence(width, height, q_level or 0, pictures)
