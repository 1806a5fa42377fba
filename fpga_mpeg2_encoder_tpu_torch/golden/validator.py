"""Independent ISO/IEC 13818-2 stream validator and reference decoder.

This module is the verification path that does NOT share reconstruction code
with the encoder: it imports nothing from ``golden.encoder`` or
``golden.decoder``.  Its arithmetic (prediction, inverse quantisation,
mismatch control, IDCT) is written directly from the ISO 13818-2 decoding
formulas - floating-point separable IDCT, ISO saturation to [-2048, 2047],
ISO mismatch control (7.4.4) - rather than the reference RTL's fixed-point
pipeline.  A bug shared by the encoder and the in-repo conformance decoder
(golden/decoder.py reuses the encoder's dequant/IDCT/prediction by design)
therefore cannot pass silently here: it would surface either as a syntax
violation or as a reconstruction divergence.

What it checks, field by field (ValidationError on any miss):
* sequence header: sizes, aspect_ratio_information, frame_rate_code,
  bit_rate, marker bit, vbv_buffer_size, constrained flag, matrix-load flags
  (RTL:2598-2607);
* sequence extension: profile/level (MP@HL), chroma format 4:2:0, size
  extensions, bit-rate extension, marker, vbv extension, low_delay,
  frame-rate extensions (RTL:2603-2611);
* sequence display extension: video format, colour description triplet,
  display sizes + marker (RTL:2612-2617);
* GOP header: time code (drop_frame, hh:mm:ss:ff against the expected 24fps
  counter), marker, closed_gop, broken_link (RTL:2650-2656, 2684-2698);
* picture header: temporal_reference, coding type, vbv_delay, P-picture
  full_pel flag and the legacy forward_f_code '111' (RTL:2663-2676);
* picture coding extension: all four f_codes, intra_dc_precision,
  picture_structure, the nine flag bits (RTL:2677-2682);
* slice headers: start-code order, quantiser_scale_code consistency,
  extra_bit_slice (RTL:2708-2710);
* macroblock layer: address increments, types, motion residuals and ranges,
  CBP validity, coefficient-run overflow, EOB placement;
* byte alignment of every start code and zero stuffing in between.

Because the official IDCT is not bit-exact to the RTL's Chen-Wang pipeline
(and ISO mismatch control / [-2048,2047] saturation differ from the RTL's
+-2047 clip), the decoded pictures are compared by distortion, not equality:
``psnr_vs()`` against the encoder's reconstruction should exceed ~45 dB on
any conforming stream (drift is bounded by the GOP length).

Notes on two deliberate RTL-semantics choices (documented, not ISO):
* chroma motion vectors use the RTL's floor halving (mv >> 1), matching the
  emitted stream's intent (RTL:1847-1888);
* half-pel interpolation uses the RTL's +1-rounded means for both 2- and
  4-tap cases (RTL:750-767); ISO specifies //2 and //4 with +1/+2 rounding,
  which coincides for the 2-tap case.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import tables as T


class ValidationError(ValueError):
    pass


# ---------------------------------------------------------------------------
# bit reader (independent implementation)
# ---------------------------------------------------------------------------
class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.bit = 0

    def u(self, n: int, what: str = "") -> int:
        end = self.bit + n
        if end > len(self.data) * 8:
            raise ValidationError(f"stream truncated reading {what}")
        v = 0
        b, o = divmod(self.bit, 8)
        for _ in range(n):
            v = (v << 1) | ((self.data[b] >> (7 - o)) & 1)
            o += 1
            if o == 8:
                o, b = 0, b + 1
        self.bit = end
        return v

    def peek(self, n: int) -> int:
        save = self.bit
        v = self.u(n, "peek")
        self.bit = save
        return v

    def expect(self, n: int, value: int, what: str) -> None:
        got = self.u(n, what)
        if got != value:
            raise ValidationError(
                f"{what}: expected {value:#x}, got {got:#x} (bit {self.bit - n})")

    def byte_aligned(self) -> bool:
        return self.bit % 8 == 0

    def next_start_code(self) -> int:
        """Consume alignment + zero stuffing up to the next start code."""
        if not self.byte_aligned():
            pad = self.u(8 - self.bit % 8, "alignment padding")
            if pad != 0:
                raise ValidationError("nonzero bits in start-code alignment")
        while True:
            if self.bit + 32 > len(self.data) * 8:
                raise ValidationError("ran off stream looking for start code")
            if self.peek(24) == 1:
                self.u(24, "start code prefix")
                return self.u(8, "start code value")
            if self.peek(8) != 0:
                raise ValidationError(
                    f"nonzero stuffing byte before start code at bit {self.bit}")
            self.u(8, "stuffing")


# ---------------------------------------------------------------------------
# VLC decode tables (ISO constant tables; shared constants, independent logic)
# ---------------------------------------------------------------------------
def _inv(bits, lens, skip_zero=True) -> Dict[Tuple[int, int], int]:
    d: Dict[Tuple[int, int], int] = {}
    for i, (b, l) in enumerate(zip(np.asarray(bits).tolist(),
                                   np.asarray(lens).tolist())):
        if l == 0 and skip_zero:
            continue
        d.setdefault((int(l), int(b)), i)
    return d


_MV_T = _inv(T.BITS_MOTION_VECTOR, T.LENS_MOTION_VECTOR)
_CBP_T = _inv(T.BITS_NZ_FLAGS, T.LENS_NZ_FLAGS)
_DCY_T = _inv(T.BITS_DC_Y, T.LENS_DC_Y, skip_zero=False)
_DCUV_T = _inv(T.BITS_DC_UV, T.LENS_DC_UV, skip_zero=False)
_AC_T: Dict[Tuple[int, int], Tuple[int, int]] = {}
for _r in range(32):
    for _a in range(41):
        if T.AC_VALID[_r, _a]:
            _AC_T[(int(T.AC_LEN[_r, _a]), int(T.AC_CODE[_r, _a]))] = (_r, _a + 1)


def _vlc(r: _Reader, table, max_len: int, what: str) -> int:
    for l in range(1, max_len + 1):
        hit = table.get((l, r.peek(l)))
        if hit is not None:
            r.u(l, what)
            return hit
    raise ValidationError(f"invalid {what} VLC at bit {r.bit}")


# ---------------------------------------------------------------------------
# ISO 13818-2 arithmetic (independent of the encoder's fixed-point pipeline)
# ---------------------------------------------------------------------------
_IDCT_BASIS = None


def _idct_float(block: np.ndarray) -> np.ndarray:
    """Official-accuracy floating IDCT: separable orthonormal DCT-III in
    float64, rounded half away from zero, saturated to [-256, 255] (7.4.5)."""
    global _IDCT_BASIS
    if _IDCT_BASIS is None:
        k = np.arange(8)
        c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
        _IDCT_BASIS = 0.5 * c[:, None] * np.cos((2 * k[None, :] + 1)
                                                * k[:, None] * np.pi / 16.0)
    f = _IDCT_BASIS.T @ block.astype(np.float64) @ _IDCT_BASIS
    r = np.where(f >= 0, np.floor(f + 0.5), np.ceil(f - 0.5)).astype(np.int32)
    return np.clip(r, -256, 255)


def _dequant_iso(qf: np.ndarray, intra: bool, quantiser_scale: int) -> np.ndarray:
    """Inverse quantisation per ISO 13818-2 7.4.2 with default matrices,
    saturation to [-2048, 2047] and mismatch control (7.4.4)."""
    w = np.asarray(T.INTRA_Q, np.int64) if intra else np.full((8, 8), 16, np.int64)
    q = qf.astype(np.int64)
    if intra:
        f = (q * w * quantiser_scale * 2) // 32
        f = np.where(q < 0, -((-q * w * quantiser_scale * 2) // 32), f)
        # intra DC: F[0][0] = QF[0][0] * (2 ** (11 - intra_dc_precision + ... ))
        f[0, 0] = q[0, 0] * 2        # intra_dc_precision = 10 -> multiplier 2
    else:
        k = np.where(q > 0, 1, np.where(q < 0, -1, 0))
        mag = (np.abs(2 * q + k) * w * quantiser_scale) // 32
        f = np.where(q < 0, -mag, mag)
    f = np.clip(f, -2048, 2047)
    if (int(f.sum()) & 1) == 0:      # mismatch control: force odd sum
        f[7, 7] += -1 if (f[7, 7] & 1) else 1
    return f.astype(np.int32)


def _half_pel(plane: np.ndarray, y0: int, x0: int, h: int, w: int,
              hpy: int, hpx: int) -> np.ndarray:
    """Prediction fetch at half-pel resolution; plane is zero-padded."""
    a = plane[y0:y0 + h + 1, x0:x0 + w + 1].astype(np.int32)
    if hpy == 0 and hpx == 0:
        return a[:h, :w]
    if hpy == 0:
        return (a[:h, :w] + a[:h, 1:w + 1] + 1) >> 1
    if hpx == 0:
        return (a[:h, :w] + a[1:h + 1, :w] + 1) >> 1
    return (a[:h, :w] + a[:h, 1:w + 1] + a[1:h + 1, :w] + a[1:h + 1, 1:w + 1]
            + 1) >> 2


# ---------------------------------------------------------------------------
# validated stream model
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ValidatedPicture:
    coding_type: int                   # 1=I, 2=P
    temporal_reference: int
    quantiser_scale_code: int
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray


@dataclasses.dataclass
class ValidatedSequence:
    width: int
    height: int
    bit_rate_units: int
    gop_timecodes: List[Tuple[int, int, int, int, int]]   # (drop, h, m, s, f)
    pictures: List[ValidatedPicture]

    def psnr_vs(self, planes: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                component: int = 0) -> float:
        """PSNR of this decode against reference planes (e.g. encoder recon)."""
        errs = []
        for pic, ref in zip(self.pictures, planes):
            mine = (pic.y, pic.u, pic.v)[component].astype(np.float64)
            errs.append(((mine - ref[component].astype(np.float64)) ** 2).mean())
        mse = float(np.mean(errs))
        return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _parse_sequence_header(r: _Reader) -> Tuple[int, int, int]:
    width = r.u(12, "horizontal_size_value")
    height = r.u(12, "vertical_size_value")
    if width == 0 or height == 0:
        raise ValidationError("zero picture dimension")
    r.expect(4, 1, "aspect_ratio_information (square)")
    r.expect(4, 2, "frame_rate_code (24fps)")
    bit_rate = r.u(18, "bit_rate_value")
    r.expect(1, 1, "sequence header marker bit")
    r.expect(10, 0, "vbv_buffer_size_value")
    r.expect(1, 0, "constrained_parameters_flag")
    r.expect(1, 0, "load_intra_quantiser_matrix")
    r.expect(1, 0, "load_non_intra_quantiser_matrix")
    return width, height, bit_rate


def _parse_sequence_extension(r: _Reader) -> None:
    r.expect(4, 0b0001, "extension id (sequence)")
    r.expect(8, 0x44, "profile_and_level_indication (MP@HL)")
    r.expect(1, 0, "progressive_sequence")
    r.expect(2, 0b01, "chroma_format (4:2:0)")
    r.expect(2, 0, "horizontal_size_extension")
    r.expect(2, 0, "vertical_size_extension")
    r.expect(12, 0, "bit_rate_extension")
    r.expect(1, 1, "sequence extension marker bit")
    r.expect(8, 0, "vbv_buffer_size_extension")
    r.expect(1, 0, "low_delay")
    r.expect(2, 0, "frame_rate_extension_n")
    r.expect(5, 0, "frame_rate_extension_d")


def _parse_display_extension(r: _Reader, width: int, height: int) -> None:
    r.expect(4, 0b0010, "extension id (sequence display)")
    r.expect(3, 0b001, "video_format")
    r.expect(1, 1, "colour_description")
    r.expect(8, 5, "colour_primaries")
    r.expect(8, 5, "transfer_characteristics")
    r.expect(8, 5, "matrix_coefficients")
    if r.u(14, "display_horizontal_size") != width:
        raise ValidationError("display_horizontal_size != coded width")
    r.expect(1, 1, "display extension marker bit")
    if r.u(14, "display_vertical_size") != height:
        raise ValidationError("display_vertical_size != coded height")


def _parse_picture_coding_extension(r: _Reader, coding_type: int) -> None:
    r.expect(4, 0b1000, "extension id (picture coding)")
    for name in ("f_code[0][0]", "f_code[0][1]", "f_code[1][0]", "f_code[1][1]"):
        r.expect(4, 1, name)
    r.expect(2, 2, "intra_dc_precision (10-bit)")
    r.expect(2, 3, "picture_structure (frame)")
    r.expect(1, 1, "top_field_first")
    r.expect(1, 1, "frame_pred_frame_dct")
    r.expect(1, 0, "concealment_motion_vectors")
    r.expect(1, 0, "q_scale_type")
    r.expect(1, 0, "intra_vlc_format")
    r.expect(1, 0, "alternate_scan")
    r.expect(1, 0, "repeat_first_field")
    r.expect(1, 0, "chroma_420_type")
    r.expect(1, 0, "progressive_frame")
    r.expect(1, 0, "composite_display_flag")


def _decode_ac_events(r: _Reader, q: np.ndarray, intra: bool, start: int) -> None:
    """Coefficient events until EOB; q is the 64-entry zig-zag vector."""
    pos = start
    first = not intra and start == 0
    while True:
        if r.peek(2) == 0b10 and not first:
            r.u(2, "EOB")
            return
        if first and r.peek(1) == 1:
            r.u(1, "first-coefficient (0,1) code")
            lvl = -1 if r.u(1, "sign") else 1
            run = 0
        elif r.peek(6) == 1:
            r.u(6, "escape prefix")
            run = r.u(6, "escape run")
            lvl = r.u(12, "escape level")
            if lvl >= 2048:
                lvl -= 4096
            if lvl == 0 or lvl == -2048:
                raise ValidationError("forbidden escape level")
        else:
            hit = None
            for l in range(2, 17):
                hit = _AC_T.get((l, r.peek(l)))
                if hit is not None:
                    r.u(l, "AC run/level")
                    break
            if hit is None:
                raise ValidationError(f"invalid AC code at bit {r.bit}")
            run, absv = hit
            lvl = -absv if r.u(1, "AC sign") else absv
        pos += run
        if pos > 63:
            raise ValidationError("coefficient run past position 63")
        q[pos] = lvl
        pos += 1
        first = False


def validate_sequence(data: bytes, expected_frames: Optional[int] = None
                      ) -> ValidatedSequence:
    """Full-syntax validation + ISO-arithmetic decode of one elementary stream."""
    if len(data) % 32 != 0:
        raise ValidationError("stream length not a multiple of 32 bytes")
    r = _Reader(data)
    if r.next_start_code() != 0xB3:
        raise ValidationError("stream must begin with a sequence header")
    width, height, bit_rate = _parse_sequence_header(r)
    if r.next_start_code() != 0xB5:
        raise ValidationError("sequence extension must follow the header")
    _parse_sequence_extension(r)
    if r.next_start_code() != 0xB5:
        raise ValidationError("sequence display extension expected")
    _parse_display_extension(r, width, height)

    nbx, nby = width // 16, height // 16
    zig = np.asarray(T.ZIGZAG_FLAT)

    gops: List[Tuple[int, int, int, int, int]] = []
    pictures: List[ValidatedPicture] = []
    cur: Optional[List[np.ndarray]] = None
    cur_type = cur_tref = cur_qsc = 0
    slices_seen = 0
    ref: Optional[List[np.ndarray]] = None

    def close_picture():
        nonlocal cur, ref, slices_seen
        if cur is None:
            return
        if slices_seen != nby:
            raise ValidationError(
                f"picture has {slices_seen} slices, expected {nby}")
        pictures.append(ValidatedPicture(cur_type, cur_tref, cur_qsc,
                                         cur[0], cur[1], cur[2]))
        ref = cur
        cur = None

    while True:
        code = r.next_start_code()
        if code == 0xB7:
            close_picture()
            break
        if code == 0xB8:
            close_picture()
            drop = r.u(1, "drop_frame_flag")
            hh = r.u(5, "time_code_hours")
            mm = r.u(6, "time_code_minutes")
            r.expect(1, 1, "time code marker bit")
            ss = r.u(6, "time_code_seconds")
            ff = r.u(6, "time_code_pictures")
            if mm >= 60 or ss >= 60 or ff >= 24:
                raise ValidationError("time code field out of range")
            r.expect(1, 1, "closed_gop")
            r.expect(1, 0, "broken_link")
            gops.append((drop, hh, mm, ss, ff))
            continue
        if code == 0x00:
            close_picture()
            cur_tref = r.u(10, "temporal_reference")
            cur_type = r.u(3, "picture_coding_type")
            if cur_type not in (1, 2):
                raise ValidationError(f"unsupported picture type {cur_type}")
            if cur_type == 2 and ref is None:
                raise ValidationError("P-picture before any reference")
            r.expect(16, 0, "vbv_delay")
            if cur_type == 2:
                r.expect(1, 0, "full_pel_forward_vector")
                r.expect(3, 0b111, "forward_f_code (legacy)")
            if r.next_start_code() != 0xB5:
                raise ValidationError("picture coding extension expected")
            _parse_picture_coding_extension(r, cur_type)
            cur = [np.zeros((height, width), np.uint8),
                   np.zeros((height // 2, width // 2), np.uint8),
                   np.zeros((height // 2, width // 2), np.uint8)]
            slices_seen = 0
            continue
        if 0x01 <= code <= 0xAF:
            if cur is None:
                raise ValidationError("slice outside a picture")
            y16 = code - 1
            if y16 != slices_seen:
                raise ValidationError(
                    f"slice start codes out of order: got row {y16}, "
                    f"expected {slices_seen}")
            slices_seen += 1
            qsc = r.u(5, "quantiser_scale_code")
            if qsc not in (2, 4, 8, 16):
                raise ValidationError(f"unexpected quantiser_scale_code {qsc}")
            quantiser_scale = 2 * qsc    # q_scale_type=0: scale = code * 2
            cur_qsc = qsc
            r.expect(1, 0, "extra_bit_slice")

            if ref is not None:
                py = np.pad(ref[0], 8)
                pu = np.pad(ref[1], 4)
                pv = np.pad(ref[2], 4)
            else:
                py = np.zeros((height + 16, width + 16), np.uint8)
                pu = np.zeros((height // 2 + 8, width // 2 + 8), np.uint8)
                pv = pu
            pmvx = pmvy = 0
            # ISO 7.2.1: DC predictors reset to 2**(intra_dc_precision-1) =
            # 512.  (The RTL encoder's '0-reset + residual-vs-128 DC' is the
            # same stream: its residual DC q = QF_absolute - 512 exactly.)
            pdc = [512, 512, 512]
            for bx in range(nbx):
                r.expect(1, 1, "macroblock_address_increment")
                if cur_type == 1:
                    r.expect(1, 1, "I macroblock type (intra)")
                    intra, coded, mc = True, True, False
                else:
                    if r.peek(1) == 1:
                        r.u(1, "P macroblock type")
                        intra, coded, mc = False, True, True
                    elif r.peek(3) == 0b001:
                        r.u(3, "P macroblock type")
                        intra, coded, mc = False, False, True
                    elif r.peek(5) == 0b00011:
                        r.u(5, "P macroblock type")
                        intra, coded, mc = True, True, False
                    else:
                        raise ValidationError(
                            f"invalid P macroblock type at bit {r.bit}")
                mvx = mvy = 0
                if mc:
                    for comp in (0, 1):
                        a = _vlc(r, _MV_T, 11, "motion_code")
                        d = 0
                        if a != 0:
                            d = -a if r.u(1, "motion sign") else a
                        m = (pmvx if comp == 0 else pmvy) + d
                        if m > 15:
                            m -= 32
                        elif m < -16:
                            m += 32
                        if comp == 0:
                            mvx = pmvx = m
                        else:
                            mvy = pmvy = m
                if intra:
                    pmvx = pmvy = 0
                cbp = 0b111111 if intra else 0
                if not intra and coded:
                    cbp = _vlc(r, _CBP_T, 9, "coded_block_pattern")
                    if cbp == 0:
                        raise ValidationError("CBP 0 encoded for a coded MB")

                # prediction (RTL-semantics chroma halving, see module doc).
                # ISO intra blocks have NO spatial prediction: the absolute
                # DC (carried through the 512-reset predictor chain) encodes
                # the full pixel level, so the prediction is zero.
                if intra or cur_type == 1:
                    ypred = np.zeros((16, 16), np.int32)
                    upred = np.zeros((8, 8), np.int32)
                    vpred = np.zeros((8, 8), np.int32)
                else:
                    fy, fx = mvy >> 1, mvx >> 1
                    hpy, hpx = mvy & 1, mvx & 1
                    ypred = _half_pel(py, 8 + y16 * 16 + fy, 8 + bx * 16 + fx,
                                      16, 16, hpy, hpx)
                    cmy, cmx = mvy >> 2, mvx >> 2
                    chy, chx = (mvy >> 1) & 1, (mvx >> 1) & 1
                    upred = _half_pel(pu, 4 + y16 * 8 + cmy, 4 + bx * 8 + cmx,
                                      8, 8, chy, chx)
                    vpred = _half_pel(pv, 4 + y16 * 8 + cmy, 4 + bx * 8 + cmx,
                                      8, 8, chy, chx)
                preds = [ypred[0:8, 0:8], ypred[0:8, 8:16], ypred[8:16, 0:8],
                         ypred[8:16, 8:16], upred, vpred]

                for t in range(6):
                    comp = 0 if t < 4 else (1 if t == 4 else 2)
                    q = np.zeros(64, np.int32)
                    any_coeff = False
                    if intra:
                        size = _vlc(r, _DCY_T if t < 4 else _DCUV_T, 10,
                                    "dct_dc_size")
                        diff = 0
                        if size:
                            raw = r.u(size, "dct_dc_differential")
                            diff = raw if raw >> (size - 1) \
                                else raw - ((1 << size) - 1)
                        dc = pdc[comp] + diff  # absolute quantised DC
                        if not (0 <= dc <= 2047):
                            raise ValidationError(
                                f"intra DC {dc} out of 10-bit range "
                                f"(pic {len(pictures)}, slice {y16}, mb {bx}, "
                                f"tile {t}, pred {pdc[comp]}, diff {diff}, "
                                f"size {size}, bit {r.bit})")
                        pdc[comp] = dc
                        q[0] = dc
                        _decode_ac_events(r, q, intra=True, start=1)
                        any_coeff = True
                    else:
                        pdc[comp] = 512        # ISO reset at non-intra MBs
                        if (cbp >> (5 - t)) & 1:
                            _decode_ac_events(r, q, intra=False, start=0)
                            any_coeff = True
                    block = q[zig].reshape(8, 8)   # inverse scan
                    if any_coeff:
                        f = _dequant_iso(block, intra, quantiser_scale)
                        resid = _idct_float(f)
                    else:
                        resid = np.zeros((8, 8), np.int32)
                    rec = np.clip(preds[t] + resid, 0, 255).astype(np.uint8)
                    if t < 4:
                        ry, rx = y16 * 16 + (t // 2) * 8, bx * 16 + (t % 2) * 8
                        cur[0][ry:ry + 8, rx:rx + 8] = rec
                    else:
                        cur[comp][y16 * 8:y16 * 8 + 8, bx * 8:bx * 8 + 8] = rec
            continue
        raise ValidationError(f"unexpected start code {code:02x}")

    if expected_frames is not None and len(pictures) != expected_frames:
        raise ValidationError(
            f"decoded {len(pictures)} pictures, expected {expected_frames}")
    tail = data[r.bit // 8:]
    if any(tail):
        raise ValidationError("nonzero bytes after sequence_end_code")
    return ValidatedSequence(width, height, bit_rate, gops, pictures)
