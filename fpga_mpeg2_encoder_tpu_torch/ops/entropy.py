"""Vectorised entropy coding: VLC symbolisation of a whole frame at once.

The reference emits symbols serially through a 7-chunk-per-cycle FSM
(RTL/mpeg2encoder.v:2476-2956).  The sequential state it carries - per-slice DC
predictors, per-slice MV predictors, per-tile run lengths - is *linear*: every
predictor depends on the previous macroblock's outputs only, never on emitted
bits.  So the whole frame symbolises in parallel:

* DC prediction : published[t] = inter ? 0 : dc[t]; pred = shift-by-one within
                  the slice (RTL:2781-2792).
* MV prediction : published[mb] = inter ? mv : 0; pred = shift within slice
                  (RTL:2712-2773).
* run lengths   : prev-nonzero index via cumulative max over the zig order
                  (incl. the inter-DC-zero counts-as-run rule, RTL:2795-2834).

VLC tables are looked up by plain indexing.  The 111-entry B.14 run/level
table is compacted through a 5-case perfect key in [0, 144); everything
outside it is the 24-bit escape, computed arithmetically (RTL:2541-2543).

Output is a slot grid - (2 + mb_rows) rows x S slots - with GOP/picture
headers as the first two rows (`symbolize_frame`), or its two parts apart
(`symbolize_rows`, the compiled gop program's form).  A slot is one int32
holding the bit pattern of the uint32 ``code | len << 27``, so a slot of
length >= 16 is negative: read slots through `slot_len` and `slot_u32`.  A
zero-length slot emits nothing, whatever its code.
The non-AC slots and the header rows are formed by ops/kernels/glue.py (its
plain version is `ac_inputs` and `_header_rows` below), the AC slots by
ops/kernels/acsym.py (its plain version is `ac_slot_grid`).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import tables as T

SLOTS_PER_MB = 4 + 6 * 65  # type, mvx, mvy, cbp, 6 x (dc, 63 ac, eob)
HDR_SLOTS = 3              # slice start code, row number, quantiser scale
HEADER_ROWS = 2            # row 0: GOP header, row 1: picture header

# Packed slot encoding: code | len << 27.  Every code in the stream is <= 25
# bits (largest: 24-bit start codes and escapes) and every len <= 24.
SLOT_LEN_SHIFT = 27
SLOT_CODE_MASK = (1 << SLOT_LEN_SHIFT) - 1

# compact AC key: perfect map of B.14's 111 valid (run, am1) pairs into
# [0, 139), padded to 144; 143 is the invalid sentinel
_AC_K = 144


def _build_ac_table() -> np.ndarray:
    tab = np.zeros(_AC_K, np.int64)   # valid<<22 | code<<6 | len
    def put(k, r, a):
        if T.AC_VALID[r, a]:
            tab[k] = (1 << 22) | (int(T.AC_CODE[r, a]) << 6) | int(T.AC_LEN[r, a])
    for r in range(8):
        for a in range(8):
            put(r * 8 + a, r, a)                      # A: [0, 64)
    for a in range(8, 40):
        put(64 + a - 8, 0, a)                         # B: [64, 96)
    for a in range(8, 18):
        put(96 + a - 8, 1, a)                         # C: [96, 106)
    for r in range(8, 17):
        for a in range(2):
            put(106 + (r - 8) * 2 + a, r, a)          # D: [106, 124)
    for r in range(17, 32):
        put(124 + r - 17, r, 0)                       # E: [124, 139)
    return tab


AC_TABLE = _build_ac_table()

# small header/VLC tables (combined code<<5|len entries)
_MV_TAB = (T.BITS_MOTION_VECTOR.astype(np.int64) << 5) | T.LENS_MOTION_VECTOR
_CBP_TAB = (T.BITS_NZ_FLAGS.astype(np.int64) << 5) | T.LENS_NZ_FLAGS
_DCY_TAB = (T.BITS_DC_Y.astype(np.int64) << 5) | T.LENS_DC_Y
_DCUV_TAB = (T.BITS_DC_UV.astype(np.int64) << 5) | T.LENS_DC_UV


# The DC size lookups get an empty entry for size 12 (a DC difference of
# 2048 or more, which pixels never give): the JAX package's one-hot lookup
# gives 0 there, so the size code is empty and the value keeps its 12 bits.
_TABLES = {"ac": AC_TABLE, "mv": _MV_TAB, "cbp": _CBP_TAB,
           "dcy": np.append(_DCY_TAB, 0), "dcuv": np.append(_DCUV_TAB, 0)}


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device: torch.device) -> torch.Tensor:
    """A VLC table on ``device``, uploaded once: an upload per frame from
    pageable host memory would make the host wait for the device."""
    return torch.as_tensor(_TABLES[name], device=device)


def _lookup(name: str, idx: torch.Tensor) -> torch.Tensor:
    return _device_table(name, idx.device)[idx.long()]


def _ac_key(run: torch.Tensor, am1: torch.Tensor) -> torch.Tensor:
    k = torch.full_like(run, _AC_K - 1)               # sentinel (invalid) row
    k = torch.where((run <= 7) & (am1 <= 7), run * 8 + am1, k)
    k = torch.where((run == 0) & (am1 >= 8) & (am1 <= 39), 64 + am1 - 8, k)
    k = torch.where((run == 1) & (am1 >= 8) & (am1 <= 17), 96 + am1 - 8, k)
    k = torch.where((run >= 8) & (run <= 16) & (am1 <= 1), 106 + (run - 8) * 2 + am1, k)
    k = torch.where((run >= 17) & (run <= 31) & (am1 == 0), 124 + run - 17, k)
    return k


def _ac_symbol(v: torch.Tensor, run: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """put_AC (RTL:2525-2547) for v != 0: (code, len) as int64."""
    v = v.to(torch.int64)
    run = run.to(torch.int64)
    e = _lookup("ac", _ac_key(run, v.abs() - 1))
    valid = e >= (1 << 22)
    code_t = (((e >> 6) & 0xFFFF) << 1) | (v < 0).to(torch.int64)
    esc = (1 << 18) | (run << 12) | (v & 0xFFF)
    return torch.where(valid, code_t, esc), torch.where(valid, (e & 63) + 1, 24)


def pack_slot(code: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Pack (code <= 25 bits, len <= 24) into one slot's uint32 pattern, as
    int64.  Storing it into the int32 grid narrows it (wrapping) in the same
    copy, so the grid costs no narrowing pass."""
    return code.to(torch.int64) | (length.to(torch.int64) << SLOT_LEN_SHIFT)


def slot_u32(slots: torch.Tensor) -> torch.Tensor:
    """The uint32 patterns of int32 slots, as int64: a slot of length >= 16
    is negative as int32, so widen and mask before any shift."""
    return slots.to(torch.int64) & 0xFFFFFFFF


def slot_len(slots: torch.Tensor) -> torch.Tensor:
    """The lengths of int32 slots, in their dtype."""
    return (slots >> SLOT_LEN_SHIFT) & 31


def _s32(v: int) -> int:
    """The int32 whose bit pattern is the uint32 ``v``."""
    return v - (1 << 32) if v >= 1 << 31 else v


def gop_scalar(v, device, out=None) -> torch.Tensor:
    """A GOP position, frame number or I-frame flag as a 0-d tensor on
    ``device``: a tensor is used as it is (it must lie there already), a
    Python int or bool is filled in on the device as int32, never uploaded,
    so neither waits for the device and both can be captured in a CUDA
    graph.  With ``out`` (a 0-d tensor there) the value is copied or filled
    into it, and ``out`` is returned."""
    if torch.is_tensor(v):
        dev = torch.device(device)
        if v.dim() != 0 or v.device.type != dev.type \
                or dev.index not in (None, v.device.index):
            raise ValueError(f"GOP state {tuple(v.shape)} on {v.device}: want a 0-d "
                             f"tensor on {dev}")
        return v if out is None else out.copy_(v)
    if out is not None:
        return out.fill_(int(v))
    return torch.full((), int(v), dtype=torch.int32, device=device)


def _header_table() -> np.ndarray:
    """The constant part of the GOP + picture header slots (RTL:2650-2698):
    (2 kinds, I then P, 14 slots, GOP row then picture row) packed
    code | len << 27; _header_rows adds the timecode and the GOP position to
    the codes.  A P-frame's GOP slots keep their codes at length 0."""
    gop_codes = [1, 0xB8, 0, 0, 64, 0, 2]
    pic_codes = [1, 0, 0x10000, 0, 1, 0xB58111, 0x1BC000]
    tab = np.zeros((2, 14), np.int64)
    for is_p in (0, 1):
        gop_lens = [0] * 7 if is_p else [24, 8, 6, 6, 7, 6, 2]
        pic_lens = [24, 18, 19, 11 if is_p else 3, 24, 24, 24]
        tab[is_p] = [c | n << SLOT_LEN_SHIFT for c, n in
                     zip(gop_codes + pic_codes, gop_lens + pic_lens)]
    return tab


_TABLES["header"] = _header_table()


def _header_rows(i_frame, frame_no, s: int, device) -> torch.Tensor:
    """GOP + picture header rows (RTL:2650-2698) as a (2, s) slot grid,
    formed on the device from the GOP position and the frame number (0-d
    tensors, or Python ints), as the JAX package forms them in-trace."""
    i_f = gop_scalar(i_frame, device).to(torch.int64)
    fno = gop_scalar(frame_no, device).to(torch.int64)
    is_p = i_f != 0
    hour = (fno // (24 * 3600)).clamp(max=63)
    minute = (fno // (24 * 60)) % 60
    second = (fno // 24) % 60
    insec = fno % 24
    p = is_p.to(torch.int64)
    # added to the codes of GOP slots 2-5 and picture slots 1-3
    dyn = torch.stack([hour, minute, second, insec, i_f, p * 0x10000, p * 0x380])
    dyn = torch.cat([F.pad(dyn[:4], (2, 1)), F.pad(dyn[4:], (1, 3))])
    tab = _device_table("header", torch.device(device))
    rows = torch.zeros((2, s), dtype=torch.int32, device=device)
    rows[:, :7] = (torch.where(is_p, tab[1], tab[0]) + dyn).view(2, 7)
    return rows


def ac_slot_grid(zmod: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """Plain version of the acsym kernel: AC run/level symbolisation routed
    into the slot grid.

    zmod: (nby, nbx*6*64) int zig-zag coefficients with position 0 replaced
    by the emit flag (intra or DC != 0), which only influences run lengths;
    small: (nby, S) int32 packed non-AC slots (zero at AC slots).
    Returns (nby, S) int32: ``small`` with AC slot 3 + 394*mb + 4 + 65*t + z
    set for z = 1..63 (zero where the coefficient is zero)."""
    nby, width = zmod.shape
    nbx = width // 384
    z = zmod.reshape(nby, nbx, 6, 64).to(torch.int64)
    k = torch.arange(64, device=z.device)
    ew = torch.where(z != 0, k, -1)
    pm = ew.cummax(dim=-1).values
    prev = torch.cat([torch.full_like(pm[..., :1], -1), pm[..., :-1]], dim=-1)
    run = k - prev - 1
    code, length = _ac_symbol(torch.where(z == 0, 1, z), run)
    ac = torch.where(z == 0, 0, pack_slot(code, length))
    out = small.clone()
    tiles = out[:, HDR_SLOTS:].view(nby, nbx, SLOTS_PER_MB)[:, :, 4:] \
        .view(nby, nbx, 6, 65)
    tiles[..., 1:64] = ac[..., 1:]
    return out


def symbolize_rows(
    quant_zig: torch.Tensor,  # (nby, nbx, 6, 64) int32, zig-zag coefficient order
    inter: torch.Tensor,      # (nby, nbx) bool
    mvx: torch.Tensor,        # (nby, nbx) int32 half-pel
    mvy: torch.Tensor,
    i_frame,                  # GOP position (0 => I-frame): 0-d tensor or int
    frame_no,                 # frames since sequence start (timecode): the same
    q_level: int,
    first_row: int = 0,       # frame MB row of row 0 (slice-row sharding)
    include_headers: bool = True,   # False: slice rows only (the sharded path
                                    # packs the header rows on their own)
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """-> (the header rows (2, S) int32, or None without include_headers;
    the slice rows (nby, S) int32), S = 3 + 394 * nbx: the slot grid's two
    parts as the glue and acsym kernels write them, each its own tensor.
    The glue kernel forms everything but the AC symbols (ac_inputs and
    _header_rows are its plain version), the acsym kernel the AC symbols.
    The gop program packs the two as they are (kernels.pack.pack_rows)."""
    # imported here: the kernel wrappers import this module
    from .kernels.acsym import ac_slot_grid as ac_slot_grid_dispatch
    from .kernels.glue import symbol_glue

    s = HDR_SLOTS + SLOTS_PER_MB * inter.shape[1]
    zmod, small, hdr = symbol_glue(quant_zig, inter, mvx, mvy, i_frame, frame_no, q_level,
                                   first_row, s if include_headers else None)
    return hdr, ac_slot_grid_dispatch(zmod, small)


def symbolize_frame(quant_zig, inter, mvx, mvy, i_frame, frame_no, q_level: int,
                    first_row: int = 0, include_headers: bool = True) -> torch.Tensor:
    """symbolize_rows' two parts as one (2 + nby, S) int32 slot grid, the
    header rows first; (nby, S) without them."""
    hdr, slice_slots = symbolize_rows(quant_zig, inter, mvx, mvy, i_frame, frame_no, q_level,
                                      first_row, include_headers)
    return slice_slots if hdr is None else torch.cat([hdr, slice_slots], dim=0)


def ac_inputs(quant_zig: torch.Tensor, inter: torch.Tensor, mvx: torch.Tensor,
              mvy: torch.Tensor, i_frame, q_level: int, first_row: int = 0):
    """Everything of a frame's slice rows but the AC symbols: returns the
    operands (zmod, small) of ac_slot_grid.  Slice headers number the rows
    from ``first_row``; ``i_frame`` is a 0-d tensor or an int."""
    nby, nbx = inter.shape
    dev = inter.device
    zig = quant_zig.to(torch.int64)
    intra = ~inter
    nz = intra[:, :, None] | (zig != 0).any(-1)                   # (nby, nbx, 6)
    cbp = sum(nz[..., t].to(torch.int64) << (5 - t) for t in range(6))

    is_p = gop_scalar(i_frame, dev) != 0
    # macroblock type (RTL:2722-2731)
    cbp0 = inter & (cbp == 0)
    type_code = torch.where(intra & is_p, 0x23, torch.where(cbp0, 0x09, 0x03))
    type_len = torch.where(intra & is_p, 6, torch.where(cbp0, 4, 2))

    # motion vector differentials (RTL:2735-2763)
    def mv_symbol(mv):
        mv = mv.to(torch.int64)
        pub = torch.where(inter, mv, 0)
        pred = torch.cat([torch.zeros_like(pub[:, :1]), pub[:, :-1]], dim=1)
        dmv = ((mv - pred + 16) & 31) - 16
        e = _lookup("mv", dmv.abs())
        s = (dmv != 0).to(torch.int64)
        code = ((e >> 5) << s) | (dmv < 0).to(torch.int64)
        return code, torch.where(inter, (e & 31) + s, 0)
    mvx_code, mvx_len = mv_symbol(mvx)
    mvy_code, mvy_len = mv_symbol(mvy)

    cbp_e = _lookup("cbp", cbp)
    cbp_code = cbp_e >> 5
    cbp_len = torch.where(inter, cbp_e & 31, 0)

    # ---- DC prediction chains (RTL:2781-2821) --------------------------------
    dc = zig[..., 0]                                              # (nby, nbx, 6)
    def shifted(pub):
        return torch.cat([torch.zeros_like(pub[:, :1]), pub[:, :-1]], dim=1)
    pub = torch.where(inter[:, :, None], 0, dc)
    pred_y = shifted(pub[..., :4].reshape(nby, nbx * 4)).reshape(nby, nbx, 4)
    pred_dc = torch.cat([pred_y, shifted(pub[..., 4])[..., None],
                         shifted(pub[..., 5])[..., None]], dim=-1)

    diff = dc - pred_dc
    mag = diff.abs()
    vallen = sum((mag >= (1 << k)).to(torch.int64) for k in range(12))
    val = diff & 0xFFF
    val = torch.where(diff < 0, (val + (1 << vallen) - 1) & 0xFFF, val)
    val = val & ((1 << vallen) - 1)
    is_luma = (torch.arange(6, device=dev) < 4)[None, None, :]
    dce = torch.where(is_luma, _lookup("dcy", vallen), _lookup("dcuv", vallen))
    dc_intra_code = ((dce >> 5) << vallen) | val
    dc_intra_len = (dce & 31) + vallen

    # inter DC: 0 => nothing (counts as run); +-1 => 2-bit '1s'; else put_AC(v, 0)
    dc_ac_code, dc_ac_len = _ac_symbol(torch.where(dc == 0, 1, dc), torch.zeros_like(dc))
    one = dc.abs() == 1
    dc_inter_code = torch.where(one, 2 | (dc < 0).to(torch.int64), dc_ac_code)
    dc_inter_len = torch.where(dc == 0, 0, torch.where(one, 2, dc_ac_len))
    dc_code = torch.where(inter[:, :, None], dc_inter_code, dc_intra_code)
    dc_len = torch.where(inter[:, :, None], dc_inter_len, dc_intra_len)

    # ---- packed non-AC slots --------------------------------------------------
    # A tile with nz=0 emits nothing: its AC coefficients are all zero and its
    # inter DC is 0, so only the EOB slot needs the explicit nz gate
    # (the RTL simply skips the tile, RTL:2823-2834).
    # Each store into the int32 grid narrows its slots in the same copy.
    mb_small = torch.zeros((nby, nbx, SLOTS_PER_MB), dtype=torch.int32, device=dev)
    mb_small[..., :4] = torch.stack(
        [pack_slot(type_code, type_len), pack_slot(mvx_code, mvx_len),
         pack_slot(mvy_code, mvy_len), pack_slot(cbp_code, cbp_len)], dim=-1)
    tile_small = mb_small[..., 4:].view(nby, nbx, 6, 65)
    tile_small[..., 0] = pack_slot(dc_code, dc_len)
    tile_small[..., 64] = pack_slot(torch.full_like(dc, 0b10), 2 * nz.to(torch.int64))
    y16 = torch.arange(first_row, first_row + nby, dtype=torch.int32, device=dev)
    hdr_p = torch.stack([torch.full_like(y16, _s32(1 | 24 << SLOT_LEN_SHIFT)),
                         (y16 + 1) | 8 << SLOT_LEN_SHIFT,
                         torch.full_like(y16, (2 << q_level) | 6 << SLOT_LEN_SHIFT)],
                        dim=1)
    small = torch.cat([hdr_p, mb_small.reshape(nby, nbx * SLOTS_PER_MB)], dim=1)

    # ---- AC run/level operands (RTL:2823-2834) --------------------------------
    emit0 = intra[:, :, None] | (dc != 0)                         # position-0 emits
    zmod = torch.cat([emit0[..., None].to(torch.int32),
                      quant_zig[..., 1:].to(torch.int32)], dim=-1)
    return zmod.reshape(nby, nbx * 384), small


def slice_words_bound(nbx: int) -> int:
    """Hard bound on packed words per slot-grid row: slice header 38 bits +
    worst-case macroblock symbols (every coefficient escaped)."""
    worst_mb = 6 + 11 + 11 + 9 + 6 * (24 + 63 * 24 + 2)
    return (38 + nbx * worst_mb + 31) // 32 + 1


def frame_words_bound(nbx: int, nby: int) -> int:
    """Hard bound on packed words per frame (headers + all slices)."""
    return nby * slice_words_bound(nbx) + 8
