"""The plain reference encoder: the stream that the benchmark holds the
port's output to, byte for byte.

The semantics are the FPGA MPEG-2 encoder IP's (RTL/mpeg2encoder.v), which
the port reproduces: 4:4:4 in, 4:2:0 subsample (mean2 of mean2), a full-pel
search of +-yr rows and columns with the IP's tie-breaks, the half-pel
refinement against the intra activity metric, the IP's integer DCT, its
quantisers and fixed-point Chen-Wang IDCT, the reconstruction that the next
P-frame predicts from, and the VLC symbols of ISO/IEC 13818-2 packed MSB
first, each slice row byte-aligned.

It is written in plain PyTorch operations, a frame at a time with all
macroblocks at once, and runs on any device: on the card it takes some
tens of milliseconds a 1920x1152 frame.  It imports nothing of the port and
keeps its own tables (vlc_data.py).  Symbols are (code, length) pairs of
int64 arrays laid out as the IP emits them: per slice row a 3-symbol slice
header, then per macroblock its type, the two motion vector differentials,
the coded block pattern and, per 8x8 tile, the DC symbol, 63 AC symbols
and the end of block.  A zero-length symbol emits nothing.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import vlc_data as D

W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565   # Chen-Wang IDCT constants
LUMA_HALO = 8
SYMBOLS_PER_MB = 4 + 6 * 65


def _ac_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense put_AC tables (RTL:2535-2540) indexed [run (0..32), |v|-1 (0..40)]:
    code without its sign bit, length without it, and whether the pair has a
    table code (else the 24-bit escape)."""
    code = np.zeros((33, 41), np.int64)
    length = np.zeros((33, 41), np.int64)
    valid = np.zeros((33, 41), bool)
    for r in range(32):
        for a in range(41):
            if (r == 0 and a < 40) or (r == 1 and a < 18) or (r == 2 and a < 5) \
                    or (r == 3 and a < 4):
                code[r, a], length[r, a] = D.BITS_AC_0_3[r][a], D.LENS_AC_0_3[r][a]
                valid[r, a] = True
            elif (r <= 6 and a < 3) or (r <= 16 and a < 2) or (r <= 31 and a < 1):
                code[r, a], length[r, a] = D.BITS_AC_4_31[r][a], D.LENS_AC_4_31[r][a]
                valid[r, a] = True
    return code, length, valid


_AC_CODE, _AC_LEN, _AC_VALID = _ac_tables()
_ZIGZAG_INV = np.argsort(np.asarray(D.ZIGZAG, np.int64).reshape(64))
_TABLES = {
    "dctm": np.asarray(D.DCTM, np.int64), "intra_q": np.asarray(D.INTRA_Q, np.int64),
    "zigzag_inv": _ZIGZAG_INV,
    "ac_code": _AC_CODE, "ac_len": _AC_LEN, "ac_valid": _AC_VALID,
    "mv_code": np.asarray(D.BITS_MOTION_VECTOR, np.int64),
    "mv_len": np.asarray(D.LENS_MOTION_VECTOR, np.int64),
    "cbp_code": np.asarray(D.BITS_NZ_FLAGS, np.int64),
    "cbp_len": np.asarray(D.LENS_NZ_FLAGS, np.int64),
    # a DC difference of 2048 or more has size 12, past the tables: its size
    # code is empty and the value keeps its 12 bits
    "dcy_code": np.append(np.asarray(D.BITS_DC_Y, np.int64), 0),
    "dcy_len": np.append(np.asarray(D.LENS_DC_Y, np.int64), 0),
    "dcuv_code": np.append(np.asarray(D.BITS_DC_UV, np.int64), 0),
    "dcuv_len": np.append(np.asarray(D.LENS_DC_UV, np.int64), 0),
}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TABLES[name], device=device)


# ---------------------------------------------------------------- 4:2:0
def _mean2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (1 + a.to(torch.int32) + b.to(torch.int32)) >> 1


def subsample(p: torch.Tensor) -> torch.Tensor:
    """(H, W) chroma plane -> (H/2, W/2): horizontal mean2, then vertical
    (RTL:1086-1171), each rounding up."""
    h = _mean2(p[:, 0::2], p[:, 1::2])
    return _mean2(h[1::2], h[0::2]).to(torch.uint8)


# ---------------------------------------------------------------- motion
def _find_min_10(v: torch.Tensor) -> torch.Tensor:
    """The IP's tournament over 10 values (RTL:804-840): v (..., 10) -> index."""
    def pick(lo, hi):
        lt = v[..., hi] < v[..., lo]
        return torch.where(lt, v[..., hi], v[..., lo]), torch.where(lt, hi, lo)
    w01, i01 = pick(0, 1)
    w23, i23 = pick(2, 3)
    w45, i45 = pick(4, 5)
    w67, i67 = pick(6, 7)
    w89, i89 = pick(8, 9)
    x0123 = torch.where(w23 < w01, w23, w01)
    i0123 = torch.where(w23 < w01, i23, i01)
    x4567 = torch.where(w67 < w45, w67, w45)
    i4567 = torch.where(w67 < w45, i67, i45)
    left = torch.where(x0123 < x4567, i0123, i4567)
    return torch.where((w89 <= x0123) & (w89 <= x4567), i89, left)


def _windows(plane_h: torch.Tensor, halo: int, bs: int, size: int,
             off_y: torch.Tensor, off_x: torch.Tensor) -> torch.Tensor:
    """(rows + 2*halo, W) plane -> (nby, nbx, size, size) int32 windows, window
    [by, bx] at row bs*by + off_y, column bs*bx + off_x of the plane without
    its halo; zero outside the plane."""
    p = F.pad(plane_h.to(torch.int32), (halo, halo))
    nby, nbx = off_y.shape
    k = torch.arange(size, device=plane_h.device)
    by = torch.arange(nby, device=plane_h.device)[:, None, None]
    bx = torch.arange(nbx, device=plane_h.device)[None, :, None]
    rows = bs * by + off_y[:, :, None] + halo + k
    cols = bs * bx + off_x[:, :, None] + halo + k
    return p[rows[:, :, :, None], cols[:, :, None, :]]


def motion(cur_y: torch.Tensor, prev_y: torch.Tensor, prev_u: torch.Tensor,
           prev_v: torch.Tensor, is_iframe: bool, yr: int):
    """Motion estimation and prediction of a whole frame (RTL:1310-1918).
    Returns (inter (nby, nbx) bool, mvx, mvy (nby, nbx) int64 in half pels,
    pred_y (nby, nbx, 16, 16), pred_u, pred_v (nby, nbx, 8, 8), all int64)."""
    h, w = cur_y.shape
    nby, nbx = h // 16, w // 16
    dev = cur_y.device
    n = 2 * yr + 1
    cy = cur_y.to(torch.int32)
    prev_h = F.pad(prev_y, (0, 0, LUMA_HALO, LUMA_HALO))

    # full-pel SADs of every offset, one row offset at a time
    prevp = F.pad(prev_h[LUMA_HALO - yr:LUMA_HALO + h + yr].to(torch.int32), (yr, yr))
    sads = []
    for iy in range(n):
        d = (cy[:, None, :] - prevp[iy:iy + h].unfold(1, w, 1)).abs()    # (h, n, w)
        sads.append(d.reshape(nby, 16, n, nbx, 16).sum((1, 4)).permute(1, 0, 2))
    sad = torch.cat(sads)                                               # (n*n, nby, nbx)

    lin_all = torch.arange(n * n, device=dev)
    dyi = (lin_all // n - yr)[:, None, None]
    dxi = (lin_all % n - yr)[:, None, None]
    col = torch.arange(nbx, device=dev)
    row = torch.arange(nby, device=dev)
    edge_l, edge_r = (col == 0)[None, :], (col == nbx - 1)[None, :]
    edge_t, edge_b = (row == 0)[:, None], (row == nby - 1)[:, None]
    invalid = (edge_l & (dxi < 0)) | (edge_r & (dxi > 0)) \
        | (edge_t & (dyi < 0)) | (edge_b & (dyi > 0)) | (sad > 4095)
    # the least SAD, then the largest dy, then the largest dx (RTL:1694-1710)
    big = 1 << 24
    key = torch.where(invalid, big, sad * (n * n) + (n * n - 1 - lin_all)[:, None, None])
    kmin = key.min(0).values
    lin = torch.where(kmin >= big, yr * n + yr, (n * n - 1) - kmin % (n * n))
    mvy_full, mvx_full = lin // n - yr, lin % n - yr

    # intra activity, with the IP's 16-bit accumulator (RTL:1659-1662, 1774-1791)
    blk = cy.reshape(nby, 16, nbx, 16).permute(0, 2, 1, 3)
    pixsum = blk.sum((2, 3))
    mean = (pixsum >> 8) & 0xFF
    acc = (pixsum + (blk - mean[:, :, None, None]).abs().sum((2, 3))) & 0xFFFF
    intra_cost = torch.where(acc < 4096, acc, 0xFFF)

    # half-pel candidates around each macroblock's full-pel vector
    w18 = _windows(prev_h, LUMA_HALO, 16, 18, mvy_full - 1, mvx_full - 1)
    hh = (1 + w18[..., :, :-1] + w18[..., :, 1:]) >> 1
    vv = (1 + w18[..., :-1, :] + w18[..., 1:, :]) >> 1
    m4 = (1 + w18[..., :-1, :-1] + w18[..., :-1, 1:] + w18[..., 1:, :-1]
          + w18[..., 1:, 1:]) >> 2

    def grid(hy: int, hx: int) -> torch.Tensor:
        ry, rx = (hy + 1) >> 1, (hx + 1) >> 1
        if hy == 0 and hx == 0:
            return w18[..., 1:17, 1:17]
        if hy == 0:
            return hh[..., 1:17, rx:rx + 16]
        if hx == 0:
            return vv[..., ry:ry + 16, 1:17]
        return m4[..., ry:ry + 16, rx:rx + 16]

    halves = [(hy, hx) for hy in (-1, 0, 1) for hx in (-1, 0, 1)]
    grids = [grid(hy, hx) for hy, hx in halves]
    vals = []
    for (hy, hx), g in zip(halves, grids):
        s = (blk - g).abs().sum((2, 3))
        bad = torch.zeros((nby, nbx), dtype=torch.bool, device=dev)
        if hx < 0:
            bad = bad | edge_l | (mvx_full == -yr)
        if hx > 0:
            bad = bad | edge_r | (mvx_full == yr)
        if hy < 0:
            bad = bad | edge_t | (mvy_full == -yr)
        if hy > 0:
            bad = bad | edge_b | (mvy_full == yr)
        vals.append(torch.where(bad | (s > 4095), 0x1000, s))
    vals.append(intra_cost)
    idx = _find_min_10(torch.stack(vals, dim=-1))

    inter = (idx != 9) & torch.tensor(not is_iframe, device=dev)
    hy_sel = torch.where(idx == 9, 0, idx // 3 - 1)
    hx_sel = torch.where(idx == 9, 0, idx % 3 - 1)
    # the vectors of a P-frame are kept where intra wins (RTL:1827-1828);
    # an I-frame's are zero (RTL:1820-1825)
    zero = torch.zeros_like(mvy_full)
    mvy = zero if is_iframe else mvy_full * 2 + hy_sel
    mvx = zero if is_iframe else mvx_full * 2 + hx_sel
    pred_y = torch.full((nby, nbx, 16, 16), 128, dtype=torch.int32, device=dev)
    for i9, g in enumerate(grids):
        pred_y = torch.where((inter & (idx == i9))[:, :, None, None], g, pred_y)

    # chroma: the luma vector's mv>>2 full pels and (mv>>1)&1 half flags
    # (RTL:1847-1917)
    def chroma(plane: torch.Tensor) -> torch.Tensor:
        hyb = (((mvy >> 1) & 1) > 0)[:, :, None, None]
        hxb = (((mvx >> 1) & 1) > 0)[:, :, None, None]
        w9 = _windows(F.pad(plane, (0, 0, 4, 4)), 4, 8, 9, mvy >> 2, mvx >> 2)
        p00 = w9[..., :8, :8]
        ph = (1 + p00 + w9[..., :8, 1:9]) >> 1
        pv = (1 + p00 + w9[..., 1:9, :8]) >> 1
        pm = (1 + p00 + w9[..., :8, 1:9] + w9[..., 1:9, :8] + w9[..., 1:9, 1:9]) >> 2
        p = torch.where(hyb & hxb, pm, torch.where(hxb, ph, torch.where(hyb, pv, p00)))
        return torch.where(inter[:, :, None, None], p, 128)

    return (inter, mvx.to(torch.int64), mvy.to(torch.int64), pred_y.to(torch.int64),
            chroma(prev_u).to(torch.int64), chroma(prev_v).to(torch.int64))


# ---------------------------------------------------------------- transform
def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def fdct(x: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) residuals -> the IP's DCT (RTL:2025-2062): M X M^T at full
    precision, rounded once by 4096, wrapped to 17 bits."""
    m = _table("dctm", x.device)
    s1 = (m[None, :, :, None] * x[:, None, :, :]).sum(2)
    t = (s1[:, :, None, :] * m[None, None, :, :]).sum(-1)
    r = (t >> 12) + ((t >> 11) & 1)
    return ((r & 0x1FFFF) ^ 0x10000) - 0x10000


def quantize(f: torch.Tensor, inter: torch.Tensor, q_level: int) -> torch.Tensor:
    """The IP's quantisers (RTL:2064-2077) with their 16-bit wraps."""
    w = _table("intra_q", f.device)
    a = f.abs() & 0xFFFF
    q_inter = ((a + 2) & 0xFFFF) >> (4 + q_level)
    off = (w * ((3 << q_level) + 2)) >> 3
    q_intra = torch.div(((a + off) & 0xFFFF) >> q_level, w, rounding_mode="floor")
    q_intra[:, 0, 0] = (a[:, 0, 0] >> 4) + ((a[:, 0, 0] >> 3) & 1)
    q = torch.where(inter[:, None, None], q_inter, q_intra).clamp(max=2047)
    return torch.where(f < 0, -q, q)


def dequantize(q: torch.Tensor, inter: torch.Tensor, q_level: int) -> torch.Tensor:
    """The reconstruction loop's inverse quantisers (RTL:2128-2150)."""
    x2 = q * 2
    xi = ((x2 + x2.sign()) << q_level).clamp(-2047, 2047)
    xa = q * _table("intra_q", q.device)
    xa = xa << (q_level - 3) if q_level >= 3 else xa >> (3 - q_level)
    xa = xa.clamp(-2047, 2047)
    xa[:, 0, 0] = q[:, 0, 0] * 2
    return torch.where(inter[:, None, None], xi, xa)


def _cw_stage(a, rounding: bool):
    """One pass of the IP's Chen-Wang IDCT on 8 lanes, with its 32-bit
    registers: rows (RTL:844-905), or columns with rounding (RTL:911-970)."""
    def shr(v, s):
        return _wrap32(v) >> s if s else v
    x0, x1, x2, x3 = a[0], a[4], a[6], a[2]
    x4, x5, x6, x7 = a[1], a[7], a[5], a[3]
    if rounding:
        x0, x1, r4, sh = (x0 << 8) + 8192, x1 << 8, 4, 3
    else:
        x0, x1, r4, sh = (x0 << 11) | 128, x1 << 11, 0, 0
    x8 = W7 * (x4 + x5) + r4
    x4 = shr(x8 + (W1 - W7) * x4, sh)
    x5 = shr(x8 - (W1 + W7) * x5, sh)
    x8 = W3 * (x6 + x7) + r4
    x6 = shr(x8 - (W3 - W5) * x6, sh)
    x7 = shr(x8 - (W3 + W5) * x7, sh)
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = W6 * (x3 + x2) + r4
    x2 = shr(x1 - (W2 + W6) * x2, sh)
    x3 = shr(x1 + (W2 - W6) * x3, sh)
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = shr(181 * (x4 + x5) + 128, 8)
    x4 = shr(181 * (x4 - x5) + 128, 8)
    fs = 14 if rounding else 8
    return [shr(x7 + x1, fs), shr(x3 + x2, fs), shr(x0 + x4, fs), shr(x8 + x6, fs),
            shr(x8 - x6, fs), shr(x0 - x4, fs), shr(x3 - x2, fs), shr(x7 - x1, fs)]


def idct(iq: torch.Tensor) -> torch.Tensor:
    rows = torch.stack(_cw_stage([iq[:, :, k] for k in range(8)], False), dim=2)
    rows = ((rows & 0x3FFFF) ^ 0x20000) - 0x20000          # 18-bit registers
    cols = torch.stack(_cw_stage([rows[:, k, :] for k in range(8)], True), dim=1)
    return cols.clamp(-255, 255)


def _tiles(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(nby, nbx, 16, 16) and two (nby, nbx, 8, 8) -> (nby, nbx, 6, 8, 8),
    tiles Y00, Y01, Y10, Y11, U, V."""
    nby, nbx = y.shape[:2]
    yt = y.reshape(nby, nbx, 2, 8, 2, 8).permute(0, 1, 2, 4, 3, 5).reshape(nby, nbx, 4, 8, 8)
    return torch.cat([yt, u[:, :, None], v[:, :, None]], dim=2)


def _blocks(plane: torch.Tensor, bs: int) -> torch.Tensor:
    h, w = plane.shape
    return plane.to(torch.int64).reshape(h // bs, bs, w // bs, bs).permute(0, 2, 1, 3)


def _plane(blocks: torch.Tensor) -> torch.Tensor:
    nby, nbx, bs, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(nby * bs, nbx * bs).to(torch.uint8)


def transform(cur: Sequence[torch.Tensor], pred: Sequence[torch.Tensor],
              inter: torch.Tensor, q_level: int):
    """The transform loop (RTL:1924-2357): cur (y, u, v) 4:2:0 uint8 planes,
    pred the (nby, nbx, bs, bs) predictions.  Returns (zig-zag coefficients
    (nby, nbx, 6, 64) int64, the recon planes (y, u, v) uint8)."""
    nby, nbx = inter.shape
    cur_t = _tiles(_blocks(cur[0], 16), _blocks(cur[1], 8), _blocks(cur[2], 8))
    pred_t = _tiles(*pred)
    inter_t = inter.reshape(-1).repeat_interleave(6)
    q = quantize(fdct((cur_t - pred_t).reshape(-1, 8, 8)), inter_t, q_level)
    recon = (pred_t + idct(dequantize(q, inter_t, q_level)).reshape(nby, nbx, 6, 8, 8)) \
        .clamp(0, 255)
    ry = recon[:, :, :4].reshape(nby, nbx, 2, 2, 8, 8).permute(0, 1, 2, 4, 3, 5) \
        .reshape(nby, nbx, 16, 16)
    zig = q.reshape(nby, nbx, 6, 64)[..., _table("zigzag_inv", q.device)]
    return zig, (_plane(ry), _plane(recon[:, :, 4]), _plane(recon[:, :, 5]))


# ---------------------------------------------------------------- symbols
def _ac_symbol(v: torch.Tensor, run: torch.Tensor):
    """put_AC (RTL:2525-2547) for v != 0: (code, length)."""
    dev = v.device
    r, a = run.clamp(max=32), (v.abs() - 1).clamp(max=40)
    valid = _table("ac_valid", dev)[r, a]
    code = (_table("ac_code", dev)[r, a] << 1) | (v < 0).to(torch.int64)
    esc = (1 << 18) | (run << 12) | (v & 0xFFF)
    return torch.where(valid, code, esc), torch.where(valid, _table("ac_len", dev)[r, a] + 1, 24)


def _shift_row(pub: torch.Tensor) -> torch.Tensor:
    """The previous macroblock's value along each slice row, 0 at its start."""
    return torch.cat([torch.zeros_like(pub[:, :1]), pub[:, :-1]], dim=1)


def macroblock_symbols(zig: torch.Tensor, inter: torch.Tensor, mvx: torch.Tensor,
                       mvy: torch.Tensor, is_p: bool):
    """(codes, lengths) (nby, nbx, 394) of every macroblock: type, mv x, mv y,
    cbp, then per tile DC, 63 AC and EOB (RTL:2722-2834)."""
    nby, nbx = inter.shape
    dev = zig.device
    intra = ~inter
    nz = intra[:, :, None] | (zig != 0).any(-1)                    # (nby, nbx, 6)
    cbp = sum(nz[..., t].to(torch.int64) << (5 - t) for t in range(6))
    cbp0 = inter & (cbp == 0)
    intra_p = intra & torch.tensor(is_p, device=dev)
    type_code = torch.where(intra_p, 0x23, torch.where(cbp0, 0x09, 0x03))
    type_len = torch.where(intra_p, 6, torch.where(cbp0, 4, 2))

    def mv_symbol(mv):
        pred = _shift_row(torch.where(inter, mv, 0))
        dmv = ((mv - pred + 16) & 31) - 16
        s = (dmv != 0).to(torch.int64)
        code = (_table("mv_code", dev)[dmv.abs()] << s) | (dmv < 0).to(torch.int64)
        return code, torch.where(inter, _table("mv_len", dev)[dmv.abs()] + s, 0)
    mvx_code, mvx_len = mv_symbol(mvx)
    mvy_code, mvy_len = mv_symbol(mvy)
    cbp_code = _table("cbp_code", dev)[cbp]
    cbp_len = torch.where(inter, _table("cbp_len", dev)[cbp], 0)

    # DC: intra differentials along the slice row (RTL:2781-2821)
    dc = zig[..., 0]
    pub = torch.where(inter[:, :, None], 0, dc)
    pred_dc = torch.cat([_shift_row(pub[..., :4].reshape(nby, nbx * 4)).reshape(nby, nbx, 4),
                         _shift_row(pub[..., 4])[..., None],
                         _shift_row(pub[..., 5])[..., None]], dim=-1)
    diff = dc - pred_dc
    mag = diff.abs()
    vallen = sum((mag >= (1 << k)).to(torch.int64) for k in range(12))
    val = diff & 0xFFF
    val = torch.where(diff < 0, (val + (1 << vallen) - 1) & 0xFFF, val)
    val = val & ((1 << vallen) - 1)
    luma = (torch.arange(6, device=dev) < 4)[None, None, :]
    size_code = torch.where(luma, _table("dcy_code", dev)[vallen], _table("dcuv_code", dev)[vallen])
    size_len = torch.where(luma, _table("dcy_len", dev)[vallen], _table("dcuv_len", dev)[vallen])
    # inter DC: 0 emits nothing (and counts as run), +-1 the 2-bit '1s',
    # else put_AC(v, 0)
    ac_code, ac_len = _ac_symbol(torch.where(dc == 0, 1, dc), torch.zeros_like(dc))
    one = dc.abs() == 1
    dc_code = torch.where(inter[:, :, None], torch.where(one, 2 | (dc < 0).to(torch.int64), ac_code),
                          (size_code << vallen) | val)
    dc_len = torch.where(inter[:, :, None], torch.where(dc == 0, 0, torch.where(one, 2, ac_len)),
                         size_len + vallen)

    # AC run/levels: position 0 counts as a nonzero where it emitted
    k = torch.arange(64, device=dev)
    z = torch.cat([(intra[:, :, None] | (dc != 0))[..., None].to(torch.int64), zig[..., 1:]], -1)
    prev_nz = torch.where(z != 0, k, -1).cummax(dim=-1).values
    run = k - torch.cat([torch.full_like(prev_nz[..., :1], -1), prev_nz[..., :-1]], -1) - 1
    acc, acl = _ac_symbol(torch.where(z == 0, 1, z), run)
    acl = torch.where(z == 0, 0, acl)

    tile_code = torch.cat([dc_code[..., None], acc[..., 1:], torch.full_like(dc[..., None], 2)], -1)
    tile_len = torch.cat([dc_len[..., None], acl[..., 1:], 2 * nz[..., None].to(torch.int64)], -1)
    head_code = torch.stack([type_code, mvx_code, mvy_code, cbp_code], -1)
    head_len = torch.stack([type_len, mvx_len, mvy_len, cbp_len], -1)
    return (torch.cat([head_code, tile_code.reshape(nby, nbx, 390)], -1),
            torch.cat([head_len, tile_len.reshape(nby, nbx, 390)], -1))


def header_symbols(i_frame: int, frame_no: int):
    """(codes, lengths) of the GOP header row and the picture header row
    (RTL:2650-2698): 7 symbols each; a P-frame's GOP row is empty.  The
    timecode counts 24 frames a second."""
    is_p = int(i_frame != 0)
    hour = min(frame_no // (24 * 3600), 63)
    minute = (frame_no // (24 * 60)) % 60
    second = (frame_no // 24) % 60
    insec = frame_no % 24
    gop = ([1, 0xB8, hour, minute, 64 + second, insec, 2],
           [0] * 7 if is_p else [24, 8, 6, 6, 7, 6, 2])
    pic = ([1, i_frame, 0x10000 * (1 + is_p), 0x380 * is_p, 1, 0xB58111, 0x1BC000],
           [24, 18, 19, 11 if is_p else 3, 24, 24, 24])
    return gop, pic


def pack_rows(rows: List[Tuple[torch.Tensor, torch.Tensor]]) -> bytes:
    """Rows of (codes, lengths) symbols -> the bytes: each row MSB first and
    padded with zeros to a byte (RTL:2940-2943), the rows one after another."""
    dev = rows[0][0].device
    codes = torch.cat([c.reshape(-1) for c, _ in rows])
    lens = torch.cat([n.reshape(-1) for _, n in rows])
    row_of = torch.cat([torch.full((c.numel(),), i, dtype=torch.int64, device=dev)
                        for i, (c, _) in enumerate(rows)])
    row_bits = torch.zeros(len(rows), dtype=torch.int64, device=dev).index_add_(0, row_of, lens)
    aligned = (row_bits + 7) & ~7
    row_start = aligned.cumsum(0) - aligned
    within = lens.cumsum(0) - lens - (row_bits.cumsum(0) - row_bits)[row_of]
    off = row_start[row_of] + within
    total = int(aligned.sum())
    keep = lens > 0
    val = (codes & ((1 << lens) - 1))[keep]
    nb, off = lens[keep], off[keep]
    words = torch.zeros(total // 32 + 2, dtype=torch.int64, device=dev)
    word = off >> 5
    end = (off & 31) + nb                                         # <= 63
    hi = torch.where(end <= 32, val << (32 - end).clamp(min=0), val >> (end - 32).clamp(min=0))
    lo = torch.where(end > 32, (val << (64 - end).clamp(max=31)) & 0xFFFFFFFF, 0)
    words.index_add_(0, word, hi)
    words.index_add_(0, word + 1, lo)
    return words.cpu().numpy().astype(">u4").tobytes()[:total // 8]


def _put(bits: List[Tuple[int, int]]) -> bytes:
    """(value, nbits) chunks MSB first, zero-padded to a byte."""
    acc, n = 0, 0
    for v, k in bits:
        acc, n = (acc << k) | (v & ((1 << k) - 1)), n + k
    pad = -n % 8
    return (acc << pad).to_bytes((n + pad) // 8, "big")


def sequence_header(width: int, height: int) -> bytes:
    """Sequence header, sequence extension and display extension
    (RTL:2598-2617): 24 frames a second, 4:2:0, progressive."""
    return _put([(0x000001, 24), (0xB3, 8), ((width << 12) | height, 24),
                 (0x1209C4, 24), (0x200000, 24), (0x0001B5, 24), (0x144200, 24),
                 (0x010000, 24), (0x000001, 24), (0xB52305, 24), (0x0505, 16),
                 (width, 14), (1, 1), (height, 14)])


SEQUENCE_END = b"\x00\x00\x01\xb7"


def sequence_end(stream_len: int) -> bytes:
    """The end code and the zero padding that ends a sequence of
    ``stream_len`` bytes: the whole stream is the next multiple of 32 bytes,
    one more 32 bytes where it is one already (RTL:2932-2937)."""
    n = stream_len + len(SEQUENCE_END)
    return SEQUENCE_END + b"\x00" * ((n // 32 + 1) * 32 - n)


class Reference:
    """The reference encoder of one sequence geometry and set of knobs."""

    def __init__(self, width: int, height: int, *, yr: int, q_level: int,
                 pframes_count: int, device):
        self.width, self.height = width, height
        self.yr, self.q_level, self.pframes_count = yr, q_level, pframes_count
        self.device = torch.device(device)

    def frame(self, planes, prev, i_frame: int, frame_no: int):
        """One frame: (y, u, v) 4:4:4 uint8 planes and the previous recon
        (y, u, v) 4:2:0 -> (its bytes, its recon)."""
        y, u, v = (torch.as_tensor(p).to(self.device) for p in planes)
        cur = (y, subsample(u), subsample(v))
        inter, mvx, mvy, *pred = motion(cur[0], *prev, i_frame == 0, self.yr)
        zig, recon = transform(cur, pred, inter, self.q_level)
        mb_code, mb_len = macroblock_symbols(zig, inter, mvx, mvy, i_frame != 0)
        nby = inter.shape[0]
        y16 = torch.arange(nby, dtype=torch.int64, device=self.device)
        slice_code = torch.stack([torch.ones_like(y16), y16 + 1,
                                  torch.full_like(y16, 2 << self.q_level)], 1)
        slice_len = torch.tensor([24, 8, 6], dtype=torch.int64,
                                 device=self.device).expand(nby, 3)
        rows = [tuple(torch.tensor(x, dtype=torch.int64, device=self.device) for x in r)
                for r in header_symbols(i_frame, frame_no)]
        rows += [(torch.cat([slice_code[r], mb_code[r].reshape(-1)]),
                  torch.cat([slice_len[r], mb_len[r].reshape(-1)])) for r in range(nby)]
        return pack_rows(rows), recon

    def gop_position(self, frame_no: int) -> int:
        return frame_no % (self.pframes_count + 1)

    def frames(self, source, first: int, stop: int) -> List[bytes]:
        """The bytes of frames [first, stop) of a sequence whose frame k is
        ``source(k)``: encoded from the I-frame that starts first's GOP."""
        start = first - self.gop_position(first)
        zero = torch.zeros((self.height, self.width), dtype=torch.uint8, device=self.device)
        zc = torch.zeros((self.height // 2, self.width // 2), dtype=torch.uint8,
                         device=self.device)
        prev, out = (zero, zc, zc), []
        for k in range(start, stop):
            data, prev = self.frame(source(k), prev, self.gop_position(k), k)
            if k >= first:
                out.append(data)
        return out
