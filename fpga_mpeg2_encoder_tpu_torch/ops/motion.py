"""Motion estimation + prediction over the whole macroblock grid (stages X/Y/Z/F,
RTL/mpeg2encoder.v:1310-1918), in plain PyTorch: the plain versions of the
motion-estimation kernels (ops/kernels/me.py).

The module mirrors the JAX package's split (ops/pallas/me.py): the fused
kernel's work is ``estimate_luma`` followed by ``chroma_pred``, and
``estimate_and_predict_local`` runs both on a band of macroblock rows whose
reference planes arrive with their halos (8 luma rows, 4 chroma rows each
side).  The whole-frame forms pad those halos with zeros.

All macroblocks run at once:
* full-pel: (2*yr+1)^2 shifted whole-frame absolute differences, reduced to
  16x16 block sums by integer reshape-sums;
* argmin with the exact RTL tie-break (largest dy, then largest dx among
  minima, RTL:1694-1710) via an order-encoding key, after the frame-edge and
  12-bit SAD overflow masks (RTL:1670); the top and bottom edges are GLOBAL
  macroblock rows, so a band's seams are not frame edges;
* recentring: every macroblock's 18x18 window at its own full-pel vector is
  gathered by direct indexing;
* half-pel: the mean2/mean4 grids, 9 candidate SADs and the exact
  find_min_in_10_values tournament (RTL:804-840) against the intra activity
  metric (f_Y_sum accumulation quirk included, RTL:1659-1662/1774-1791);
* prediction: luma from the selected half-pel grid; chroma via mv>>2
  full-pel offset + (mv>>1)&1 half flags (RTL:1847-1917).

Planes outside the frame read as zero, as in the reference's halo padding.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import entropy

LUMA_HALO, CHROMA_HALO = 8, 4    # reference rows above and below a band


class MotionResult(NamedTuple):
    inter: torch.Tensor      # (nby, nbx) bool
    mvx: torch.Tensor        # (nby, nbx) int32, half-pel units
    mvy: torch.Tensor        # (nby, nbx) int32
    pred_y: torch.Tensor     # (nby, nbx, 16, 16) uint8, or an (H, W) plane
    pred_u: torch.Tensor     # (nby, nbx, 8, 8) uint8, or an (H/2, W/2) plane
    pred_v: torch.Tensor


def _find_min_10(v: torch.Tensor) -> torch.Tensor:
    """Exact tournament of RTL:804-840.  v: (..., 10) -> (...) index."""
    def pick(lo, hi):
        lt = v[..., hi] < v[..., lo]
        return (torch.where(lt, v[..., hi], v[..., lo]),
                torch.where(lt, hi, lo))
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
    use89 = (w89 <= x0123) & (w89 <= x4567)
    return torch.where(use89, i89, left)


def _windows(plane_h: torch.Tensor, halo: int, bs: int, size: int,
             off_y: torch.Tensor, off_x: torch.Tensor) -> torch.Tensor:
    """(rows + 2*halo, W) plane with ``halo`` rows each side -> (nby, nbx,
    size, size) windows, window [by, bx] starting at row bs*by + off_y[by, bx],
    col bs*bx + off_x[by, bx] of the unhaloed plane, zero left and right of it
    (|off| <= halo)."""
    p = F.pad(plane_h.to(torch.int32), (halo, halo))
    nby, nbx = off_y.shape
    k = torch.arange(size, device=plane_h.device)
    by = torch.arange(nby, device=plane_h.device)[:, None, None]
    bx = torch.arange(nbx, device=plane_h.device)[None, :, None]
    rows = bs * by + off_y[:, :, None] + halo + k
    cols = bs * bx + off_x[:, :, None] + halo + k
    return p[rows[:, :, :, None], cols[:, :, None, :]]


def to_planes(t: torch.Tensor) -> torch.Tensor:
    """(nby, nbx, bs, bs) tiles -> (nby*bs, nbx*bs) plane."""
    nb_y, nb_x, bs, _ = t.shape
    return t.permute(0, 2, 1, 3).reshape(nb_y * bs, nb_x * bs)


def pad_halo(plane: torch.Tensor, halo: int) -> torch.Tensor:
    """Whole-frame plane -> the band form: ``halo`` zero rows each side."""
    return F.pad(plane, (0, 0, halo, halo))


def estimate_luma(
    cur_y: torch.Tensor,       # (Hl, W) uint8: a band of macroblock rows
    prev_y_h: torch.Tensor,    # (Hl + 16, W) uint8: recon band + 8-row halo each side
    is_iframe,                 # bool, or a 0-d bool or int tensor (nonzero: I-frame)
    yr: int,                   # luma search range
    first_mb_row: int,         # global MB row of local row 0
    total_mb_rows: int,        # global MB row count
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Luma motion estimation + prediction: the plain version of the luma
    kernel (JAX ops/pallas/me.py::_me_body).  Returns (inter (nby, nbx) bool,
    mvx, mvy (nby, nbx) int32 half-pel, pred_y (nby, nbx, 16, 16) uint8)."""
    h, w = cur_y.shape
    nby, nbx = h // 16, w // 16
    dev = cur_y.device
    n = 2 * yr + 1
    cy = cur_y.to(torch.int32)

    # ---- full-pel SAD volume: one row offset at a time, all column offsets --
    prevp = F.pad(prev_y_h[LUMA_HALO - yr:LUMA_HALO + h + yr].to(torch.int32),
                  (yr, yr))
    sads = []
    for iy in range(n):
        win = prevp[iy:iy + h].unfold(1, w, 1)                  # (h, n, w)
        d = (cy[:, None, :] - win).abs()
        sads.append(d.reshape(nby, 16, n, nbx, 16).sum((1, 4)).permute(1, 0, 2))
    sad = torch.cat(sads)                                       # (n*n, nby, nbx)

    lin_all = torch.arange(n * n, device=dev)
    dyi = (lin_all // n - yr)[:, None, None]
    dxi = (lin_all % n - yr)[:, None, None]
    col = torch.arange(nbx, device=dev)
    row = torch.arange(nby, device=dev) + first_mb_row          # global MB rows
    edge_l = (col == 0)[None, :]
    edge_r = (col == nbx - 1)[None, :]
    edge_t = (row == 0)[:, None]
    edge_b = (row == total_mb_rows - 1)[:, None]
    invalid = (edge_l & (dxi < 0)) | (edge_r & (dxi > 0)) \
        | (edge_t & (dyi < 0)) | (edge_b & (dyi > 0)) | (sad > 4095)

    # tie-break: min SAD, then largest dy, then largest dx == largest linear index
    big = 1 << 24
    key = torch.where(invalid, big, sad * (n * n) + (n * n - 1 - lin_all)[:, None, None])
    kmin = key.min(0).values
    lin = torch.where(kmin >= big, yr * n + yr, (n * n - 1) - kmin % (n * n))
    mvy_full = lin // n - yr                                    # (nby, nbx)
    mvx_full = lin % n - yr

    # ---- intra activity metric (16-bit accumulator semantics) -----------------
    blk = cy.reshape(nby, 16, nbx, 16).permute(0, 2, 1, 3)      # (nby, nbx, 16, 16)
    pixsum = blk.sum((2, 3))
    mean = (pixsum >> 8) & 0xFF
    sad_mean = (blk - mean[:, :, None, None]).abs().sum((2, 3))
    acc = (pixsum + sad_mean) & 0xFFFF
    intra_cost = torch.where(acc < 4096, acc, 0xFFF)

    # ---- recentring: every MB's 18x18 window at its own full-pel mv -----------
    w18 = _windows(prev_y_h, LUMA_HALO, 16, 18, mvy_full - 1, mvx_full - 1)
    hh = (1 + w18[..., :, :-1] + w18[..., :, 1:]) >> 1          # (.., 18, 17)
    vv = (1 + w18[..., :-1, :] + w18[..., 1:, :]) >> 1          # (.., 17, 18)
    m4 = (1 + w18[..., :-1, :-1] + w18[..., :-1, 1:]
          + w18[..., 1:, :-1] + w18[..., 1:, 1:]) >> 2          # (.., 17, 17)

    def cand_grid(hy: int, hx: int) -> torch.Tensor:
        ry, rx = (hy + 1) >> 1, (hx + 1) >> 1
        if hy == 0 and hx == 0:
            return w18[..., 1:17, 1:17]
        if hy == 0:
            return hh[..., 1:17, rx:rx + 16]
        if hx == 0:
            return vv[..., ry:ry + 16, 1:17]
        return m4[..., ry:ry + 16, rx:rx + 16]

    halves = [(hy, hx) for hy in (-1, 0, 1) for hx in (-1, 0, 1)]
    grids = [cand_grid(hy, hx) for hy, hx in halves]
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
    idx = _find_min_10(torch.stack(vals, dim=-1))              # (nby, nbx) in 0..9

    # read through torch.where, never bool(): a device flag needs no wait
    iflag = entropy.gop_scalar(is_iframe, dev) != 0
    inter = (idx != 9) & ~iflag
    hy_sel = torch.where(idx == 9, 0, idx // 3 - 1)
    hx_sel = torch.where(idx == 9, 0, idx % 3 - 1)
    # P-frame: mv registers always updated even when intra wins (RTL:1827-1828);
    # I-frame: forced zero (RTL:1820-1825).
    mvy = torch.where(iflag, 0, mvy_full * 2 + hy_sel).to(torch.int32)
    mvx = torch.where(iflag, 0, mvx_full * 2 + hx_sel).to(torch.int32)

    # ---- luma prediction: selected half-pel grid, or 128 for intra ------------
    # (computed in int32; every value is 0..255, so the uint8 cast is exact)
    pred_y = torch.full((nby, nbx, 16, 16), 128, dtype=torch.int32, device=dev)
    for i9, g in enumerate(grids):
        pred_y = torch.where((inter & (idx == i9))[:, :, None, None], g, pred_y)
    return inter, mvx, mvy, pred_y.to(torch.uint8)


def _chroma_plane(plane_h: torch.Tensor, inter: torch.Tensor,
                  mvx: torch.Tensor, mvy: torch.Tensor) -> torch.Tensor:
    hyb = (((mvy >> 1) & 1) > 0)[:, :, None, None]
    hxb = (((mvx >> 1) & 1) > 0)[:, :, None, None]
    w9 = _windows(plane_h, CHROMA_HALO, 8, 9, mvy >> 2, mvx >> 2)
    p00 = w9[..., :8, :8]
    ph = (1 + p00 + w9[..., :8, 1:9]) >> 1
    pv = (1 + p00 + w9[..., 1:9, :8]) >> 1
    pm = (1 + p00 + w9[..., :8, 1:9] + w9[..., 1:9, :8] + w9[..., 1:9, 1:9]) >> 2
    p = torch.where(hyb & hxb, pm, torch.where(hxb, ph, torch.where(hyb, pv, p00)))
    return torch.where(inter[:, :, None, None], p, 128).to(torch.uint8)


def chroma_pred(prev_u_h: torch.Tensor, prev_v_h: torch.Tensor,
                inter: torch.Tensor, mvx: torch.Tensor, mvy: torch.Tensor,
                ur: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chroma prediction, the plain version of the chroma kernel (JAX
    ops/pallas/me.py::_chroma_predict): the luma mv halved with the
    arithmetic shift, mv>>2 full-pel plus the (mv>>1)&1 half flags, and its
    own half-pel interpolation (RTL:1847-1917).  prev_*_h: (Hl/2 + 8, W/2)
    uint8 with a 4-row halo each side -> (pred_u, pred_v) (nby, nbx, 8, 8)
    uint8.  ``ur`` bounds mv>>2 and needs no other use here."""
    del ur
    return (_chroma_plane(prev_u_h, inter, mvx, mvy),
            _chroma_plane(prev_v_h, inter, mvx, mvy))


def estimate_and_predict_local(
    cur_y: torch.Tensor,       # (Hl, W) uint8: a band of macroblock rows
    prev_y_h: torch.Tensor,    # (Hl + 16, W): recon band + 8-row halo each side
    prev_u_h: torch.Tensor,    # (Hl/2 + 8, W/2): + 4-row halo
    prev_v_h: torch.Tensor,
    is_iframe,                 # bool, or a 0-d bool or int tensor (nonzero: I-frame)
    yr: int,
    ur: int,
    first_mb_row: int,         # global MB row of local row 0
    total_mb_rows: int,        # global MB row count
    as_planes: bool = False,   # pred as pixel planes (the transform kernel's form)
) -> MotionResult:
    """Band-local motion estimation for slice-row sharding: the whole-frame
    math on a band whose reference halos were already exchanged, with
    frame-edge masking on GLOBAL rows (JAX ops/motion.py:213-262).  The
    plain version of the fused kernel: estimate_luma, then chroma_pred."""
    inter, mvx, mvy, pred_y = estimate_luma(cur_y, prev_y_h, is_iframe, yr,
                                            first_mb_row, total_mb_rows)
    pred_u, pred_v = chroma_pred(prev_u_h, prev_v_h, inter, mvx, mvy, ur)
    if as_planes:
        pred_y, pred_u, pred_v = to_planes(pred_y), to_planes(pred_u), to_planes(pred_v)
    return MotionResult(inter, mvx, mvy, pred_y, pred_u, pred_v)


def estimate_and_predict(
    cur_y: torch.Tensor,       # (H, W) uint8 current luma
    cur_u: torch.Tensor,       # (H/2, W/2) uint8 (unused: the RTL searches luma)
    cur_v: torch.Tensor,
    prev_y: torch.Tensor,      # previous recon planes, uint8
    prev_u: torch.Tensor,
    prev_v: torch.Tensor,
    is_iframe: bool,
    yr: int,                   # luma search range
    ur: int,                   # chroma search range
) -> MotionResult:
    """The whole frame as one band: zero halos, global rows 0..nby-1."""
    return estimate_and_predict_local(
        cur_y, pad_halo(prev_y, LUMA_HALO), pad_halo(prev_u, CHROMA_HALO),
        pad_halo(prev_v, CHROMA_HALO), is_iframe, yr, ur, 0, cur_y.shape[0] // 16)


def estimate_and_predict_planes(
    cur_y, cur_u, cur_v, prev_y, prev_u, prev_v, is_iframe: bool, yr: int, ur: int,
) -> MotionResult:
    """As estimate_and_predict, but pred_y/pred_u/pred_v are PIXEL PLANES
    ((H, W) / (H/2, W/2) uint8), the form the transform stage consumes."""
    mr = estimate_and_predict(cur_y, cur_u, cur_v, prev_y, prev_u, prev_v,
                              is_iframe, yr, ur)
    return mr._replace(pred_y=to_planes(mr.pred_y), pred_u=to_planes(mr.pred_u),
                       pred_v=to_planes(mr.pred_v))
