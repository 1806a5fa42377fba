"""The golden model's functions that the conformance decoder (golden/decoder.py)
and the decode command line (cli/decode.py) use, copied from the JAX package's
golden/encoder.py, the bit-exact NumPy model of the MPEG-2 encoder: 4:2:0
subsampling, the prediction of one macroblock, the inverse quantiser, the
fixed-point Chen-Wang inverse DCT and the reconstruction clip.  Every
arithmetic step reproduces the reference datapath (RTL/mpeg2encoder.v)
exactly.  NumPy only.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..config import EncoderConfig
from ..core import tables as T

# ---------------------------------------------------------------------------
# arithmetic helpers (RTL/mpeg2encoder.v:750-801)
# ---------------------------------------------------------------------------

def mean2(a, b):
    """(1 + a + b) >> 1  (RTL/mpeg2encoder.v:750-757)."""
    return (1 + a.astype(np.int32) + b.astype(np.int32)) >> 1


def mean4(a, b, c, d):
    """(1 + a + b + c + d) >> 2  (RTL/mpeg2encoder.v:760-767) - note +1, not +2."""
    return (1 + a.astype(np.int32) + b.astype(np.int32)
            + c.astype(np.int32) + d.astype(np.int32)) >> 2


def subsample_420(Y: np.ndarray, U: np.ndarray, V: np.ndarray):
    """4:4:4 -> 4:2:0: horizontal mean2 of column pairs then vertical mean2 of row
    pairs, each with +1 rounding (stages A-C, RTL/mpeg2encoder.v:1086-1171).
    This is mean2-of-mean2, NOT a single mean4."""
    Uh = mean2(U[:, 0::2], U[:, 1::2])
    Vh = mean2(V[:, 0::2], V[:, 1::2])
    U420 = mean2(Uh[1::2], Uh[0::2]).astype(np.uint8)   # cur (odd) row with prev row
    V420 = mean2(Vh[1::2], Vh[0::2]).astype(np.uint8)
    return Y.copy(), U420, V420


def halfpel_grid(w: np.ndarray) -> np.ndarray:
    """Half-pel interpolation grid of an (n, n) full-pel window -> (2n-1, 2n-1),
    G[2a, 2b] = w[a, b], odd positions mean2/mean4 (RTL/mpeg2encoder.v:1746-1752)."""
    n = w.shape[0]
    g = np.zeros((2 * n - 1, 2 * n - 1), dtype=np.int32)
    g[0::2, 0::2] = w
    g[0::2, 1::2] = mean2(w[:, :-1], w[:, 1:])
    g[1::2, 0::2] = mean2(w[:-1, :], w[1:, :])
    g[1::2, 1::2] = mean4(w[:-1, :-1], w[:-1, 1:], w[1:, :-1], w[1:, 1:])
    return g


# ---------------------------------------------------------------------------
# motion estimation + prediction (stages X/Y/Z/F, RTL/mpeg2encoder.v:1310-1918)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MacroblockDecision:
    inter: bool
    mvx: int          # final motion vector, half-pel units (5-bit signed domain)
    mvy: int


def predict_block(
    cfg: EncoderConfig,
    dec: MacroblockDecision,
    prev_y_pad: np.ndarray, prev_u_pad: np.ndarray, prev_v_pad: np.ndarray,
    by: int, bx: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Prediction tiles (PREDICT, RTL:1891-1917).  Intra => constant 128."""
    if not dec.inter:
        return (np.full((16, 16), 128, np.int32), np.full((8, 8), 128, np.int32),
                np.full((8, 8), 128, np.int32))
    yr, ur = cfg.yr, cfg.ur
    padl, padc = yr + 1, ur + 1
    fy, fx = dec.mvy >> 1, dec.mvx >> 1          # full-pel part via arithmetic shift
    hy, hx = dec.mvy - (fy << 1), dec.mvx - (fx << 1)
    # luma: half-pel sample at (2y + mvy, 2x + mvx) in half-pel coords
    base_y, base_x = by * 16 + padl, bx * 16 + padl
    w2 = prev_y_pad[base_y + fy - 1: base_y + fy + 17,
                    base_x + fx - 1: base_x + fx + 17].astype(np.int32)
    g = halfpel_grid(w2)
    ypred = g[2 + hy: 2 + hy + 31: 2, 2 + hx: 2 + hx + 31: 2].copy()

    # chroma: full-pel offset = mv >>> 2, half flags = (mv >>> 1) & 1 (RTL:1854-1916)
    cfy, cfx = dec.mvy >> 2, dec.mvx >> 2
    chy, chx = (dec.mvy >> 1) & 1, (dec.mvx >> 1) & 1
    assert -ur <= cfy <= ur and -ur <= cfx <= ur, "chroma shift saturation unreachable"
    cy0, cx0 = by * 8 + padc + cfy, bx * 8 + padc + cfx
    out = []
    for plane in (prev_u_pad, prev_v_pad):
        w = plane[cy0: cy0 + 9, cx0: cx0 + 9].astype(np.int32)
        if chy and chx:
            p = mean4(w[:8, :8], w[:8, 1:9], w[1:9, :8], w[1:9, 1:9])
        elif chx:
            p = mean2(w[:8, :8], w[:8, 1:9])
        elif chy:
            p = mean2(w[:8, :8], w[1:9, :8])
        else:
            p = w[:8, :8].copy()
        out.append(p)
    return ypred, out[0], out[1]


def dequantize(q: np.ndarray, inter: bool, q_level: int) -> np.ndarray:
    """Stage-H inverse quantiser (RTL:2128-2150)."""
    x = q.astype(np.int64)
    if inter:
        x = x * 2
        x = x + np.sign(x)
        x = x << q_level
        x = np.clip(x, -2047, 2047)
    else:
        w = T.INTRA_Q.astype(np.int64)
        x = x * w
        if q_level >= 3:
            x = x << (q_level - 3)
        else:
            x = x >> (3 - q_level)      # arithmetic shift (floor)
        x = np.clip(x, -2047, 2047)
        x = x.copy()
        x[0, 0] = q[0, 0] * 2           # intra DC: x = q*2 (RTL:2146)
    return x.astype(np.int32)


# ---------------------------------------------------------------------------
# fixed-point Chen-Wang inverse DCT (RTL:843-972, stages H/J/K/M)
# ---------------------------------------------------------------------------

def _trunc(v: np.ndarray, bits: int) -> np.ndarray:
    m = (1 << bits) - 1
    s = 1 << (bits - 1)
    return ((v & m) ^ s) - s


def idct(iq: np.ndarray) -> np.ndarray:
    """Row pass then column pass, exact truncations; output clipped to +-255.

    All intermediates are 32-bit (the RTL's regs are [31:0]) and WRAP on extreme
    inputs - int32 two's-complement arithmetic reproduces that exactly."""
    old = np.seterr(over="ignore")
    try:
        return _idct_i32(iq)
    finally:
        np.seterr(**old)


def _idct_i32(iq: np.ndarray) -> np.ndarray:
    a = iq.astype(np.int32)
    # --- rows (invserse_dct_rows_step12/34) ---
    x0, x1, x2, x3 = a[:, 0], a[:, 4], a[:, 6], a[:, 2]
    x4, x5, x6, x7 = a[:, 1], a[:, 7], a[:, 5], a[:, 3]
    x0 = (x0 << 11) | 128                   # +128 rounding bit (RTL:859)
    x1 = x1 << 11
    x8 = T.W7 * (x4 + x5)
    x4 = x8 + (T.W1 - T.W7) * x4
    x5 = x8 - (T.W1 + T.W7) * x5
    x8 = T.W3 * (x6 + x7)
    x6 = x8 - (T.W3 - T.W5) * x6
    x7 = x8 - (T.W3 + T.W5) * x7
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = T.W6 * (x3 + x2)
    x2 = x1 - (T.W2 + T.W6) * x2
    x3 = x1 + (T.W2 - T.W6) * x3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    rows = np.stack([(x7 + x1) >> 8, (x3 + x2) >> 8, (x0 + x4) >> 8, (x8 + x6) >> 8,
                     (x8 - x6) >> 8, (x0 - x4) >> 8, (x3 - x2) >> 8, (x7 - x1) >> 8],
                    axis=1)
    rows = _trunc(rows, 18)                 # r0..r7 are 18-bit regs (RTL:886)
    # --- columns (invserse_dct_cols_step12/34) ---
    b = rows
    x0, x1, x2, x3 = b[0], b[4], b[6], b[2]
    x4, x5, x6, x7 = b[1], b[7], b[5], b[3]
    x0 = (x0 << 8) + 8192
    x1 = x1 << 8
    x8 = T.W7 * (x4 + x5) + 4
    x4 = (x8 + (T.W1 - T.W7) * x4) >> 3
    x5 = (x8 - (T.W1 + T.W7) * x5) >> 3
    x8 = T.W3 * (x6 + x7) + 4
    x6 = (x8 - (T.W3 - T.W5) * x6) >> 3
    x7 = (x8 - (T.W3 + T.W5) * x7) >> 3
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = T.W6 * (x3 + x2) + 4
    x2 = (x1 - (T.W2 + T.W6) * x2) >> 3
    x3 = (x1 + (T.W2 - T.W6) * x3) >> 3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    cols = np.stack([(x7 + x1) >> 14, (x3 + x2) >> 14, (x0 + x4) >> 14, (x8 + x6) >> 14,
                     (x8 - x6) >> 14, (x0 - x4) >> 14, (x3 - x2) >> 14, (x7 - x1) >> 14],
                    axis=0)
    return np.clip(cols, -255, 255).astype(np.int32)


def add_clip(pred: np.ndarray, resid: np.ndarray) -> np.ndarray:
    return np.clip(pred + resid, 0, 255).astype(np.uint8)

