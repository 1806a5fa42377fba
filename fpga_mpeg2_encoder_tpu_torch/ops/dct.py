"""Forward DCT, quantise, dequantise and inverse DCT on (N, 8, 8) tiles: the
plain PyTorch version of the transform kernel (ops/kernels/transform.py).

Exactness:
* The stage-G DCT (RTL/mpeg2encoder.v:2025-2062) keeps phase 1 at full
  precision and rounds once after phase 2: round(M @ X @ M^T / 4096) with a
  17-bit wrap.  The products run as broadcast multiply + sum over the 8 taps
  in int64 - not an integer matmul, which has no CUDA kernel in torch - so
  this version also runs on the card, where the transform kernel is held to it.
* The quantisers (RTL:2064-2077, 2128-2150) keep the 16-bit wraps as masks;
  the intra division by the quantiser matrix is integer floor division.
* The inverse DCT is the fixed-point Chen-Wang pipeline (RTL:843-972) with its
  18-bit row truncations.  The reference registers are 32 bits wide and wrap
  (golden/encoder.py `_idct_i32`); here the arithmetic runs in int64 and is
  wrapped to int32 right before every right shift and the final clip, the only
  operations whose result depends on the bits above 32.
"""
from __future__ import annotations

import torch

from ..core import tables as T

W1, W2, W3, W5, W6, W7 = T.W1, T.W2, T.W3, T.W5, T.W6, T.W7


def _blockify(plane: torch.Tensor, bs: int) -> torch.Tensor:
    h, w = plane.shape
    return plane.reshape(h // bs, bs, w // bs, bs).permute(0, 2, 1, 3)


def _unblockify(blocks: torch.Tensor) -> torch.Tensor:
    nby, nbx, bs, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(nby * bs, nbx * bs)


def _tiles(yb: torch.Tensor, ub: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """(nby,nbx,16,16)+(nby,nbx,8,8)x2 -> (nby,nbx,6,64) in tile order Y00..Y11,U,V."""
    nby, nbx = yb.shape[:2]
    yt = yb.reshape(nby, nbx, 2, 8, 2, 8).permute(0, 1, 2, 4, 3, 5) \
        .reshape(nby, nbx, 4, 64)
    return torch.cat([yt, ub.reshape(nby, nbx, 1, 64),
                      vb.reshape(nby, nbx, 1, 64)], dim=2)


def _untile_y(t4: torch.Tensor) -> torch.Tensor:
    nby, nbx = t4.shape[:2]
    return t4.reshape(nby, nbx, 2, 2, 8, 8).permute(0, 1, 2, 4, 3, 5) \
        .reshape(nby, nbx, 16, 16)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int64, device=like.device)


def fdct(x: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) residual tiles (|x| <= 255) -> (N, 8, 8) int64 stage-G DCT."""
    m = _const(T.DCTM, x)
    x = x.to(torch.int64)
    s1 = (m[None, :, :, None] * x[:, None, :, :]).sum(2)          # M @ X
    t = (s1[:, :, None, :] * m[None, None, :, :]).sum(-1)         # ... @ M^T
    r = (t >> 12) + ((t >> 11) & 1)
    return ((r & 0x1FFFF) ^ 0x10000) - 0x10000                    # 17-bit wrap


def quantize(f: torch.Tensor, inter: torch.Tensor, q_level: int) -> torch.Tensor:
    """(N, 8, 8) coefficients + (N,) bool inter -> (N, 8, 8) quantised."""
    w = _const(T.INTRA_Q, f)
    a = f.abs() & 0xFFFF
    q_inter = ((a + 2) & 0xFFFF) >> (4 + q_level)
    off = (w * ((3 << q_level) + 2)) >> 3
    q_intra = torch.div(((a + off) & 0xFFFF) >> q_level, w, rounding_mode="floor")
    q_intra[:, 0, 0] = (a[:, 0, 0] >> 4) + ((a[:, 0, 0] >> 3) & 1)
    q = torch.where(inter[:, None, None], q_inter, q_intra).clamp(max=2047)
    return torch.where(f < 0, -q, q)


def dequantize(q: torch.Tensor, inter: torch.Tensor, q_level: int) -> torch.Tensor:
    """(N, 8, 8) quantised -> (N, 8, 8) reconstruction-loop coefficients."""
    x2 = q * 2
    xi = ((x2 + x2.sign()) << q_level).clamp(-2047, 2047)
    xa = q * _const(T.INTRA_Q, q)
    xa = xa << (q_level - 3) if q_level >= 3 else xa >> (3 - q_level)
    xa = xa.clamp(-2047, 2047)
    xa[:, 0, 0] = q[:, 0, 0] * 2
    return torch.where(inter[:, None, None], xi, xa)


def _cw_stage(a, rounding: bool):
    """One Chen-Wang butterfly stage on 8 int64 lanes with int32 wrap
    semantics.  rounding=False: row pass (RTL:844-905); True: column pass
    (RTL:911-970)."""
    def shr(v, s):
        return _wrap32(v) >> s if s else v
    x0, x1, x2, x3 = a[0], a[4], a[6], a[2]
    x4, x5, x6, x7 = a[1], a[7], a[5], a[3]
    if not rounding:
        x0 = (x0 << 11) | 128
        x1 = x1 << 11
        r4, sh = 0, 0
    else:
        x0 = (x0 << 8) + 8192
        x1 = x1 << 8
        r4, sh = 4, 3
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
    fs = 8 if not rounding else 14
    return [shr(x7 + x1, fs), shr(x3 + x2, fs), shr(x0 + x4, fs), shr(x8 + x6, fs),
            shr(x8 - x6, fs), shr(x0 - x4, fs), shr(x3 - x2, fs), shr(x7 - x1, fs)]


def idct(iq: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) dequantised coefficients -> (N, 8, 8) residual in [-255, 255]."""
    a = iq.to(torch.int64)
    rows = torch.stack(_cw_stage([a[:, :, k] for k in range(8)], False), dim=2)
    rows = ((rows & 0x3FFFF) ^ 0x20000) - 0x20000                 # 18-bit regs
    cols = torch.stack(_cw_stage([rows[:, k, :] for k in range(8)], True), dim=1)
    return cols.clamp(-255, 255)


def transform_recon(cur_y, cur_u, cur_v, pred_y, pred_u, pred_v,
                    inter: torch.Tensor, q_level: int):
    """The whole transform loop (RTL:1924-2357) on 4:2:0 planes.

    cur_*: (H, W) / (H/2, W/2) uint8; pred_*: uint8 planes of the same shapes;
    inter: (nby, nbx) bool.  Returns (quant_zig (nby, nbx, 6, 64) int32 in
    zig-zag order with tiles Y00, Y01, Y10, Y11, U, V; recon_y, recon_u,
    recon_v uint8 planes)."""
    h, w = cur_y.shape
    nby, nbx = h // 16, w // 16

    def tiles(y, u, v):      # widened before cur - pred: uint8 would wrap
        return _tiles(_blockify(y.to(torch.int64), 16),
                      _blockify(u.to(torch.int64), 8),
                      _blockify(v.to(torch.int64), 8))

    cur_t = tiles(cur_y, cur_u, cur_v)
    pred_t = tiles(pred_y, pred_u, pred_v)
    inter_t = inter.reshape(-1).repeat_interleave(6)
    q = quantize(fdct((cur_t - pred_t).reshape(-1, 8, 8)), inter_t, q_level)
    rres = idct(dequantize(q, inter_t, q_level))
    recon_t = (pred_t + rres.reshape(nby, nbx, 6, 64)).clamp(0, 255) \
        .to(torch.uint8)
    recon_y = _unblockify(_untile_y(recon_t[:, :, :4]))
    recon_u = _unblockify(recon_t[:, :, 4].reshape(nby, nbx, 8, 8))
    recon_v = _unblockify(recon_t[:, :, 5].reshape(nby, nbx, 8, 8))
    zig_inv = _const(T.ZIGZAG_INV, q)
    quant_zig = q.reshape(nby, nbx, 6, 64)[..., zig_inv].to(torch.int32)
    return quant_zig, recon_y, recon_u, recon_v
