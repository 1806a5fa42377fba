"""Transform kernel (csrc/transform.cu): residual, forward DCT, quantise,
dequantise, Chen-Wang IDCT and reconstruction of a whole frame, with the
quantised coefficients written in zig-zag tile-major order.

Replaces ops/pallas/transform.py::transform_recon_pallas of the JAX package.
Per macroblock it moves 2.7 KB through device memory (384 pixels and 384
uint8 predictions in, 384 int32 coefficients and 384 pixels out) for a few
thousand integer operations: at 1920x1152 that is 23 MB, about 7 us at the
H100's 3.35 TB/s, so device memory bounds it.  The kernel runs 8 threads per
8x8 tile in every phase, 8 macroblocks per block, with 8-byte pixel loads
and stores, the tile turned between passes in shared memory within a warp,
a multiply in place of the intra division, and the coefficients written in
16-byte stores.  The recon goes to new planes, or in place into planes the
caller gives (``out``: the compiled gop program's reference planes).  On CPU
tensors the plain version ops/dct.py::transform_recon runs instead.

``transform_stage`` runs one stage of the kernel's own device code on int32
tiles of any value: the tests reach through it the wraps and clamps that
pixel input never reaches.  It is off every path and has no launch count.
"""
from __future__ import annotations

import torch

from .. import dct
from . import _build

STAGES = ("fdct", "quantize", "idct")


def transform_recon(cur_y, cur_u, cur_v, pred_y, pred_u, pred_v,
                    inter: torch.Tensor, q_level: int, out=None):
    """cur_*: (H, W) / (H/2, W/2) uint8; pred_*: uint8 planes of the same
    shapes; inter: (H/16, W/16) bool.  Returns (quant_zig (nby, nbx, 6, 64)
    int32, recon_y, recon_u, recon_v uint8).  ``out``: three uint8 planes of
    the recon's shapes, none of them an input, that the reconstruction is
    written into in place and returned as (the compiled gop program's
    reference planes); by default new tensors."""
    args = (cur_y, cur_u, cur_v, pred_y, pred_u, pred_v, inter)
    if out is not None:
        out = tuple(out)
        if any(o.data_ptr() == a.data_ptr() for o in out for a in args):
            raise ValueError("out: a recon plane must not be an input of the transform")
    if _build.on_cpu(*args, *(out or ())):
        qzig, *recon = dct.transform_recon(*args, q_level)
        if out is None:
            return (qzig, *recon)
        for dst, src in zip(out, recon):
            dst.copy_(src)
        return (qzig, *out)
    h, w = cur_y.shape
    if h % 16 or w % 16:
        raise ValueError(f"frame {h}x{w} is not a multiple of 16")
    nby, nbx = h // 16, w // 16
    for t, name, shape in (
            (cur_y, "cur_y", (h, w)),
            (cur_u, "cur_u", (h // 2, w // 2)),
            (cur_v, "cur_v", (h // 2, w // 2)),
            (pred_y, "pred_y", (h, w)),
            (pred_u, "pred_u", (h // 2, w // 2)),
            (pred_v, "pred_v", (h // 2, w // 2))):
        _build.check(t, name, torch.uint8, shape, align=8)    # 8-byte row loads
    _build.check(inter, "inter", torch.bool, (nby, nbx))
    dev = cur_y.device
    qzig = torch.empty((nby, nbx, 6, 64), dtype=torch.int32, device=dev)
    if out is None:
        out = (torch.empty((h, w), dtype=torch.uint8, device=dev),
               *(torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
                 for _ in range(2)))
    for t, name, shape in zip(out, ("out_y", "out_u", "out_v"),
                              ((h, w), (h // 2, w // 2), (h // 2, w // 2))):
        _build.check(t, name, torch.uint8, shape, align=8)    # 8-byte row stores
    ry, ru, rv = out
    _build.launch("mpeg2_transform", "transform", dev, *args,
                  qzig, ry, ru, rv, nby, nbx, q_level)
    return qzig, ry, ru, rv


def transform_stage(stage: str, x: torch.Tensor, inter=None, q_level: int = 1):
    """One stage of the transform kernel on (N, 8, 8) int32 tiles: "fdct"
    -> the FDCT; "quantize" -> (quantised, dequantised), with inter (N,)
    bool; "idct" -> the IDCT.  On CPU tensors ops/dct.py's stages run
    instead.  Results are int32."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    if inter is None:
        inter = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    if _build.on_cpu(x, inter):
        if stage == "fdct":
            return dct.fdct(x).to(torch.int32)
        if stage == "idct":
            return dct.idct(x).to(torch.int32)
        q = dct.quantize(x.to(torch.int64), inter, q_level)
        return q.to(torch.int32), dct.dequantize(q, inter, q_level).to(torch.int32)
    n = x.shape[0]
    _build.check(x, "x", torch.int32, (n, 8, 8))
    _build.check(inter, "inter", torch.bool, (n,))
    out, out2 = torch.empty_like(x), torch.empty_like(x)
    _build.launch("mpeg2_transform_stage", None, x.device, x, inter, out, out2, n,
                  STAGES.index(stage), q_level)
    return (out, out2) if stage == "quantize" else out
