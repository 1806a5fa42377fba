"""4:4:4 -> 4:2:0 subsample kernel (csrc/subsample.cu): both chroma planes
in one launch, two mean2 reductions (horizontal pairs, then vertical pairs),
each with its own +1 rounding.

Replaces the JAX package's ops/colorspace.py::subsample_420 (plain XLA code
of its jitted frame step, one fused elementwise pass there; not a Pallas
kernel).  On the card it is bound by device memory traffic: 4.4 MB in and
1.1 MB out at 1920x1152, 1.65 us at 3.35 TB/s.  A thread reads 16 bytes of
two adjacent rows and writes 8 output bytes; the planes must be contiguous
with 16-byte aligned data and a width that is a multiple of 16, as every
frame's are.  On CPU tensors the plain version ops/colorspace.py::
subsample_420 runs instead.
"""
from __future__ import annotations

import torch

from .. import colorspace
from . import _build


def subsample_420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(H, W) uint8 4:4:4 planes -> (y, u420, v420) with u420 and v420
    contiguous (H/2, W/2) uint8; y is returned as it is."""
    if _build.on_cpu(y, u, v):
        return colorspace.subsample_420(y, u, v)
    h, w = u.shape
    if h % 2 or w % 16:
        raise ValueError(f"chroma planes {h}x{w}: need an even height and a width that "
                         f"is a multiple of 16")
    _build.check(u, "u", torch.uint8, (h, w), align=16)
    _build.check(v, "v", torch.uint8, (h, w), align=16)
    uo = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=u.device)
    vo = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=u.device)
    _build.launch("mpeg2_subsample", "subsample", u.device, u, v, uo, vo, h // 2, w)
    return y, uo, vo
