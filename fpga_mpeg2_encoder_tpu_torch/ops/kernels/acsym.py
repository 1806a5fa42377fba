"""AC symbolisation kernel (csrc/acsym.cu): run lengths, Table B.14 codes or
escapes and signs of every AC coefficient, routed into the frame's slot grid
and merged with the pre-packed non-AC slots.

Replaces ops/pallas/acsym.py::ac_slot_grid_pallas of the JAX package.  On the
card it is bound by device memory traffic (1.5 KB of coefficients and 64 B
of non-AC slots in, 1.6 KB of int32 slots out per macroblock: 27.5 MB, about
8 us at 3.35 TB/s, at 1920x1152).  A block takes 4 macroblocks; each thread
loads 4 coefficients of a tile in one 16-byte load, a tile's emit mask is a
warp reduction of its threads' nibbles, the B.14 table sits in shared
memory, and the block's slots are staged in shared memory and written as one
span in 16-byte stores.  On CPU tensors the plain version
ops/entropy.py::ac_slot_grid runs instead.
"""
from __future__ import annotations

import torch

from .. import entropy
from . import _build


def ac_slot_grid(zmod: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """zmod (nby, nbx*384) int32, small (nby, 3 + 394*nbx) int32 ->
    (nby, 3 + 394*nbx) int32 slot grid (see entropy.ac_slot_grid).  zmod's
    data must be 16-byte aligned (the kernel's vector loads)."""
    if _build.on_cpu(zmod, small):
        return entropy.ac_slot_grid(zmod, small)
    nby, width = zmod.shape
    if width % 384:
        raise ValueError(f"zmod width {width} is not a multiple of 384")
    nbx = width // 384
    s = entropy.HDR_SLOTS + entropy.SLOTS_PER_MB * nbx
    _build.check(zmod, "zmod", torch.int32, (nby, width), align=16)
    _build.check(small, "small", torch.int32, (nby, s))
    out = torch.empty((nby, s), dtype=torch.int32, device=zmod.device)
    _build.launch("mpeg2_acsym", "acsym", zmod.device, zmod, small, out, nby, nbx)
    return out
