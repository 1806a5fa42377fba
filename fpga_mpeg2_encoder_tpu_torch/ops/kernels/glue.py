"""Symbol glue kernel (csrc/glue.cu): everything of a frame's symbolisation
but the AC symbols, in one launch: the coded-block pattern, macroblock type,
motion-vector and DC differentials and EOB slots of every macroblock, the
slice headers, the acsym kernel's zmod operand and, when asked, the GOP and
picture header rows.

Replaces the non-AC part of the JAX package's ops/entropy.py::symbolize_frame
(plain XLA code of its jitted frame step, not a Pallas kernel).  On the card
it is bound by device memory traffic: 1.5 KB of coefficients in, 1.5 KB of
zmod and 1.6 KB of slots out per macroblock (40 MB, 12 us at 3.35 TB/s, at
1920x1152).  A warp takes a macroblock: every value depends only on it and
its left neighbour in the slice, so nothing is scanned.  On CPU tensors the
plain versions ops/entropy.py::ac_inputs and _header_rows run instead.

The GOP position and the frame number are 0-d int32 tensors on the card
that the kernel reads there (host ints are filled in on the card first), so
a CUDA graph replays the launch with its step's values.  The VLC tables are
entropy's cached device copies, which outlive every graph that reads them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import entropy
from . import _build

_TABLE_NAMES = ("mv", "cbp", "dcy", "dcuv", "header", "ac")
_TABLE_SIZES = (17, 64, 13, 13, 28, 144)      # csrc/glue.cu MV_N ... AC_N, 2 x 14


def _tables(dev) -> list:
    tabs = [entropy._device_table(n, dev) for n in _TABLE_NAMES]
    for t, n, size in zip(tabs, _TABLE_NAMES, _TABLE_SIZES):
        if t.dtype != torch.int64 or t.numel() != size:
            raise ValueError(f"VLC table {n}: {t.numel()} {t.dtype}, the kernel takes "
                             f"{size} int64")
    return tabs


def _gop_operand(v, dev) -> torch.Tensor:
    """A GOP position or frame number as the 0-d int32 the kernel reads."""
    t = entropy.gop_scalar(v, dev)
    return t if t.dtype == torch.int32 else t.to(torch.int32)


def _launch(dev, nby: int, nbx: int, args, i_frame, frame_no, q_level: int,
            first_row: int, header_slots: int):
    zmod = torch.empty((nby, nbx * 384), dtype=torch.int32, device=dev)
    small = torch.empty((nby, entropy.HDR_SLOTS + entropy.SLOTS_PER_MB * nbx),
                        dtype=torch.int32, device=dev)
    hdr = torch.empty((entropy.HEADER_ROWS, header_slots), dtype=torch.int32, device=dev)
    _build.launch("mpeg2_glue", "glue", dev, *args, _gop_operand(i_frame, dev),
                  _gop_operand(frame_no, dev), *_tables(dev), zmod, small, hdr,
                  nby, nbx, q_level, first_row, header_slots)
    return zmod, small, hdr


def symbol_glue(quant_zig: torch.Tensor, inter: torch.Tensor, mvx: torch.Tensor,
                mvy: torch.Tensor, i_frame, frame_no, q_level: int, first_row: int = 0,
                header_slots: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """quant_zig (nby, nbx, 6, 64) int32 (16-byte aligned: the kernel's
    vector loads), inter (nby, nbx) bool, mvx, mvy (nby, nbx) int32, the GOP
    position and the frame number (0-d tensors on the same device, or ints)
    -> (zmod (nby, nbx*384) int32, small (nby, 3 + 394*nbx) int32, the header
    rows (2, header_slots) int32, or None without ``header_slots``): the
    operands of ac_slot_grid as entropy.ac_inputs forms them, slice rows
    numbered from ``first_row``, and entropy._header_rows."""
    if _build.on_cpu(quant_zig, inter, mvx, mvy):
        zmod, small = entropy.ac_inputs(quant_zig, inter, mvx, mvy, i_frame, q_level,
                                        first_row)
        hdr = None if header_slots is None else entropy._header_rows(
            i_frame, frame_no, header_slots, inter.device)
        return zmod, small, hdr
    nby, nbx = inter.shape
    _build.check(quant_zig, "quant_zig", torch.int32, (nby, nbx, 6, 64), align=16)
    _build.check(inter, "inter", torch.bool, (nby, nbx))
    _build.check(mvx, "mvx", torch.int32, (nby, nbx))
    _build.check(mvy, "mvy", torch.int32, (nby, nbx))
    zmod, small, hdr = _launch(quant_zig.device, nby, nbx, (quant_zig, inter, mvx, mvy),
                               i_frame, frame_no, q_level, first_row, header_slots or 0)
    return zmod, small, None if header_slots is None else hdr


def header_rows(i_frame, frame_no, s: int, device) -> torch.Tensor:
    """The GOP and picture header rows as a (2, s) int32 slot grid
    (entropy._header_rows): on a card one launch of the glue kernel with no
    macroblock."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return entropy._header_rows(i_frame, frame_no, s, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(dev, 0, 0, (0, 0, 0, 0), i_frame, frame_no, 0, 0, s)[2]
