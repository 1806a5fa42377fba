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

``subsample_420_stack`` is the kernel's second entry, for a captured step
that reads frame k of (F, H, W) stacks in place: k and the stacks' addresses
(``plane_table``) lie in device memory, and it also copies the frame's Y
plane into a plane of the step's own.
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
    _check_geometry(h, w)
    _build.check(u, "u", torch.uint8, (h, w), align=16)
    _build.check(v, "v", torch.uint8, (h, w), align=16)
    uo, vo = _chroma_out(h, w, u.device)
    _build.launch("mpeg2_subsample", "subsample", u.device, u, v, uo, vo, h // 2, w)
    return y, uo, vo


def in_place(stack: torch.Tensor) -> bool:
    """Whether subsample_420_stack can read every frame of the (..., F, H, W)
    uint8 ``stack`` where it lies (a batch's (B, F, H, W) stacks channel by
    channel): each frame's rows contiguous, its data and each stride above
    the frame's rows multiples of 16 bytes."""
    w = stack.shape[-1]
    return stack.stride()[-2:] == (w, 1) and stack.data_ptr() % 16 == 0 \
        and all(st % 16 == 0 for st in stack.stride()[:-2])


def plane_table(stacks, out: torch.Tensor) -> None:
    """Write the (Y, U, V) ``stacks``' base addresses and frame strides in
    bytes into ``out``, (6,) int64 on their device: the table that
    subsample_420_stack reads.  Each value is filled in on the device as a
    kernel's argument (6 launches): nothing is uploaded or waited for, so
    the host may write the table again at once, in stream order."""
    for p, s in enumerate(stacks):
        out[2 * p].fill_(s.data_ptr())
        out[2 * p + 1].fill_(s.stride(0))


def subsample_420_stack(stacks, table: torch.Tensor, k: torch.Tensor, y: torch.Tensor):
    """Frame ``k`` ((1,) int64, read where it lies) of the (F, H, W) uint8
    4:4:4 ``stacks`` (Y, U, V) -> (y, u420, v420): the frame's Y plane
    copied into ``y`` ((H, W) uint8, returned) and its chroma subsampled into
    new contiguous (H/2, W/2) planes.  On a card one launch of the kernel
    reads the frame through ``table`` (``plane_table`` of the stacks, each
    one ``in_place``; the stacks themselves are not looked at) and ``k``, so
    a captured launch reads whatever stacks the table names at its replay.
    On CPU tensors the plain version: the Y copy and subsample_420 of frame
    ``int(k)``."""
    if _build.on_cpu(table, k, y, *stacks):
        f = int(k)
        y.copy_(stacks[0][f])
        _, uo, vo = colorspace.subsample_420(*(s[f] for s in stacks))
        return y, uo, vo
    h, w = y.shape
    _check_geometry(h, w)
    _build.check(table, "table", torch.int64, (6,))
    _build.check(k, "k", torch.int64, (1,))
    _build.check(y, "y", torch.uint8, (h, w), align=16)
    uo, vo = _chroma_out(h, w, y.device)
    _build.launch("mpeg2_subsample_stack", "subsample", y.device, table, k, y, uo, vo,
                  h // 2, w)
    return y, uo, vo


def _check_geometry(h: int, w: int) -> None:
    if h % 2 or w % 16:
        raise ValueError(f"chroma planes {h}x{w}: need an even height and a width that "
                         f"is a multiple of 16")


def _chroma_out(h: int, w: int, dev):
    return tuple(torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
                 for _ in range(2))
