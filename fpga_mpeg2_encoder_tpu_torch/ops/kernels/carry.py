"""The GOP carry kernel (csrc/carry.cu): what encode_gop_scan's frame step
carries to the next frame once the frame's rows are in the sequence buffer.

In one launch, after the merge kernel: the chunk's overflow ORed with the
frame's (a row of the pack kernel over its cap, or the frame over its cap),
the merge kernel's new sequence bit count carried, the frame's bits and GOP
position written at index ``k`` of the per-frame outputs, and the GOP
position (0 after ``pframes`` P-frames), the frame number and ``k``
advanced.  It replaces 15 operations a frame of the compiled gop program
(models/encoder.py::_GopProgram) and has no JAX counterpart: XLA fuses the
scan step's bookkeeping there.  It is bound by its launch (a few hundred
bytes).  On CPU tensors ``plain_carry``, the same torch operations the step
ran before, runs instead.  Only the gop program calls it; the eager
encode_gop_scan_core carries its state as host ints.
"""
from __future__ import annotations

import torch

from . import _build


def plain_carry(row_bits, row_cap: int, fbits, frame_ovf, new_bits, state, per_frame) -> None:
    """The plain version of gop_carry, in torch operations."""
    seq_bits, overflow, i_frame, pframes, frame_no, k = state
    frame_bits, frame_ifs = per_frame
    ovf = overflow | (row_bits > 32 * row_cap).any() | frame_ovf
    frame_bits.scatter_(0, k, fbits.view(1))
    frame_ifs.scatter_(0, k, i_frame.view(1))
    i_next = torch.where(i_frame >= pframes, 0, i_frame + 1)
    for dst, src in zip((seq_bits, overflow, i_frame, frame_no),
                        (new_bits, ovf, i_next, frame_no + 1)):
        dst.copy_(src)
    k.add_(1)


def gop_carry(row_bits: torch.Tensor, row_cap: int, fbits: torch.Tensor,
              frame_ovf: torch.Tensor, new_bits: torch.Tensor, state, per_frame) -> None:
    """In place: ``state`` = (seq_bits () int64, overflow () bool, i_frame
    () int32, pframes () int32, frame_no () int32, k (1,) int64) and
    ``per_frame`` = (frame_bits (n,) int64, frame_ifs (n,) int32) advanced
    by one frame whose rows' bits are ``row_bits`` (R,) int64 at ``row_cap``
    words a row and whose merge gave ``fbits`` () int64, ``frame_ovf`` ()
    bool and ``new_bits`` () int64.  ``k`` must lie in 0 .. n - 1."""
    tensors = (row_bits, fbits, frame_ovf, new_bits, *state, *per_frame)
    if _build.on_cpu(*tensors):
        plain_carry(row_bits, row_cap, fbits, frame_ovf, new_bits, state, per_frame)
        return
    (r,), n = row_bits.shape, per_frame[0].numel()
    for t, name, dtype, shape in zip(
            tensors, ("row_bits", "fbits", "frame_ovf", "new_bits", "seq_bits", "overflow",
                      "i_frame", "pframes", "frame_no", "k", "frame_bits", "frame_ifs"),
            (torch.int64, torch.int64, torch.bool, torch.int64, torch.int64, torch.bool,
             torch.int32, torch.int32, torch.int32, torch.int64, torch.int64, torch.int32),
            ((r,), (), (), (), (), (), (), (), (), (1,), (n,), (n,))):
        _build.check(t, name, dtype, shape)
    _build.launch("mpeg2_gop_carry", "gop_carry", row_bits.device, *tensors, r, row_cap, n)
