"""Motion-estimation kernels (csrc/me.cu): full-pel search, half-pel
refinement, inter/intra decision and luma and chroma prediction.

* motion_estimate_fused replaces ops/pallas/me.py::motion_estimate_fused_pallas
  of the JAX package: the whole stage in one launch, on the main path once
  per frame;
* motion_estimate replaces motion_estimate_pallas (the luma half);
* chroma_pred replaces chroma_pred_pallas (the chroma half, from the mv and
  inter maps in device memory): a kernel of its own, one warp per
  macroblock, each lane forming 4 bytes of one row of U or V from aligned
  4-byte loads (its planes must be 4-byte aligned).
The JAX package reaches the last two only as a demotion rung; here they are
public functions that are held against their plain versions and against
the fused kernel, and the encoder never switches to them.

What bounds the search on the card is integer throughput: at 1920x1152,
yr = 6, a P-frame is 8640 x 169 x 256 = 374 M absolute-difference adds for
the full-pel search alone, four to a byte-SIMD VABSDIFF4 instruction
(__vsadu4), against 8.3 MB of input and uint8 output.  The kernel runs one
warp a macroblock, a block a strip of ``strip_width`` macroblocks of one
macroblock row whose reference window its warps share in shared memory.
Lane (dx, group of block rows) keeps its rows in registers and adds each
window row at its dx against every row that meets it in range; a shuffle
sum over the groups and the warp's minimum key give the full-pel vector.
The half-pel candidates are formed four pixels to a word, the decision is
the warp's, and U and V come from the strip's chroma window, so every
reference pixel is read from device memory once a strip and nothing
between the search and the prediction leaves the SM.  An I-frame skips the
search, as its result (intra, mv 0, prediction 128) does not depend on it,
and stores it as whole words.  Predictions are uint8.

Every function takes the JAX functions' arguments: ``halo`` says the
reference planes carry 8 luma / 4 chroma halo rows each side (the band form
of slice-row sharding), ``first_mb_row``/``total_mb_rows`` place the band in
the frame, ``as_plane`` returns predictions as (H, W) planes instead of
(nby, nbx, bs, bs) tiles.  On CPU tensors the plain versions of
ops/motion.py run instead.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import entropy, motion
from . import _build

MAX_YR = 6   # csrc/me.cu's window size: vector_level <= 3
MAX_STRIP = 4   # csrc/me.cu: macroblocks (warps) a block


def strip_width(nby: int, nbx: int, sms: int) -> int:
    """Macroblocks a block of the motion kernels (F and L) takes, from the
    frame's macroblock grid and the card's SM count: the widest strip of 4,
    2 or 1 macroblocks whose grid still gives every SM four blocks, so that
    a small frame keeps every SM busy while a large one shares each window
    across a strip."""
    s = MAX_STRIP
    while s > 1 and nby * -(-nbx // s) < 4 * sms:
        s //= 2
    return s


def _strip(nby: int, nbx: int, dev) -> int:
    """strip_width on ``dev``'s card."""
    return strip_width(nby, nbx, _sm_count(dev.index))


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index).multi_processor_count


def _meta(nby: int, nbx: int, dev):
    return (torch.empty((nby, nbx), dtype=torch.bool, device=dev),
            torch.empty((nby, nbx), dtype=torch.int32, device=dev),
            torch.empty((nby, nbx), dtype=torch.int32, device=dev))


def _gop_position(is_iframe, dev) -> torch.Tensor:
    """The kernels' I/P operand: a 0-d int32 on the device, 0 for an
    I-frame, from a Python bool or a 0-d bool or int tensor (nonzero: an
    I-frame) on ``dev``, formed there, so that nothing waits for the device
    and a CUDA graph replays the launch with the flag the step formed."""
    return (entropy.gop_scalar(is_iframe, dev) == 0).to(torch.int32)


def _pred(nby: int, nbx: int, bs: int, as_plane: bool, dev) -> torch.Tensor:
    shape = (nby * bs, nbx * bs) if as_plane else (nby, nbx, bs, bs)
    return torch.empty(shape, dtype=torch.uint8, device=dev)


def _band(cur_y: torch.Tensor, yr: int, total_mb_rows: Optional[int]):
    h, w = cur_y.shape
    if h % 16 or w % 16:
        raise ValueError(f"frame {h}x{w} is not a multiple of 16")
    if not 1 <= yr <= MAX_YR:
        raise ValueError(f"search range {yr} outside 1..{MAX_YR}")
    return h // 16, w // 16, h // 16 if total_mb_rows is None else total_mb_rows


def _check_planes(nby: int, nbx: int, halo: bool, luma=None, chroma=(),
                  chroma_align: int = 1):
    """Check the reference planes' shapes: nby*bs rows plus the halo rows."""
    if luma is not None:
        _build.check(luma, "prev_y", torch.uint8,
                     (nby * 16 + (16 if halo else 0), nbx * 16), align=16)
    for t, name in chroma:
        _build.check(t, name, torch.uint8, (nby * 8 + (8 if halo else 0), nbx * 8),
                     align=chroma_align)


def motion_estimate_fused(cur_y, prev_y, prev_u, prev_v, is_iframe, yr: int,
                          ur: int, first_mb_row: int = 0,
                          total_mb_rows: Optional[int] = None, halo: bool = False,
                          as_plane: bool = False, *, position=None
                          ) -> Tuple[torch.Tensor, ...]:
    """cur_y (H, W) uint8; prev_y (H, W) uint8, or (H + 16, W) with ``halo``;
    prev_u/prev_v (H/2, W/2), or (H/2 + 8, W/2) with ``halo`` -> (inter
    (nby, nbx) bool, mvx, mvy (nby, nbx) int32 half-pel, pred_y, pred_u,
    pred_v uint8).  ``is_iframe``: a bool, or a 0-d bool or int tensor on
    the planes' device (nonzero: an I-frame).  Or, with ``is_iframe`` None,
    ``position``: the frame's GOP position, a 0-d int32 tensor there (0: an
    I-frame), which the kernel reads as it stands (the compiled gop
    program's own GOP state)."""
    if (position is None) == (is_iframe is None):
        raise ValueError("give one of is_iframe and position")
    nby, nbx, total = _band(cur_y, yr, total_mb_rows)
    if _build.on_cpu(cur_y, prev_y, prev_u, prev_v):
        if position is not None:
            is_iframe = position == 0
        if not halo:
            prev_y = motion.pad_halo(prev_y, motion.LUMA_HALO)
            prev_u = motion.pad_halo(prev_u, motion.CHROMA_HALO)
            prev_v = motion.pad_halo(prev_v, motion.CHROMA_HALO)
        return tuple(motion.estimate_and_predict_local(
            cur_y, prev_y, prev_u, prev_v, is_iframe, yr, ur, first_mb_row,
            total, as_plane))
    _build.check(cur_y, "cur_y", torch.uint8, (nby * 16, nbx * 16), align=16)
    # the kernel reads the luma planes in 16-byte words, the chroma in 8-byte
    _check_planes(nby, nbx, halo, prev_y, ((prev_u, "prev_u"), (prev_v, "prev_v")),
                  chroma_align=8)
    dev = cur_y.device
    if position is None:
        position = _gop_position(is_iframe, dev)
    else:                   # read as it stands: nothing is launched to form it
        _build.check(position, "position", torch.int32, ())
    inter, mvx, mvy = _meta(nby, nbx, dev)
    py, pu, pv = (_pred(nby, nbx, 16, as_plane, dev), _pred(nby, nbx, 8, as_plane, dev),
                  _pred(nby, nbx, 8, as_plane, dev))
    _build.launch("mpeg2_me_fused", "me_fused", dev, cur_y, prev_y, prev_u, prev_v,
                  position, inter, mvx, mvy, py, pu, pv, nby, nbx,
                  yr, first_mb_row, total, int(halo), int(as_plane), _strip(nby, nbx, dev))
    return inter, mvx, mvy, py, pu, pv


def motion_estimate(cur_y, prev_y, is_iframe, yr: int, first_mb_row: int = 0,
                    total_mb_rows: Optional[int] = None, halo: bool = False,
                    as_plane: bool = False) -> Tuple[torch.Tensor, ...]:
    """Luma half of motion_estimate_fused: (inter, mvx, mvy, pred_y)."""
    nby, nbx, total = _band(cur_y, yr, total_mb_rows)
    if _build.on_cpu(cur_y, prev_y):
        if not halo:
            prev_y = motion.pad_halo(prev_y, motion.LUMA_HALO)
        inter, mvx, mvy, pred_y = motion.estimate_luma(
            cur_y, prev_y, is_iframe, yr, first_mb_row, total)
        return inter, mvx, mvy, motion.to_planes(pred_y) if as_plane else pred_y
    _build.check(cur_y, "cur_y", torch.uint8, (nby * 16, nbx * 16), align=16)
    _check_planes(nby, nbx, halo, prev_y)
    dev = cur_y.device
    inter, mvx, mvy = _meta(nby, nbx, dev)
    py = _pred(nby, nbx, 16, as_plane, dev)
    _build.launch("mpeg2_me_luma", "me_luma", dev, cur_y, prev_y,
                  _gop_position(is_iframe, dev), inter, mvx, mvy, py, nby, nbx, yr,
                  first_mb_row, total, int(halo), int(as_plane), _strip(nby, nbx, dev))
    return inter, mvx, mvy, py


def chroma_pred(prev_u, prev_v, inter, mvx, mvy, ur: int, halo: bool = False,
                as_plane: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chroma half of motion_estimate_fused: prev_u/prev_v (H/2, W/2) uint8,
    or (H/2 + 8, W/2) with ``halo``, and the (nby, nbx) inter/mvx/mvy maps ->
    (pred_u, pred_v) uint8."""
    nby, nbx = inter.shape
    if _build.on_cpu(prev_u, prev_v, inter, mvx, mvy):
        if not halo:
            prev_u = motion.pad_halo(prev_u, motion.CHROMA_HALO)
            prev_v = motion.pad_halo(prev_v, motion.CHROMA_HALO)
        pu, pv = motion.chroma_pred(prev_u, prev_v, inter, mvx, mvy, ur)
        return (motion.to_planes(pu), motion.to_planes(pv)) if as_plane else (pu, pv)
    # the kernel reads the planes in aligned 4-byte words
    _check_planes(nby, nbx, halo, chroma=((prev_u, "prev_u"), (prev_v, "prev_v")),
                  chroma_align=4)
    _build.check(inter, "inter", torch.bool, (nby, nbx))
    _build.check(mvx, "mvx", torch.int32, (nby, nbx))
    _build.check(mvy, "mvy", torch.int32, (nby, nbx))
    dev = prev_u.device
    pu, pv = _pred(nby, nbx, 8, as_plane, dev), _pred(nby, nbx, 8, as_plane, dev)
    _build.launch("mpeg2_chroma_pred", "chroma_pred", dev, prev_u, prev_v, inter, mvx,
                  mvy, pu, pv, nby, nbx, int(halo), int(as_plane))
    return pu, pv


def estimate_and_predict_planes(cur_y, cur_u, cur_v, prev_y, prev_u, prev_v,
                                is_iframe, yr: int, ur: int, *, position=None
                                ) -> motion.MotionResult:
    """The main path's motion stage: motion.estimate_and_predict_planes'
    contract (predictions as planes), through the fused kernel; ``position``
    as motion_estimate_fused takes it."""
    del cur_u, cur_v    # the reference searches luma only
    return motion.MotionResult(*motion_estimate_fused(
        cur_y, prev_y, prev_u, prev_v, is_iframe, yr, ur, as_plane=True, position=position))


def estimate_and_predict_local(cur_y, prev_y_h, prev_u_h, prev_v_h, is_iframe,
                               yr: int, ur: int, first_mb_row: int, total_mb_rows: int,
                               as_planes: bool = False) -> motion.MotionResult:
    """motion.estimate_and_predict_local's contract (the band form), through
    the fused kernel."""
    return motion.MotionResult(*motion_estimate_fused(
        cur_y, prev_y_h, prev_u_h, prev_v_h, is_iframe, yr, ur, first_mb_row,
        total_mb_rows, halo=True, as_plane=as_planes))
