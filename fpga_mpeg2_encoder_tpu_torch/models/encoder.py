"""The encoder: per-frame pipeline + sequence runtime, in PyTorch.

Pipeline per frame (all macroblocks batched):
  4:2:0 subsample kernel -> motion-estimation kernel (search + prediction) ->
  transform kernel (residual, DCT, quantise, dequantise, IDCT, reconstruction)
  -> symbolisation (the glue kernel: headers, macroblock type, MV, CBP, DC and
  EOB slots; the acsym kernel: AC symbols) -> pack kernel (one bit-string per
  slot row) -> merge kernel (the rows, GOP/picture headers included, merged
  byte-aligned straight into the sequence buffer by the multi-frame path, or
  into one frame payload by push_frame).
The host only prepends the per-sequence header bytes and appends the end code.

Every stage runs where its tensors lie: on a CUDA device the kernel wrappers
launch their kernels, on the CPU they run their plain versions.

The only sequential dependency is frame order (P-frames predict from the
previous frame's reconstruction, the loop the reference closes through
mem_ref_Y/UV, RTL/mpeg2encoder.v:2418-2424 -> 1387-1390).

The compiled programs, under the JAX package's names: ``encode_frame_device``
(one frame, its payload stored) and ``encode_gop_scan`` (a chunk of frames
appended to one sequence buffer, the GOP position and the timecode carried
on the device as 0-d int32 tensors).  On a card each replays a CUDA graph of
one frame's step (runtime/graphs.py), cached per geometry, knobs and caps;
on the CPU the same step runs eagerly.  The un-compiled ``_core`` functions
stay beside them, as the JAX package keeps encode_gop_scan_core beside the
jit: a Python loop over frames with the GOP state as host ints.
``Encoder`` and parallel/dp.py go through the programs.

Packing buffers are sized by caps (default 256 KB/frame) with exact overflow
detection; an overflowing frame or chunk is encoded again on the device at
the caps of ``bound_caps``, which no frame can overflow.  Caps never change
the bytes.
"""
from __future__ import annotations

import time
import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import EncoderConfig, SequenceConfig
from ..core.bitstream import sequence_end, sequence_start
from ..ops import entropy
from ..ops.kernels import carry as k_carry
from ..ops.kernels import colorspace as k_colorspace
from ..ops.kernels import me as k_me
from ..ops.kernels import pack as k_pack
from ..ops.kernels import transform as k_transform
from ..runtime import graphs
from ..runtime.state import EncoderState
from ..utils.logging import SequenceStats
from ..utils.profiling import count, span

DEFAULT_ROW_CAP = 2048       # words/slice budget (8 KB)
DEFAULT_FRAME_CAP = 65536    # words/frame budget (256 KB)
STAGING_SLOTS = 6            # page-locked frame slots of push_chunk's ring on a card


def symbolize_frame_core(y444, u444, v444, prev_y, prev_u, prev_v,
                         i_frame, frame_no, *, yr: int, ur: int, q_level: int):
    """The pipeline up to symbolisation: (recon_y, recon_u, recon_v, slots
    (2 + nby, S) int32).  ``i_frame`` and ``frame_no`` are ints or 0-d
    tensors on the frame's device."""
    y, u, v = k_colorspace.subsample_420(y444, u444, v444)
    mr = k_me.estimate_and_predict_planes(y, u, v, prev_y, prev_u, prev_v,
                                          i_frame == 0, yr, ur)
    quant_zig, recon_y, recon_u, recon_v = k_transform.transform_recon(
        y, u, v, mr.pred_y, mr.pred_u, mr.pred_v, mr.inter, q_level)
    slots = entropy.symbolize_frame(quant_zig, mr.inter, mr.mvx, mr.mvy,
                                    i_frame, frame_no, q_level)
    return recon_y, recon_u, recon_v, slots


def encode_frame_core(y444, u444, v444, prev_y, prev_u, prev_v,
                      i_frame, frame_no, *, yr: int, ur: int,
                      q_level: int, row_cap: int, frame_cap: int):
    """Single-frame pipeline.  Returns (recon_y, recon_u, recon_v,
    frame_words (frame_cap,) int64, frame_bits, overflow flag), the last two
    as device tensors."""
    recon_y, recon_u, recon_v, slots = symbolize_frame_core(
        y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no,
        yr=yr, ur=ur, q_level=q_level)
    row_words, row_bits, pack_ovf = k_pack.pack_slots(slots, row_cap)
    fwords, fbits = k_pack.merge_rows(row_words, row_bits, frame_cap)
    return recon_y, recon_u, recon_v, fwords, fbits, pack_ovf | (fbits > 32 * frame_cap)


def next_i_frame(i_frame: int, pframes_count: int) -> int:
    """The next frame's GOP position: an I-frame (0) after ``pframes_count``
    P-frames, else one further."""
    return 0 if i_frame >= pframes_count else i_frame + 1


def _gop_step(carry, frame, pframes_count: int, *, yr: int, ur: int, q_level: int,
              row_cap: int, frame_cap: int):
    """One frame of encode_gop_scan_core, JAX's scan ``step``: carry (prev
    (recon_y, recon_u, recon_v), seq_words, seq_bits, overflow, i_frame,
    frame_no) and frame (y444, u444, v444) -> (the next carry, (the frame's
    bits, its GOP position)).  The frame's rows go into seq_words in place.
    The GOP position and the frame number are host ints."""
    prev, seq_w, seq_b, ovf, i_f, fno = carry
    ry, ru, rv, slots = symbolize_frame_core(*frame, *prev, i_f, fno,
                                             yr=yr, ur=ur, q_level=q_level)
    row_words, row_bits, pack_ovf = k_pack.pack_slots(slots, row_cap)
    # the frame's rows straight into the sequence buffer: one launch
    seq_w, seq_b, fb, frame_ovf = k_pack.merge_append(seq_w, seq_b, row_words, row_bits,
                                                      frame_cap)
    return ((ry, ru, rv), seq_w, seq_b, ovf | pack_ovf | frame_ovf,
            next_i_frame(i_f, pframes_count), fno + 1), (fb, i_f)


def encode_gop_scan_core(frames_y, frames_u, frames_v, prev_y, prev_u, prev_v,
                         i_frame0: int, frame_no0: int, pframes_count: int, *,
                         yr: int, ur: int, q_level: int, row_cap: int,
                         frame_cap: int, seq_cap: int):
    """Multi-frame encode over (F, H, W) frame stacks, accumulating the packed
    payload in one device buffer: one upload of the frames, one download of
    the payload.  Returns (recon_y, recon_u, recon_v, seq_words, seq_bits,
    i_frame, frame_no, overflow, frame_bits (F,), frame_i_frames list)."""
    dev = frames_y.device
    # guard margin per the append_bitstring sizing contract (merge_append
    # keeps it): the frame payload is frame_cap words, so seq_cap + frame_cap
    # + 1 words always hold the append window; overflow is still checked
    # against the logical seq_cap
    seq_w = torch.zeros(seq_cap + frame_cap + 1, dtype=torch.int64, device=dev)
    seq_b = torch.zeros((), dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    carry = ((prev_y, prev_u, prev_v), seq_w, seq_b, ovf, i_frame0, frame_no0)
    frame_bits, frame_ifs = [], []
    for k in range(frames_y.shape[0]):
        carry, (fb, i_f) = _gop_step(carry, (frames_y[k], frames_u[k], frames_v[k]),
                                     pframes_count, yr=yr, ur=ur, q_level=q_level,
                                     row_cap=row_cap, frame_cap=frame_cap)
        frame_bits.append(fb)
        frame_ifs.append(i_f)
    prev, seq_w, seq_b, ovf, i_f, fno = carry
    ovf = ovf | (seq_b > 32 * seq_cap)
    return (*prev, seq_w, seq_b, i_f, fno, ovf, torch.stack(frame_bits), frame_ifs)


def _copy_in(dst: torch.Tensor, src, name: str) -> None:
    """Copy the plane ``src`` into a program's tensor ``dst``: the same
    shape, dtype and device (never a move between devices)."""
    if src.device != dst.device or src.dtype != dst.dtype \
            or tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: {tuple(src.shape)} {src.dtype} on {src.device}, the "
                         f"program takes {tuple(dst.shape)} {dst.dtype} on {dst.device}")
    dst.copy_(src)


def _enqueued(dsts, srcs) -> int:
    """How many of the copies or fills of ``srcs`` into ``dsts`` enqueue
    work: all but those of a program's tensor onto itself."""
    return sum(src is not dst for dst, src in zip(dsts, srcs))


def _readable(frames, want: Tuple[int, ...], dev) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """The (Y, U, V) stacks ``frames``, each of shape ``want`` ((F, H, W), or
    a batch's (B, F, H, W)) and uint8 on ``dev``, as the subsample kernel's
    stack entry reads them: each where it lies where it can
    (``k_colorspace.in_place``), else copied once, contiguous (counted as
    ``stack_copies``; else their frames as ``frames_in_place``).  Returns
    the stacks and the number of copies."""
    stacks = []
    for src, name in zip(frames, ("frames_y", "frames_u", "frames_v")):
        if src.device != dev or src.dtype != torch.uint8 or tuple(src.shape) != want:
            raise ValueError(f"{name}: {tuple(src.shape)} {src.dtype} on {src.device}, "
                             f"the program takes {want} torch.uint8 on {dev}")
        stacks.append(src if k_colorspace.in_place(src)
                      else src.clone(memory_format=torch.contiguous_format))
    copies = sum(s is not src for s, src in zip(stacks, frames))
    if copies:
        count("stack_copies", copies)
    else:
        count("frames_in_place", int(np.prod(want[:-2])))
    return tuple(stacks), copies


def _planes(dev, h: int, w: int, sub: int, lead: Tuple[int, ...] = ()):
    """Zeroed uint8 planes: (*lead, H, W), then two of (*lead, H/sub, W/sub)."""
    return tuple(torch.zeros((*lead, *shape), dtype=torch.uint8, device=dev)
                 for shape in ((h, w), (h // sub, w // sub), (h // sub, w // sub)))


class _FrameProgram:
    """encode_frame_device's inputs and its step (encode_frame_core on
    them) on one device: the frame's 4:4:4 planes, the reference planes and
    the GOP position and frame number as 0-d int32 tensors."""

    def __init__(self, dev, h, w, *, yr, ur, q_level, row_cap, frame_cap):
        self.frame, self.prev = _planes(dev, h, w, 1), _planes(dev, h, w, 2)
        self.i_frame, self.frame_no = entropy.gop_scalar(0, dev), entropy.gop_scalar(0, dev)
        kw = dict(yr=yr, ur=ur, q_level=q_level, row_cap=row_cap, frame_cap=frame_cap)
        self.step = graphs.Step(lambda: encode_frame_core(
            *self.frame, *self.prev, self.i_frame, self.frame_no, **kw), dev, "frame")

    def __call__(self, planes, prev, i_frame, frame_no):
        with span("frame.feed"):
            dsts, srcs = self.frame + self.prev, tuple(planes) + tuple(prev)
            for dst, src, name in zip(dsts, srcs, ("y444", "u444", "v444", "prev_y", "prev_u",
                                                   "prev_v")):
                _copy_in(dst, src, name)
            entropy.gop_scalar(i_frame, self.i_frame.device, out=self.i_frame)
            entropy.gop_scalar(frame_no, self.frame_no.device, out=self.frame_no)
            count("host_launches", _enqueued(dsts + (self.i_frame, self.frame_no),
                                             srcs + (i_frame, frame_no))
                  + self.step.launches_a_call)
            return self.step()


def _frames_cap(f: int) -> int:
    """The per-frame outputs' length for a chunk of f frames: a power of two,
    at least 64, so that chunks of similar lengths share a program."""
    return max(64, 1 << (f - 1).bit_length())


class _GopCarry:
    """The gop program's carry for n channels as (n, ...) stacks on one
    device; channel b's tensors are row b of each (``_GopProgram``'s
    ``carry`` and ``index``).  ``gop`` holds the GOP position, the frame
    number and the P-frames a GOP, (3, n) int32; ``counts`` the sequence bit
    count, the merge's new bit count and k, (3, n) int64; ``planes`` each
    channel's plane table, (n, 6) int64.  Row strides keep every plane
    16-byte aligned (widths are multiples of 16)."""

    def __init__(self, dev, n: int, h: int, w: int, words: int, frames_cap: int):
        self.frame_y = torch.zeros((n, h, w), dtype=torch.uint8, device=dev)
        self.prev = _planes(dev, h, w, 2, (n,))
        self.gop = torch.zeros((3, n), dtype=torch.int32, device=dev)
        # guard margin per the append_bitstring sizing contract, as in
        # encode_gop_scan_core: words = seq_cap + frame_cap + 1
        self.seq_words = torch.zeros((n, words), dtype=torch.int64, device=dev)
        self.counts = torch.zeros((3, n), dtype=torch.int64, device=dev)
        self.overflow = torch.zeros(n, dtype=torch.bool, device=dev)
        self.frame_bits = torch.zeros((n, frames_cap), dtype=torch.int64, device=dev)
        self.frame_ifs = torch.zeros((n, frames_cap), dtype=torch.int32, device=dev)
        self.planes = torch.zeros((n, 6), dtype=torch.int64, device=dev)


class _GopProgram:
    """encode_gop_scan's carry and its step on one device.  The step is
    encode_gop_scan_core's frame on the program's tensors: frame ``k`` of
    the chunk's (F, H, W) stacks in, the frame's rows appended to the
    sequence buffer, and the carry kept in the program's own tensors,
    written where it is formed.  The subsample kernel reads frame ``k`` of
    the stacks in place, through ``planes`` (each stack's address and frame
    stride, written by ``start``), and copies its Y plane into the program's
    ``frame_y``, which the motion and transform kernels read.  The motion
    kernel reads the GOP position ``i_frame`` as it stands; the transform
    writes the recon into ``prev`` in place (the motion kernel, the only
    reader of ``prev`` in the step, has ended by then, in stream order); the
    carry kernel (ops/kernels/carry.py), after the merge, ORs the overflow,
    carries the sequence bit count, writes the frame's bits and GOP position
    at index ``k`` of the per-frame outputs, and advances the GOP position,
    the frame number and k.  The pack kernel reads the header rows and the
    slice rows where the glue and acsym kernels wrote them, and writes each
    row only up to its last partial word, all the merge reads.  On a card
    the step is the seven stage kernels and the carry kernel, and nothing
    else.  The per-frame outputs hold ``frames_cap`` frames.

    The carry is row ``index`` of a ``_GopCarry``: one of its own by
    default, or ``carry``, a batch's (``_GopBatch``), which captures the
    channels' steps as the branches of one graph, so that such a channel
    captures no step of its own (``step`` is None)."""

    def __init__(self, dev, h, w, *, yr, ur, q_level, row_cap, frame_cap, seq_cap,
                 frames_cap, carry=None, index=0):
        own = carry is None
        if own:
            carry = _GopCarry(dev, 1, h, w, seq_cap + frame_cap + 1, frames_cap)
        self.frame_y = carry.frame_y[index]
        self.prev = tuple(p[index] for p in carry.prev)
        self.i_frame, self.frame_no, self.pframes = carry.gop[:, index]
        self.seq_words = carry.seq_words[index]
        self.seq_bits, self.new_bits = carry.counts[0, index], carry.counts[1, index]
        self.k = carry.counts[2, index:index + 1]
        self.overflow = carry.overflow[index]
        self.frame_bits, self.frame_ifs = carry.frame_bits[index], carry.frame_ifs[index]
        self.seq_cap, self.frames_cap = seq_cap, frames_cap
        self.yr, self.ur, self.q_level = yr, ur, q_level
        self.row_cap, self.frame_cap = row_cap, frame_cap
        # the stacks the step reads, kept until the next start (a captured
        # graph reads them); until the first, the warm-up and the capture
        # read the zeroed prev_y as a one-frame stack of all three planes
        self.stacks = (self.prev[0][None],) * 3
        self.planes = carry.planes[index]
        k_colorspace.plane_table(self.stacks, self.planes)
        self.step = graphs.Step(self._step, dev, "gop") if own else None

    def _step(self):
        """One frame; returns the temporaries it made, which a batch's
        capture holds until its branches join."""
        y, u, v = k_colorspace.subsample_420_stack(self.stacks, self.planes, self.k,
                                                   self.frame_y)
        mr = k_me.estimate_and_predict_planes(y, u, v, *self.prev, None, self.yr, self.ur,
                                              position=self.i_frame)
        quant_zig, *_ = k_transform.transform_recon(y, u, v, mr.pred_y, mr.pred_u, mr.pred_v,
                                                    mr.inter, self.q_level, out=self.prev)
        hdr, slots = entropy.symbolize_rows(quant_zig, mr.inter, mr.mvx, mr.mvy, self.i_frame,
                                            self.frame_no, self.q_level)
        row_words, row_bits = k_pack.pack_rows(hdr, slots, self.row_cap)
        _, _, fbits, frame_ovf = k_pack.merge_append(self.seq_words, self.seq_bits, row_words,
                                                     row_bits, self.frame_cap,
                                                     new_bits=self.new_bits)
        k_carry.gop_carry(row_bits, self.row_cap, fbits, frame_ovf, self.new_bits,
                          (self.seq_bits, self.overflow, self.i_frame, self.pframes,
                           self.frame_no, self.k), (self.frame_bits, self.frame_ifs))
        return (u, v, mr, quant_zig, hdr, slots, row_words, row_bits, fbits, frame_ovf)

    def _take_stacks(self, frames) -> int:
        """Point the step at the chunk's (F, H, W) stacks (``_readable``).
        Returns the launches enqueued: the copies and the table's writes."""
        self.stacks, copies = _readable(frames, (len(frames[0]), *self.frame_y.shape),
                                        self.frame_y.device)
        k_colorspace.plane_table(self.stacks, self.planes)
        return copies + 2 * len(self.stacks)

    def start(self, frames, prev, i_frame0, frame_no0, pframes_count) -> None:
        """Set the carry for a new chunk: the frames' (F, H, W) stacks,
        the reference planes, the GOP state, an empty sequence buffer and no
        overflow."""
        with span("gop.start"):
            launches = self._take_stacks(frames)
            for dst, src, name in zip(self.prev, prev, ("prev_y", "prev_u", "prev_v")):
                _copy_in(dst, src, name)
            scalars = (self.i_frame, self.frame_no, self.pframes)
            values = (i_frame0, frame_no0, pframes_count)
            for dst, src in zip(scalars, values):
                entropy.gop_scalar(src, dst.device, out=dst)
            zeroed = (self.seq_words, self.seq_bits, self.overflow, self.k)
            for t in zeroed:
                t.zero_()
            count("host_launches", launches + _enqueued(self.prev + scalars, tuple(prev) + values)
                  + len(zeroed))

    def feed(self) -> None:
        """The chunk's next frame through the step."""
        with span("gop.feed"):
            count("host_launches", self.step.launches_a_call)
            self.step()

    def result(self, n_frames: int):
        with span("gop.result"):
            ovf = self.overflow | (self.seq_bits > 32 * self.seq_cap)
            count("host_launches", 2)
        return (*self.prev, self.seq_words, self.seq_bits, self.i_frame, self.frame_no, ovf,
                self.frame_bits[:n_frames], self.frame_ifs[:n_frames])


class _GopBatch:
    """encode_gop_scan's program for n channels side by side, the batch
    program of parallel/dp.py: channel b is a ``_GopProgram`` whose carry is
    row b of the batch's ``_GopCarry``, and the channels' steps are the
    branches of one graph (``graphs.Step`` over their list), so that a
    replay runs the next frame of every channel, the channels concurrently
    on a card.  ``start`` sets every channel's carry with one operation a
    stack: the plane tables and the GOP state are written into page-locked
    host buffers and uploaded (2 launches; the host waits for the last
    call's uploads before it writes the buffers again), the recons copied
    (3), the sequence buffers, the counts and the overflow flags zeroed (3).
    ``feed`` is the replay alone; ``result`` forms the (n,) overflow (2) and
    returns the stacks themselves."""

    def __init__(self, dev, n, h, w, *, frames_cap, **kw):
        self.carry = _GopCarry(dev, n, h, w, kw["seq_cap"] + kw["frame_cap"] + 1, frames_cap)
        self.channels = [_GopProgram(dev, h, w, **kw, frames_cap=frames_cap, carry=self.carry,
                                     index=b) for b in range(n)]
        self.seq_cap = kw["seq_cap"]
        pinned = dev.type == "cuda"
        self._table = torch.zeros((n, 6), dtype=torch.int64, pin_memory=pinned)
        self._gop = torch.zeros((3, n), dtype=torch.int32, pin_memory=pinned)
        self._uploaded = torch.cuda.Event() if pinned else None
        self.stacks = ()
        self.step = graphs.Step([c._step for c in self.channels], dev, "gop_batch")

    def _take_stacks(self, frames) -> int:
        """Point each channel at its slice of the call's (n, F, H, W) stacks
        (``_readable``) and write the channels' plane tables into the host
        buffer.  Returns the copies enqueued."""
        c, n = self.carry, len(self.channels)
        self.stacks, copies = _readable(frames, (n, frames[0].shape[1], *c.frame_y.shape[1:]),
                                        c.frame_y.device)
        for ch, own in zip(self.channels, zip(*(s.unbind(0) for s in self.stacks))):
            ch.stacks = own
        table = self._table.numpy()
        for p, s in enumerate(self.stacks):
            table[:, 2 * p] = s.data_ptr() + s.stride(0) * np.arange(n)
            table[:, 2 * p + 1] = s.stride(1)
        return copies

    def start(self, frames, prev, i_frame0, frame_no0, pframes_count) -> None:
        """Set every channel's carry for a new call: the frames' (n, F, H, W)
        stacks, the (n, ...) reference planes, n host ints each of GOP
        position and frame number, empty sequence buffers, no overflow."""
        with span("gop.start"):
            c, n = self.carry, len(self.channels)
            if len(i_frame0) != n or len(frame_no0) != n:
                raise ValueError(f"{len(i_frame0)} GOP positions and {len(frame_no0)} frame "
                                 f"numbers, the program takes {n} channels")
            if self._uploaded is not None:
                self._uploaded.synchronize()
            launches = self._take_stacks(frames)
            gop = self._gop.numpy()
            gop[0], gop[1] = [int(v) for v in i_frame0], [int(v) for v in frame_no0]
            gop[2] = int(pframes_count)
            c.planes.copy_(self._table, non_blocking=True)
            c.gop.copy_(self._gop, non_blocking=True)
            if self._uploaded is not None:
                self._uploaded.record()
            for dst, src, name in zip(c.prev, prev, ("prev_y", "prev_u", "prev_v")):
                _copy_in(dst, src, name)
            zeroed = (c.seq_words, c.counts, c.overflow)
            for t in zeroed:
                t.zero_()
            count("host_launches", launches + 2 + _enqueued(c.prev, prev) + len(zeroed))

    feed = _GopProgram.feed          # every channel's next frame: the replay alone

    def result(self, n_frames: int):
        c = self.carry
        ovf = c.overflow | (c.counts[0] > 32 * self.seq_cap)
        count("host_launches", 2)
        return (*c.prev, c.seq_words, c.counts[0], c.gop[0], c.gop[1], ovf,
                c.frame_bits[:, :n_frames], c.frame_ifs[:, :n_frames])


def gop_batch(frames_y, *, yr: int, ur: int, q_level: int, row_cap: int, frame_cap: int,
              seq_cap: int) -> _GopBatch:
    """The batch program for (B, F, H, W) stacks like ``frames_y``: cached
    per device, B, geometry, knobs, caps and the per-frame outputs' length,
    its step captured at first use on a card.  parallel/dp.py's
    encode_gops_batched runs it: ``start``, F ``feed``s, ``result``."""
    n, f, h, w = frames_y.shape
    frames_cap, dev = _frames_cap(f), frames_y.device
    kw = dict(yr=yr, ur=ur, q_level=q_level, row_cap=row_cap, frame_cap=frame_cap,
              seq_cap=seq_cap)
    return graphs.cached(("gop_batch", dev, n, h, w, yr, ur, q_level, row_cap, frame_cap,
                          seq_cap, frames_cap),
                         lambda: _GopBatch(dev, n, h, w, **kw, frames_cap=frames_cap))


def encode_frame_device(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no, *,
                        yr: int, ur: int, q_level: int, row_cap: int, frame_cap: int):
    """encode_frame_core as a compiled program (JAX models/encoder.py:136):
    one frame, its payload stored by the merge kernel.  ``i_frame`` and
    ``frame_no`` are 0-d int32 tensors on the frame's device, or ints.
    Returns encode_frame_core's six values.

    On a card a captured graph of the step is replayed: the host enqueues the
    copies of the six planes and the two GOP scalars into the program's
    inputs (8 launches, fewer where an input is the program's own tensor)
    and the graph (1).  The outputs are the graph's
    tensors, rewritten by the next call of a program of the same geometry,
    knobs and caps: clone what you keep.  On the CPU the step runs
    eagerly."""
    h, w = y444.shape
    kw = dict(yr=yr, ur=ur, q_level=q_level, row_cap=row_cap, frame_cap=frame_cap)
    dev = y444.device
    prog = graphs.cached(("frame", dev, h, w, yr, ur, q_level, row_cap, frame_cap),
                         lambda: _FrameProgram(dev, h, w, **kw))
    return prog((y444, u444, v444), (prev_y, prev_u, prev_v), i_frame, frame_no)


def encode_gop_scan(frames_y, frames_u, frames_v, prev_y, prev_u, prev_v,
                    i_frame0, frame_no0, pframes_count, *, yr: int, ur: int,
                    q_level: int, row_cap: int, frame_cap: int, seq_cap: int):
    """encode_gop_scan_core as a compiled program (JAX models/encoder.py:268):
    (F, H, W) frame stacks appended to one sequence buffer, the GOP position
    and the frame number carried on the device.  ``i_frame0``,
    ``frame_no0`` and ``pframes_count`` are 0-d int32 tensors on the
    frames' device, or ints.  Returns JAX's ten values: (recon_y, recon_u,
    recon_v, seq_words (seq_cap + frame_cap + 1,) int64, seq_bits, i_frame,
    frame_no (0-d int32), overflow, frame_bits (F,) int64, frame_i_frames
    (F,) int32).

    On a card one frame's step is a captured graph, replayed F times, whose
    first kernel reads frame k of the stacks where they lie: per frame the
    host enqueues the graph's launch alone (1 launch), and per chunk 18
    more (the stacks' table: 6 writes; the carry set: 3 plane copies, 3
    scalars, 4 zeroings; the overflow's last term: 2), 13 where the recon
    planes, the GOP position and the frame number passed in are a previous
    call's outputs, since a copy of a tensor onto itself enqueues nothing.
    A stack whose frames' rows are not contiguous, or whose data or frame
    stride is not a multiple of 16 bytes, is first copied whole (1 launch
    more a plane and chunk).  ``utils/profiling`` counts each as
    ``host_launches``, the frames read in place as ``frames_in_place`` and
    the stacks copied as ``stack_copies``.  The program keeps the stacks
    until its next call.  The outputs are the program's tensors, rewritten
    by the next call of a program of the same geometry, knobs and caps:
    clone what you keep.  On the CPU the step runs eagerly."""
    f, h, w = frames_y.shape
    frames_cap = _frames_cap(f)
    kw = dict(yr=yr, ur=ur, q_level=q_level, row_cap=row_cap, frame_cap=frame_cap,
              seq_cap=seq_cap)
    dev = frames_y.device
    prog = graphs.cached(("gop", dev, h, w, yr, ur, q_level, row_cap, frame_cap, seq_cap,
                          frames_cap),
                         lambda: _GopProgram(dev, h, w, **kw, frames_cap=frames_cap))
    prog.start((frames_y, frames_u, frames_v), (prev_y, prev_u, prev_v), i_frame0, frame_no0,
               pframes_count)
    for _ in range(f):
        prog.feed()
    return prog.result(f)


def bound_caps(width: int, height: int) -> Tuple[int, int]:
    """(row_cap, frame_cap) that no frame of width x height can overflow:
    entropy's analytic bounds."""
    nbx, nby = width // 16, height // 16
    return entropy.slice_words_bound(nbx), entropy.frame_words_bound(nbx, nby)


def chunk_caps(row_cap: int, frame_cap: int, width: int, height: int,
               n: int) -> Tuple[dict, dict]:
    """An n-frame chunk's caps, ``row_cap``, ``frame_cap`` and ``seq_cap``:
    at the given row and frame caps with a sequence cap of a quarter of the
    chunk's frame caps (at least one), as the JAX package sizes it; then at
    ``bound_caps``, with a sequence cap of every frame at its bound, which
    nothing can overflow.  A single frame is a chunk of one, whose program
    takes no sequence cap."""
    bound_row, bound_frame = bound_caps(width, height)
    return (dict(row_cap=row_cap, frame_cap=frame_cap, seq_cap=frame_cap * max(1, n // 4)),
            dict(row_cap=bound_row, frame_cap=bound_frame, seq_cap=bound_frame * n))


def within_bounds(attempt, caps: Tuple[dict, dict], what: str):
    """The overflow retry: ``attempt(c)`` encodes at the caps ``c`` and
    returns its result, or None where the encode overflowed.  Runs it at
    ``caps[0]``; on an overflow counts ``overflow_retries`` and runs it
    again at ``caps[1]`` (``chunk_caps``' bounds), and raises if even that
    overflows.  ``what`` names the unit ("frame", "chunk") in the error."""
    result = attempt(caps[0])
    if result is None:
        # rare: the encode exceeded the caps; encode it again at the bounds
        count("overflow_retries")
        result = attempt(caps[1])
        if result is None:
            raise RuntimeError(f"{what} exceeded the analytic worst-case buffer bound")
    return result


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device: "cuda" (the kernels; raises if torch
    sees no card) or "cpu" (their plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def words_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    return np.asarray(words).astype(">u4").tobytes()[: (nbits + 7) // 8]


def payload_bytes(words: torch.Tensor, nbits: int) -> bytes:
    """The payload's bytes: the first ``nbits`` bits of ``words``, 32-bit
    words in stream order held in int64, on any device.  Only the words
    that hold those bits are sliced, where the words lie, and copied to the
    host."""
    return words_to_bytes(words[: (nbits + 31) // 32].cpu().numpy(), nbits)


def upload(array, dev) -> torch.Tensor:
    """``array`` as a uint8 tensor on ``dev``; torch wants writable host
    memory (JAX hands out read-only arrays)."""
    return torch.as_tensor(np.require(array, np.uint8, ["W"]), device=dev)


def _host_tensor(plane) -> torch.Tensor:
    """``plane`` as a uint8 CPU tensor over the caller's memory, to be read
    by a copy: another dtype is converted, and negative strides, which torch
    cannot view, are copied first.  A read-only array (the JAX package hands
    them out) is taken as it is, since nothing writes through the view."""
    a = np.asarray(plane, dtype=np.uint8)
    if min(a.strides, default=0) < 0:
        a = np.ascontiguousarray(a)
    if a.flags.writeable:
        return torch.from_numpy(a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # torch's warning on read-only arrays
        return torch.from_numpy(a)


class _Staging:
    """Encoder.push_chunk's transfers on a card, through page-locked host
    memory allocated once for a geometry and reused by every chunk.

    Frames in: a ring of STAGING_SLOTS frame slots.  The host's cores copy
    frame k's three planes into slot k mod STAGING_SLOTS (torch's parallel
    CPU copy), then the slot's copy to index k of a device stack is
    enqueued without blocking, so the DMA of frame k runs while the host
    copies frame k + 1.  A slot is written again only once the DMA out of it
    has ended: an event recorded after each slot's DMA, waited on (counted
    as ``staging_waits``) where it has not yet passed.  The device stack,
    (frames, 3, H, W), grows to the longest chunk and is kept; its DMAs and
    the program that reads it go to the same stream, in that order.

    Payload out: the words are copied into a page-locked int64 buffer that
    grows, to a power of two, only when a payload outgrows it.

    On the CPU (the tests of the ring's bookkeeping) the slots and the
    buffer are ordinary memory and each copy ends before the next starts:
    nothing is waited on."""

    def __init__(self, dev: torch.device, h: int, w: int):
        pin = dev.type == "cuda"
        self.dev, self.shape, self._pin = dev, (h, w), pin
        self.slots = torch.empty((STAGING_SLOTS, 3, h, w), dtype=torch.uint8, pin_memory=pin)
        self._copied = [torch.cuda.Event() if pin else None for _ in range(STAGING_SLOTS)]
        self.stack = torch.empty((0, 3, h, w), dtype=torch.uint8, device=dev)
        self.words = torch.empty(0, dtype=torch.int64, pin_memory=pin)

    def upload(self, frames, first: int):
        """The chunk's frames (``(y, u, v)`` host planes of the staging's
        geometry) copied to the device: three (F, H, W) views of the device
        stack, Y, U and V.  The caller's arrays are only read, and are free
        to change once this returns."""
        n = len(frames)
        if len(self.stack) < n:
            self.stack = torch.empty((n, 3, *self.shape), dtype=torch.uint8, device=self.dev)
        stream = torch.cuda.current_stream(self.dev) if self._pin else None
        for k, frame in enumerate(frames):
            slot, copied = self.slots[k % STAGING_SLOTS], self._copied[k % STAGING_SLOTS]
            with span("push_chunk.upload", first):
                if copied is not None and not copied.query():
                    count("staging_waits")
                    copied.synchronize()
            with span("push_chunk.stack", first):
                for dst, plane in zip(slot, frame):
                    dst.copy_(_host_tensor(plane))
            with span("push_chunk.upload", first):
                self.stack[k].copy_(slot, non_blocking=True)
                if copied is not None:
                    copied.record(stream)
        count("staged_frames", n)
        return tuple(self.stack[:n, i] for i in range(3))

    def download(self, words: torch.Tensor, nbits: int) -> bytes:
        """The payload's ``nbits`` bits of ``words`` (the device's int64
        words), through the page-locked buffer."""
        n = (nbits + 31) // 32
        if len(self.words) < n:
            self.words = torch.empty(1 << (n - 1).bit_length(), dtype=torch.int64,
                                     pin_memory=self._pin)
        self.words[:n].copy_(words[:n])
        return payload_bytes(self.words, nbits)


class Encoder:
    """MPEG-2 encoder on one torch device.

    API mirrors the reference module contract (RTL/mpeg2encoder.v:10-38):
    construction-time quality/range knobs, per-sequence size/GOP configuration,
    multi-sequence reuse after each ``encode``/``finish``.

    Two operating modes:
    * streaming (``start_sequence``/``push_frame``/``finish``): payload bytes
      downloaded per frame;
    * chunked (``encode`` with ``chunk_frames > 1``, or ``push_chunk``): frames
      staged on the device and encoded in one pass, with one payload download
      per chunk - the high-throughput path; on a card both transfers go
      through page-locked buffers the encoder keeps.
    Both go through the compiled programs (``encode_frame_device``,
    ``encode_gop_scan``), the overflow retry too, and keep clones of their
    outputs; the GOP position and the frame number stay host ints here.

    ``device`` is where the encoder runs: "cuda" launches the kernels and
    raises if no card is present; "cpu" runs their plain versions.
    """

    def __init__(self, config: EncoderConfig = EncoderConfig(),
                 row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.row_cap = row_cap
        self.frame_cap = frame_cap
        self._staging = None
        self._seq = None
        self._reset_sequence_state()

    # ------------------------------------------------------------------ one-shot
    def encode(self, frames444: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
               width: int, height: int, pframes_count: int = 23,
               stop_mode: str = "clean", partial_groups: int = 0,
               chunk_frames: int = 1) -> bytes:
        """Encode a full sequence of YUV 4:4:4 frames to an MPEG-2 elementary stream."""
        self.start_sequence(SequenceConfig(width, height, pframes_count))
        last = len(frames444) - 1
        if chunk_frames > 1:
            fixed = list(frames444)
            if stop_mode == "partial":
                fixed[last] = self._pad_partial(fixed[last], partial_groups)
            for i in range(0, len(fixed), chunk_frames):
                self.push_chunk(fixed[i:i + chunk_frames])
            return self.finish()
        for idx, f in enumerate(frames444):
            if stop_mode == "partial" and idx == last:
                self.push_frame(*self._pad_partial(f, partial_groups))
            else:
                self.push_frame(*f)
        return self.finish(stop_mode=stop_mode)

    # ---------------------------------------------------------------- streaming
    def start_sequence(self, seq: SequenceConfig) -> None:
        if self._seq is not None:
            raise RuntimeError("sequence already active; call finish() first")
        seq = seq.validate(self.config)
        self._seq = seq
        self._payload: List[bytes] = [sequence_start(seq.width, seq.height)]
        self._i_frame = 0
        self._frame_no = 0
        self._prev = None
        self.stats = SequenceStats(width=seq.width, height=seq.height)

    # ------------------------------------------------------------- checkpointing
    def get_state(self) -> EncoderState:
        """Snapshot the complete inter-frame state: recon reference frame, GOP
        index, timecode counter, emitted bytes."""
        seq = self._require_seq()
        prev = None if self._prev is None else [p.cpu().numpy() for p in self._prev]
        return EncoderState(
            width=seq.width, height=seq.height, pframes_count=seq.pframes_count,
            i_frame=self._i_frame, frame_no=self._frame_no,
            recon_y=None if prev is None else prev[0],
            recon_u=None if prev is None else prev[1],
            recon_v=None if prev is None else prev[2],
            payload=b"".join(self._payload))

    def set_state(self, state: EncoderState) -> None:
        """Resume a sequence from a checkpoint (this package's EncoderState or
        the JAX package's: recon planes as numpy arrays); continues bit-exactly."""
        if self._seq is not None:
            raise RuntimeError("sequence already active; call finish() first")
        self._seq = SequenceConfig(state.width, state.height,
                                   state.pframes_count).validate(self.config)
        self._payload = [state.payload]
        self._i_frame = state.i_frame
        self._frame_no = state.frame_no
        if state.recon_y is None:
            self._prev = None
        else:
            self._prev = tuple(upload(p, self.device) for p in
                               (state.recon_y, state.recon_u, state.recon_v))
        self.stats = SequenceStats(width=state.width, height=state.height)

    def _staging_for(self, seq: SequenceConfig) -> _Staging:
        """push_chunk's page-locked buffers, made at the first chunk of a
        geometry and kept while the geometry stays."""
        if self._staging is None or self._staging.shape != (seq.height, seq.width):
            self._staging = _Staging(self.device, seq.height, seq.width)
        return self._staging

    def _kw(self):
        return dict(yr=self.config.yr, ur=self.config.ur, q_level=self.config.q_level)

    def _zero_prev(self):
        return _planes(self.device, self._seq.height, self._seq.width, 2)

    def _check_frame_shape(self, frame, seq) -> None:
        """Reject frames that don't match the LATCHED sequence geometry with a
        clear error.  All three 4:4:4 planes are (H, W).  The latched size may
        be smaller than requested: SequenceConfig.validate clamps to the
        EncoderConfig's max geometry like the RTL does
        (RTL/mpeg2encoder.v:985-991)."""
        want = (seq.height, seq.width)
        mh, mw = self.config.max_height, self.config.max_width
        for name, plane in zip("yuv", frame):
            shape = tuple(plane.shape)
            if shape == want:
                continue
            hint = ""
            if any(s > m for s, m in zip(shape, (mh, mw))):
                hint = (f"; frame exceeds this EncoderConfig's max geometry "
                        f"{mw}x{mh} (xl={self.config.xl}, yl={self.config.yl})"
                        f" - the requested sequence size was clamped")
            raise ValueError(f"{name} plane shape {shape} != latched "
                             f"sequence geometry {want}{hint}")

    def push_frame(self, y, u, v) -> None:
        """Feed one YUV 4:4:4 frame (uint8 (H, W) planes)."""
        t_start = time.perf_counter()
        seq = self._require_seq()
        first = self._frame_no
        with span("push_frame", first):
            self._check_frame_shape((y, u, v), seq)
            if self._prev is None:
                self._prev = self._zero_prev()
            with span("push_frame.upload", first):
                planes = tuple(upload(p, self.device) for p in (y, u, v))
            args = (*planes, *self._prev, self._i_frame, self._frame_no)

            def attempt(caps):
                with span("push_frame.program", first):
                    ry, ru, rv, fw, fb, ovf = encode_frame_device(
                        *args, **self._kw(), row_cap=caps["row_cap"],
                        frame_cap=caps["frame_cap"])
                with span("push_frame.sync", first):
                    count("host_syncs")
                    if bool(ovf):
                        return None
                    count("host_syncs")
                    return ry, ru, rv, fw, int(fb)
            ry, ru, rv, fw, nbits = within_bounds(
                attempt, chunk_caps(self.row_cap, self.frame_cap, seq.width, seq.height, 1),
                "frame")
            with span("push_frame.download", first):
                count("host_syncs")
                payload = payload_bytes(fw, nbits)
            with span("push_frame.carry", first):
                # the program's outputs are rewritten by its next call
                self._prev = (ry.clone(), ru.clone(), rv.clone())
                self._payload.append(payload)
                self.stats.add(index=self._frame_no, i_frame=self._i_frame, bits=nbits,
                               wall_s=time.perf_counter() - t_start)
                self._i_frame = next_i_frame(self._i_frame, seq.pframes_count)
                self._frame_no += 1

    def push_chunk(self, frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]
                   ) -> None:
        """Feed several frames at once; encoded on the device in one pass.
        Each frame's ``stats`` entry holds its share of the chunk's wall
        time.  On a card the frames go up, and the payload comes back,
        through the encoder's page-locked buffers (``_Staging``); the
        frames' arrays are only read, and are the caller's again once this
        returns."""
        t_start = time.perf_counter()
        seq = self._require_seq()
        first = self._frame_no
        if not len(frames):
            raise ValueError("push_chunk needs at least one frame")
        with span("push_chunk", first):
            for f in frames:
                self._check_frame_shape(f, seq)
            if self._prev is None:
                self._prev = self._zero_prev()
            if self.device.type == "cuda":
                staging = self._staging_for(seq)
                stacks = staging.upload(frames, first)
            else:
                staging = None
                with span("push_chunk.stack", first):
                    host = [np.stack([np.asarray(f[i]) for f in frames]) for i in range(3)]
                with span("push_chunk.upload", first):
                    stacks = [upload(h, self.device) for h in host]
            args = (*stacks, *self._prev, self._i_frame, self._frame_no, seq.pframes_count)

            def attempt(caps):
                with span("push_chunk.program", first):
                    ry, ru, rv, sw, sb, i_f, fno, ovf, fbits, fifs = encode_gop_scan(
                        *args, **self._kw(), **caps)
                with span("push_chunk.sync", first):
                    count("host_syncs")
                    if bool(ovf):
                        return None
                    count("host_syncs", 5)
                    return (ry, ru, rv, sw, int(sb), fbits.tolist(), fifs.tolist(), int(i_f),
                            int(fno))
            ry, ru, rv, sw, nbits, bits, i_frames, i_next, fno_next = within_bounds(
                attempt, chunk_caps(self.row_cap, self.frame_cap, seq.width, seq.height,
                                    len(frames)), "chunk")
            with span("push_chunk.download", first):
                count("host_syncs")
                payload = (payload_bytes(sw, nbits) if staging is None
                           else staging.download(sw, nbits))
            with span("push_chunk.carry", first):
                # the program's outputs are rewritten by its next call
                self._prev = (ry.clone(), ru.clone(), rv.clone())
                self._payload.append(payload)
                wall_s = (time.perf_counter() - t_start) / len(frames)
                for k, (b, i_frame) in enumerate(zip(bits, i_frames)):
                    self.stats.add(index=first + k, i_frame=i_frame, bits=b, wall_s=wall_s)
                self._i_frame, self._frame_no = i_next, fno_next

    def finish(self, stop_mode: str = "clean") -> bytes:
        """End the sequence (i_sequence_stop semantics) and return the stream.

        'clean' and 'coincident' produce identical streams: the RTL's raster
        counters index the group accepted THIS cycle, so stop asserted on the
        last pixel cycle finds the frame complete and pads nothing
        (RTL:1048-1058, 1070-1079).  Mid-frame stops are expressed by pushing a
        partially-fed frame (``encode(stop_mode='partial')``)."""
        self._require_seq()
        data = b"".join(self._payload)
        data += sequence_end(len(data))
        self._seq = None
        self._reset_sequence_state()
        return data

    # ----------------------------------------------------------------- internals
    def _reset_sequence_state(self) -> None:
        self._payload = []
        self._prev = None
        self._i_frame = 0
        self._frame_no = 0

    def _require_seq(self) -> SequenceConfig:
        if self._seq is None:
            raise RuntimeError("no active sequence; call start_sequence() first")
        return self._seq

    def _pad_partial(self, frame, partial_groups: int):
        if partial_groups < 1:
            raise ValueError("partial_groups must be >= 1 (SEQ_ENDING is only "
                             "reachable after a group was accepted, RTL:1081-1093)")
        seq = self._require_seq()
        h, w = seq.height, seq.width
        y, u, v = (np.array(p, copy=True) for p in frame)
        flat = np.arange(h * (w // 4)).reshape(h, w // 4) >= partial_groups
        mask = np.repeat(flat, 4, axis=1)
        y[mask], u[mask], v[mask] = 0, 128, 128
        return y, u, v
