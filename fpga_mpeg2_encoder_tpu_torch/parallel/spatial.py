"""Slice-row sharding of the whole frame pipeline over ``torch.distributed``.

One frame's macroblock rows are sharded over the ranks of a mesh axis, and
every stage runs on the shard's own rows:

* 4:2:0 subsampling - row pairs never straddle a 16-row shard boundary;
* motion estimation - the only cross-shard dependency: the previous frame's
  reconstruction halo (8 luma / 4 chroma rows each side) comes from the
  neighbouring ranks (parallel/halo.py), and the motion kernel runs in its
  band form, masking frame-edge candidates by GLOBAL row so that a shard
  boundary is not taken for a frame edge;
* transform and reconstruction - per macroblock, local;
* symbolisation - slice rows are independent (DC/MV predictors reset per
  slice, RTL:2781-2792), their headers carry global row numbers, and the
  GOP/picture header rows are packed after the gather;
* packing - per row, local; the rows are gathered over the group and merged
  into the frame payload.

``local_step`` is a pure tensor function of a shard's rows and its
halo-padded previous planes; ``frame_tail`` packs the header rows and merges
every row of the frame.  The factories are the compiled programs, the
counterparts of the JAX package's jax.jit over shard_map: a rank's local
steps are one captured CUDA graph and its frame tails another
(runtime/graphs.py), over tensors the programs own, with the GOP position and
the frame number as int32 device tensors; the collectives (the halo exchange
into the local program's inputs, the row gather into the tail program's and
the overflow all-reduce) are enqueued between the two replays, so nothing in
a frame waits for the device on the host.  The collectives stay outside the
graphs: a capture of the halo sends and receives could only be checked with
two cards.  ``make_sharded_frame_encoder_core`` keeps the eager composition
as the reference the programs are held to, as models/encoder keeps its
``_core`` functions.  The payload is BYTE-IDENTICAL to
models/encoder.encode_frame_core's: packing is per row and merging
byte-aligned rows is associative.  The JAX package's Mosaic demotion ladder
has no counterpart: a kernel that fails raises, and so does a failed capture.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.encoder import DEFAULT_FRAME_CAP, DEFAULT_ROW_CAP, _copy_in
from ..ops import entropy, motion
from ..ops.kernels import colorspace as k_colorspace
from ..ops.kernels import glue as k_glue
from ..ops.kernels import me as k_me
from ..ops.kernels import pack as k_pack
from ..ops.kernels import transform as k_transform
from ..runtime import graphs
from .halo import exchange_halo
from .mesh import local_range

HEADER_SLOTS = 16     # slots a header row is packed from (7 are used)
HALOS = (motion.LUMA_HALO, motion.CHROMA_HALO, motion.CHROMA_HALO)


def make_local_step(nby: int, *, yr: int, ur: int, q_level: int, row_cap: int) -> Callable:
    """The per-shard frame step for a frame of ``nby`` macroblock rows:
    ``local_step(y, u, v, py_h, pu_h, pv_h, i_frame, frame_no, first_row)``
    with the shard's 4:4:4 planes (rows, W), its previous luma (rows + 16, W)
    and chroma (rows/2 + 8, W/2) with their halos, the GOP position and the
    frame number (0-d int32 tensors on the planes' device, or host ints) and
    the shard's first macroblock row (a host int) -> (recon_y, recon_u,
    recon_v, row words (rows/16, row_cap) int64, row bits (rows/16,) int64,
    overflow () bool)."""
    def local_step(y, u, v, py_h, pu_h, pv_h, i_frame, frame_no, first_row: int):
        ys, us, vs = k_colorspace.subsample_420(y, u, v)
        mr = k_me.estimate_and_predict_local(ys, py_h, pu_h, pv_h, i_frame == 0, yr, ur,
                                             first_row, nby, as_planes=True)
        quant_zig, ry, ru, rv = k_transform.transform_recon(
            ys, us, vs, mr.pred_y, mr.pred_u, mr.pred_v, mr.inter, q_level)
        slots = entropy.symbolize_frame(quant_zig, mr.inter, mr.mvx, mr.mvy, i_frame,
                                        frame_no, q_level, first_row=first_row,
                                        include_headers=False)
        words, bits, ovf = k_pack.pack_slots(slots, row_cap)
        return ry, ru, rv, words, bits, ovf

    return local_step


def band_with_halo(plane: torch.Tensor, halo: int, start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) of a whole-frame plane with ``halo`` rows each
    side, zero beyond the frame: what exchange_halo gives the rank that owns
    those rows."""
    return motion.pad_halo(plane, halo)[start:stop + 2 * halo]


def frame_tail(rows_w: torch.Tensor, rows_b: torch.Tensor, rows_ovf: torch.Tensor,
               i_frame, frame_no, *, row_cap: int, frame_cap: int):
    """All of a frame's slice rows (nby, row_cap) words, (nby,) bits and
    their overflow flag, with the GOP position and the frame number (0-d
    int32 tensors on the rows' device, or host ints) -> (frame words
    (frame_cap,) int64, frame bits, overflow): the GOP/picture header rows
    formed by the glue kernel and packed by the pack kernel, put before the rows and merged by the merge
    kernel."""
    hdr = k_glue.header_rows(i_frame, frame_no, HEADER_SLOTS, rows_w.device)
    hw, hb, hovf = k_pack.pack_slots(hdr, row_cap)
    fwords, fbits = k_pack.merge_rows(torch.cat([hw, rows_w]), torch.cat([hb, rows_b]),
                                      frame_cap)
    return fwords, fbits, rows_ovf | hovf | (fbits > 32 * frame_cap)


def _stack(xs):
    """One stream's tensor as a (1, ...) view, or several streams' stacked."""
    return xs[0].unsqueeze(0) if len(xs) == 1 else torch.stack(xs)


def _set_scalars(dst: torch.Tensor, vals, name: str) -> None:
    """The (B,) int32 tensor ``dst`` <- ``vals``: a (B,) int32 tensor on its
    device (copied), or B host ints or 0-d tensors there (filled or copied
    element by element).  Nothing is uploaded and nothing waits for the
    device."""
    if torch.is_tensor(vals) and vals.dim() == 1:
        _copy_in(dst, vals, name)
        return
    vals = list(vals)
    if len(vals) != dst.shape[0]:
        raise ValueError(f"{name}: {len(vals)} values for {dst.shape[0]} streams")
    for b, v in enumerate(vals):
        entropy.gop_scalar(v, dst.device, out=dst[b])


class LocalProgram:
    """One shard's local steps for B streams on one device, replayed from a
    captured graph (on the CPU, run eagerly): local_step of each stream on
    the program's tensors ``frame`` (three (B, rows, W) 4:4:4 planes),
    ``prev`` (the halo-padded previous planes, (B, rows + 16, W) and two of
    (B, rows/2 + 8, W/2), zero at construction) and ``i_frame`` and
    ``frame_no`` ((B,) int32).  ``step()`` -> (recon_y, recon_u, recon_v
    (B, rows, W) and (B, rows/2, W/2), row words (B, rows/16, row_cap),
    row bits (B, rows/16), overflow flags (B,) int32), the graph's tensors,
    rewritten by the next replay.  ``first_row`` (the shard's first
    macroblock row) and ``nby`` (the frame's) are fixed: they are in the
    cache key of ``local_program``."""

    def __init__(self, dev, streams: int, nby: int, first_row: int, mb_rows: int,
                 width: int, *, yr: int, ur: int, q_level: int, row_cap: int):
        h, w = 16 * mb_rows, width
        self.frame = tuple(torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
                           for _ in range(3))
        self.prev = tuple(torch.zeros((streams, rows + 2 * halo, cols), dtype=torch.uint8,
                                      device=dev)
                          for (rows, cols), halo in zip(((h, w), (h // 2, w // 2),
                                                         (h // 2, w // 2)), HALOS))
        self.i_frame, self.frame_no = (torch.zeros(streams, dtype=torch.int32, device=dev)
                                       for _ in range(2))
        self.first_row = first_row
        self._local_step = make_local_step(nby, yr=yr, ur=ur, q_level=q_level,
                                           row_cap=row_cap)
        self.step = graphs.Step(self._run, dev, "shard_local")

    def _run(self):
        outs = [self._local_step(*(p[b] for p in self.frame), *(p[b] for p in self.prev),
                                 self.i_frame[b], self.frame_no[b], self.first_row)
                for b in range(self.i_frame.shape[0])]
        ry, ru, rv, words, bits, ovf = (_stack(x) for x in zip(*outs))
        return ry, ru, rv, words, bits, ovf.to(torch.int32)

    def load(self, planes, i_frame, frame_no) -> None:
        """Copy the three 4:4:4 planes (B, rows, W) and set the B streams'
        GOP positions and frame numbers (see _set_scalars)."""
        for dst, src, name in zip(self.frame, planes, ("y444", "u444", "v444")):
            _copy_in(dst, src, name)
        _set_scalars(self.i_frame, i_frame, "i_frame")
        _set_scalars(self.frame_no, frame_no, "frame_no")


class TailProgram:
    """The frame tails of B streams whose rows come from ``shards`` shards of
    ``mb_rows`` rows each, replayed from a captured graph (on the CPU, run
    eagerly): frame_tail of each stream on the program's tensors ``words``
    (shards * B, mb_rows, row_cap) int64 and ``bits`` (shards * B, mb_rows)
    int64, shard-major (as all_gather_into_tensor lays out the shards' (B,
    ...) blocks), ``flags`` (B,) int32 (nonzero: a row overflowed) and
    ``i_frame`` and ``frame_no`` (B,) int32.  ``step()`` -> (frame words
    (B, frame_cap) int64, frame bits (B,), overflow (B,) bool), the graph's
    tensors, rewritten by the next replay."""

    def __init__(self, dev, streams: int, shards: int, mb_rows: int, *, row_cap: int,
                 frame_cap: int):
        self.shape = (shards, streams, mb_rows)
        self.words = torch.zeros((shards * streams, mb_rows, row_cap), dtype=torch.int64,
                                 device=dev)
        self.bits = torch.zeros((shards * streams, mb_rows), dtype=torch.int64, device=dev)
        self.flags, self.i_frame, self.frame_no = (
            torch.zeros(streams, dtype=torch.int32, device=dev) for _ in range(3))
        self._caps = dict(row_cap=row_cap, frame_cap=frame_cap)
        self.step = graphs.Step(self._run, dev, "shard_tail")

    def _run(self):
        words = self.words.view(*self.shape, -1)
        bits = self.bits.view(self.shape)
        outs = [frame_tail(words[:, b].reshape(-1, words.shape[-1]), bits[:, b].reshape(-1),
                           self.flags[b] > 0, self.i_frame[b], self.frame_no[b], **self._caps)
                for b in range(self.shape[1])]
        return tuple(_stack(x) for x in zip(*outs))

    def load(self, i_frame, frame_no) -> None:
        """Set the B streams' GOP positions and frame numbers (see
        _set_scalars)."""
        _set_scalars(self.i_frame, i_frame, "i_frame")
        _set_scalars(self.frame_no, frame_no, "frame_no")


def local_program(dev, streams: int, nby: int, first_row: int, mb_rows: int, width: int,
                  *, yr: int, ur: int, q_level: int, row_cap: int) -> LocalProgram:
    """The LocalProgram of this geometry, knobs and cap on ``dev``, cached
    (graphs.cached): a program of the same key is shared, and its outputs
    are rewritten by whichever caller replays it next."""
    dev = torch.device(dev)
    return graphs.cached(
        ("shard_local", dev, streams, nby, first_row, mb_rows, width, yr, ur, q_level,
         row_cap),
        lambda: LocalProgram(dev, streams, nby, first_row, mb_rows, width, yr=yr, ur=ur,
                             q_level=q_level, row_cap=row_cap))


def tail_program(dev, streams: int, shards: int, mb_rows: int, *, row_cap: int,
                 frame_cap: int) -> TailProgram:
    """The TailProgram of this geometry and these caps on ``dev``, cached
    as local_program."""
    dev = torch.device(dev)
    return graphs.cached(
        ("shard_tail", dev, streams, shards, mb_rows, row_cap, frame_cap),
        lambda: TailProgram(dev, streams, shards, mb_rows, row_cap=row_cap,
                            frame_cap=frame_cap))


def _gather_rows(words, bits, ovf, group):
    """This rank's rows -> every rank's, in rank order, and the overflow
    flag reduced over the group."""
    n = dist.get_world_size(group)
    all_w = [torch.empty_like(words) for _ in range(n)]
    all_b = [torch.empty_like(bits) for _ in range(n)]
    dist.all_gather(all_w, words, group=group)
    dist.all_gather(all_b, bits, group=group)
    flag = ovf.to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return torch.cat(all_w), torch.cat(all_b), flag[0] > 0


def make_sharded_frame_encoder_core(
    mesh: DeviceMesh, height: int, width: int, *, yr: int, ur: int, q_level: int,
    row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP,
    axis: str = "slice",
):
    """The eager form of make_sharded_frame_encoder, its reference: the same
    function, each kernel and collective issued from the host a frame at a
    time, new tensors returned by every call."""
    rows = local_range(height // 16, mesh, axis)
    shape = (16 * len(rows), width)
    group = mesh.get_group(axis)
    local_step = make_local_step(height // 16, yr=yr, ur=ur, q_level=q_level,
                                 row_cap=row_cap)

    def encode_frame(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no):
        if tuple(y444.shape) != shape or tuple(prev_y.shape) != shape:
            raise ValueError(f"this rank's planes are {shape}, given "
                             f"{tuple(y444.shape)} and {tuple(prev_y.shape)}")
        py_h, pu_h, pv_h = (exchange_halo(p, halo, group)
                            for p, halo in zip((prev_y, prev_u, prev_v), HALOS))
        ry, ru, rv, words, bits, ovf = local_step(y444, u444, v444, py_h, pu_h, pv_h,
                                                  i_frame, frame_no, rows.start)
        rows_w, rows_b, rows_ovf = _gather_rows(words, bits, ovf, group)
        return (ry, ru, rv, *frame_tail(rows_w, rows_b, rows_ovf, i_frame, frame_no,
                                        row_cap=row_cap, frame_cap=frame_cap))

    return encode_frame


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block_encoder(mesh: DeviceMesh, streams: int, height: int, width: int, *, yr: int,
                   ur: int, q_level: int, row_cap: int, frame_cap: int, axis: str):
    """This rank's programs for ``streams`` streams of its slice rows along
    ``axis`` -> ``encode(planes, prev, i_frame, frame_no)`` over (B, rows,
    W) 4:4:4 planes, their (B, rows, W) and (B, rows/2, W/2) previous recons
    and B GOP positions and frame numbers: the planes copied in, the halos
    exchanged into the local program's inputs, its replay, the rows gathered
    into the tail program's inputs and the flags reduced, the tail's
    replay -> (recon_y, recon_u, recon_v, fwords (B, frame_cap), fbits
    (B,), overflow (B,)), the programs' tensors."""
    nby = height // 16
    rows = local_range(nby, mesh, axis)
    group = mesh.get_group(axis)
    dev = _mesh_device(mesh)
    local = local_program(dev, streams, nby, rows.start, len(rows), width, yr=yr, ur=ur,
                          q_level=q_level, row_cap=row_cap)
    tail = tail_program(dev, streams, mesh[axis].size(), len(rows), row_cap=row_cap,
                        frame_cap=frame_cap)

    def encode(planes, prev, i_frame, frame_no):
        local.load(planes, i_frame, frame_no)
        for x, out, halo in zip(prev, local.prev, HALOS):
            exchange_halo(x, halo, group, out=out)
        ry, ru, rv, words, bits, flags = local.step()
        dist.all_gather_into_tensor(tail.words, words, group=group)
        dist.all_gather_into_tensor(tail.bits, bits, group=group)
        tail.flags.copy_(flags)
        dist.all_reduce(tail.flags, op=dist.ReduceOp.MAX, group=group)
        tail.load(local.i_frame, local.frame_no)
        return (ry, ru, rv, *tail.step())

    return encode


def make_sharded_frame_encoder(
    mesh: DeviceMesh, height: int, width: int, *, yr: int, ur: int, q_level: int,
    row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP,
    axis: str = "slice",
):
    """A slice-row-sharded single-frame encoder for this rank, as a compiled
    program (JAX parallel/spatial.py:158).

    Returns ``fn(y444, u444, v444, prev_y, prev_u, prev_v, i_frame,
    frame_no) -> (recon_y, recon_u, recon_v, fwords, fbits, overflow)``.
    The planes are this rank's rows (``local_range(height // 16, mesh,
    axis)`` macroblock rows; the recon outputs are the same rows, for the
    next frame); i_frame and frame_no are host ints or 0-d int32 tensors on
    the rank's device; fwords (frame_cap,), fbits and overflow are the whole
    frame's, the same on every rank, and the payload is byte-identical to
    models/encoder.encode_frame_core's.

    On a card each frame enqueues the copies of the three planes and the two
    scalars, the halo exchange into the local program's inputs, the local
    graph's replay (F, T, A and P), the row gather and the flag's
    all-reduce into the tail program's inputs and the tail graph's replay
    (P on the header rows, M): nothing waits for the device.  The outputs
    are the programs' tensors, rewritten by the next call of a program of
    the same geometry, knobs and caps: clone what you keep (passing the
    recon back as the next frame's prev is safe, as every read of it is
    ordered before the replay that rewrites it).  On the CPU the programs
    run eagerly over gloo.

    Overflow contract: a set ``overflow`` means the payload was cut at
    ``row_cap``/``frame_cap`` and MUST NOT be shipped; re-encode the frame
    with larger caps (entropy.slice_words_bound / frame_words_bound)."""
    encode = _block_encoder(mesh, 1, height, width, yr=yr, ur=ur, q_level=q_level,
                            row_cap=row_cap, frame_cap=frame_cap, axis=axis)

    def encode_frame(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no):
        out = encode(tuple(p.unsqueeze(0) for p in (y444, u444, v444)),
                     tuple(p.unsqueeze(0) for p in (prev_y, prev_u, prev_v)),
                     (i_frame,), (frame_no,))
        return tuple(o[0] for o in out)

    return encode_frame


def make_sharded_batch_encoder(
    mesh: DeviceMesh, batch: int, height: int, width: int, *, yr: int, ur: int,
    q_level: int, row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP,
    stream_axis: str = "stream", slice_axis: str = "slice",
):
    """2-D composition: stream data parallelism x slice-row sharding, as one
    compiled program over this rank's streams (JAX parallel/spatial.py:243).

    The batch's streams are split over ``stream_axis`` (no collectives) while
    each frame's macroblock rows are split over ``slice_axis``.  Returns
    ``fn(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no)`` over
    this rank's block: (B_l, rows, W) planes of its streams
    (``local_range(batch, mesh, stream_axis)``) and their rows, and i_frame
    and frame_no as (B_l,) int32 tensors on the rank's device or B_l host
    ints -> (recon_y, recon_u, recon_v of the same block, fwords (B_l,
    frame_cap), fbits (B_l,), overflow (B_l,)); each stream's payload is
    byte-identical to models/encoder.encode_frame_core's, with
    make_sharded_frame_encoder's overflow contract.  One local graph runs
    the B_l streams' local steps and one tail graph their frame tails; each
    frame makes one halo exchange a plane, one all_gather of the words, one
    of the bits and one all_reduce for all B_l streams.  The outputs are
    the programs' tensors, as make_sharded_frame_encoder's."""
    n_local = len(local_range(batch, mesh, stream_axis))
    encode = _block_encoder(mesh, n_local, height, width, yr=yr, ur=ur, q_level=q_level,
                            row_cap=row_cap, frame_cap=frame_cap, axis=slice_axis)

    def encode_frames(y444, u444, v444, prev_y, prev_u, prev_v, i_frame: Sequence,
                      frame_no: Sequence):
        if y444.shape[0] != n_local:
            raise ValueError(f"{y444.shape[0]} streams given, this rank owns {n_local}")
        return encode((y444, u444, v444), (prev_y, prev_u, prev_v), i_frame, frame_no)

    return encode_frames


def make_shards_encoder(device, shards: int, height: int, width: int, *, yr: int, ur: int,
                        q_level: int, row_cap: int = DEFAULT_ROW_CAP,
                        frame_cap: int = DEFAULT_FRAME_CAP):
    """All ``shards`` slice shards of a frame on one device, in this process:
    each shard's LocalProgram on its rows, its halos cut from the whole
    previous recon (band_with_halo: what exchange_halo delivers), the rows
    copied into the TailProgram's inputs as the gather lays them out, then
    the tail.  Returns ``fn(y444, u444, v444, prev_y, prev_u, prev_v,
    i_frame, frame_no)`` over whole planes -> encode_frame_core's six
    values: the recon a new tensor, the payload, bits and flag the tail
    program's.  It checks the sharded programs on one card, where NCCL
    cannot give two ranks."""
    dev = torch.device(device)
    nby = height // 16
    if nby % shards:
        raise ValueError(f"{nby} macroblock rows do not divide {shards} shards")
    per = nby // shards
    locals_ = [local_program(dev, 1, nby, k * per, per, width, yr=yr, ur=ur,
                             q_level=q_level, row_cap=row_cap) for k in range(shards)]
    tail = tail_program(dev, 1, shards, per, row_cap=row_cap, frame_cap=frame_cap)

    def encode_frame(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no):
        recon = []
        for k, local in enumerate(locals_):
            a, b = 16 * per * k, 16 * per * (k + 1)
            local.load(tuple(p[a:b].unsqueeze(0) for p in (y444, u444, v444)), (i_frame,),
                       (frame_no,))
            for dst, plane, halo, sub in zip(local.prev, (prev_y, prev_u, prev_v), HALOS,
                                             (1, 2, 2)):
                dst[0].copy_(band_with_halo(plane, halo, a // sub, b // sub))
            ry, ru, rv, words, bits, flags = local.step()
            tail.words[k].copy_(words[0])
            tail.bits[k].copy_(bits[0])
            if k == 0:
                tail.flags.copy_(flags)
            else:
                torch.maximum(tail.flags, flags, out=tail.flags)
            recon.append((ry[0], ru[0], rv[0]))
        tail.load(locals_[0].i_frame, locals_[0].frame_no)
        fwords, fbits, ovf = tail.step()
        return (*(torch.cat(p) for p in zip(*recon)), fwords[0], fbits[0], ovf[0])

    return encode_frame
