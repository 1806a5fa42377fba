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
halo-padded previous planes; the factories add the communication around it.
The payload is BYTE-IDENTICAL to models/encoder.encode_frame_core's: packing
is per row and merging byte-aligned rows is associative.  The JAX package's
Mosaic demotion ladder has no counterpart: a kernel that fails raises.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.encoder import DEFAULT_FRAME_CAP, DEFAULT_ROW_CAP
from ..ops import colorspace, entropy, motion
from ..ops.kernels import me as k_me
from ..ops.kernels import pack as k_pack
from ..ops.kernels import transform as k_transform
from .halo import exchange_halo
from .mesh import local_range

HEADER_SLOTS = 16     # slots a header row is packed from (7 are used)


def make_local_step(nby: int, *, yr: int, ur: int, q_level: int, row_cap: int) -> Callable:
    """The per-shard frame step for a frame of ``nby`` macroblock rows:
    ``local_step(y, u, v, py_h, pu_h, pv_h, i_frame, frame_no, first_row)``
    with the shard's 4:4:4 planes (rows, W), its previous luma (rows + 16, W)
    and chroma (rows/2 + 8, W/2) with their halos, host ints for the GOP
    position, the frame number and the shard's first macroblock row ->
    (recon_y, recon_u, recon_v, row words (rows/16, row_cap) int64, row bits
    (rows/16,) int64, overflow () bool)."""
    def local_step(y, u, v, py_h, pu_h, pv_h, i_frame: int, frame_no: int,
                   first_row: int):
        ys, us, vs = colorspace.subsample_420(y, u, v)
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
               i_frame: int, frame_no: int, *, row_cap: int, frame_cap: int):
    """All of a frame's slice rows (nby, row_cap) words, (nby,) bits and
    their overflow flag -> (frame words (frame_cap,) int64, frame bits,
    overflow): the GOP/picture header rows packed by the pack kernel, put
    before the rows and merged by the merge kernel."""
    hdr = entropy._header_rows(i_frame, frame_no, HEADER_SLOTS, rows_w.device)
    hw, hb, hovf = k_pack.pack_slots(hdr, row_cap)
    fwords, fbits = k_pack.merge_rows(torch.cat([hw, rows_w]), torch.cat([hb, rows_b]),
                                      frame_cap)
    return fwords, fbits, rows_ovf | hovf | (fbits > 32 * frame_cap)


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


def make_sharded_frame_encoder(
    mesh: DeviceMesh, height: int, width: int, *, yr: int, ur: int, q_level: int,
    row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP,
    axis: str = "slice",
):
    """A slice-row-sharded single-frame encoder for this rank.

    Returns ``fn(y444, u444, v444, prev_y, prev_u, prev_v, i_frame,
    frame_no) -> (recon_y, recon_u, recon_v, fwords, fbits, overflow)``.
    The planes are this rank's rows (``local_range(height // 16, mesh,
    axis)`` macroblock rows; the recon outputs are the same rows, for the
    next frame); i_frame and frame_no are host ints; fwords (frame_cap,),
    fbits and overflow are the whole frame's, the same on every rank, and
    the payload is byte-identical to models/encoder.encode_frame_core's.

    Overflow contract: a set ``overflow`` means the payload was cut at
    ``row_cap``/``frame_cap`` and MUST NOT be shipped; re-encode the frame
    with larger caps (entropy.slice_words_bound / frame_words_bound)."""
    rows = local_range(height // 16, mesh, axis)
    shape = (16 * len(rows), width)
    group = mesh.get_group(axis)
    local_step = make_local_step(height // 16, yr=yr, ur=ur, q_level=q_level,
                                 row_cap=row_cap)

    def encode_frame(y444, u444, v444, prev_y, prev_u, prev_v, i_frame: int,
                     frame_no: int):
        if tuple(y444.shape) != shape or tuple(prev_y.shape) != shape:
            raise ValueError(f"this rank's planes are {shape}, given "
                             f"{tuple(y444.shape)} and {tuple(prev_y.shape)}")
        py_h = exchange_halo(prev_y, motion.LUMA_HALO, group)
        pu_h = exchange_halo(prev_u, motion.CHROMA_HALO, group)
        pv_h = exchange_halo(prev_v, motion.CHROMA_HALO, group)
        ry, ru, rv, words, bits, ovf = local_step(y444, u444, v444, py_h, pu_h, pv_h,
                                                  i_frame, frame_no, rows.start)
        rows_w, rows_b, rows_ovf = _gather_rows(words, bits, ovf, group)
        return (ry, ru, rv, *frame_tail(rows_w, rows_b, rows_ovf, i_frame, frame_no,
                                        row_cap=row_cap, frame_cap=frame_cap))

    return encode_frame


def make_sharded_batch_encoder(
    mesh: DeviceMesh, batch: int, height: int, width: int, *, yr: int, ur: int,
    q_level: int, row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP,
    stream_axis: str = "stream", slice_axis: str = "slice",
):
    """2-D composition: stream data parallelism x slice-row sharding.

    The batch's streams are split over ``stream_axis`` (no collectives) while
    each frame's macroblock rows are split over ``slice_axis`` (the halo
    exchange and the row gather, as make_sharded_frame_encoder).  Returns
    ``fn(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no)`` over
    this rank's block: (B_l, rows, W) planes of its streams
    (``local_range(batch, mesh, stream_axis)``) and their rows, and B_l host
    ints each for i_frame and frame_no -> (recon_y, recon_u, recon_v of the
    same block, fwords (B_l, frame_cap), fbits (B_l,), overflow (B_l,)); each
    stream's payload is byte-identical to models/encoder.encode_frame_core's,
    with the same overflow contract."""
    n_local = len(local_range(batch, mesh, stream_axis))
    encode_frame = make_sharded_frame_encoder(
        mesh, height, width, yr=yr, ur=ur, q_level=q_level, row_cap=row_cap,
        frame_cap=frame_cap, axis=slice_axis)

    def encode_frames(y444, u444, v444, prev_y, prev_u, prev_v,
                      i_frame: Sequence[int], frame_no: Sequence[int]):
        if y444.shape[0] != n_local:
            raise ValueError(f"{y444.shape[0]} streams given, this rank owns {n_local}")
        outs = [encode_frame(y444[b], u444[b], v444[b], prev_y[b], prev_u[b], prev_v[b],
                             int(i_frame[b]), int(frame_no[b])) for b in range(n_local)]
        return tuple(torch.stack(x) for x in zip(*outs))

    return encode_frames
