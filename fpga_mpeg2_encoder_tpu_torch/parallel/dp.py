"""Data-parallel multi-stream encoding: a batch of independent video streams,
all on one device or split over the ranks of a ``stream`` mesh.

The counterpart of deploying N copies of the reference IP (BASELINE config
5: "Batched 8-stream 1080p ... per-chip stream isolation").  Streams never
communicate, so each stream's bytes are those of a single-stream encode
whatever the batch or the mesh.  Every kernel takes one frame.

``encode_gops_batched`` runs the batch program (models/encoder.gop_batch):
the B streams' carries side by side in (B, ...) stacks, each stream's step
the single-stream program's step on its row, and the B steps the branches
of one captured graph, so that on a card one replay encodes the next frame
of every stream, the streams' kernels running concurrently, each branch on
a CUDA stream of its own (runtime/graphs.py).  A call enqueues from the host
about 10 operations (the stacks' plane tables and the GOP state uploaded,
the recons copied, the buffers zeroed, the overflow formed) and one replay a
frame-step, and returns the program's stacks themselves: the next call with
the same key rewrites them.  On the CPU the branches run eagerly, one after
another.  Given another single-stream program (``program``, a function with
``encode_gop_scan``'s contract), it loops over the streams instead, each
stream's outputs copied out of that program's tensors before the next
stream's call; ``encode_frames_batched`` loops over ``encode_frame_device``
the same way.  A stream axis in the kernels' grids is the later option where
a trace shows kernels that still run alone.  The batch functions' spans
(``batch.*``) and counters are listed in ``utils/profiling``.

Unlike the JAX package there is no statistical level budget (``budget_bps``):
a row overflows exactly when its bits exceed 32 * row_cap, and an
overflowing batch is encoded again, every stream of it, at
``models.encoder.bound_caps`` through ``Encoder``'s overflow retry
(``models.encoder.within_bounds``, which counts it in ``overflow_retries``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import EncoderConfig, SequenceConfig
from ..core.bitstream import sequence_end, sequence_start
from ..models.encoder import (
    DEFAULT_FRAME_CAP,
    DEFAULT_ROW_CAP,
    chunk_caps,
    encode_frame_device,
    gop_batch,
    next_i_frame,
    payload_bytes,
    resolve_device,
    upload,
    within_bounds,
)
from ..utils.profiling import count, span
from .mesh import local_range

Frame = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _each_stream(n: int, encode) -> List[torch.Tensor]:
    """``encode(b)`` for each of n streams, its outputs copied into (n, ...)
    stacks made at stream 0: a program's outputs are rewritten by its next
    call.  torch.empty enqueues nothing; each copy is one launch."""
    outs: List[torch.Tensor] = []
    for b in range(n):
        with span("batch.stream", b):
            values = encode(b)
        with span("batch.collect", b):
            if b == 0:
                outs = [torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
                        for v in values]
            for out, v in zip(outs, values):
                out[b].copy_(v)
            count("host_launches", len(values))
        count("batch_streams")
    return outs


def encode_frames_batched(y444, u444, v444, prev_y, prev_u, prev_v,
                          i_frame: Sequence[int], frame_no: Sequence[int], *,
                          yr: int, ur: int, q_level: int, row_cap: int, frame_cap: int):
    """One frame of each of B streams: (B, H, W) planes, (B, H, W) and
    (B, H/2, W/2) previous recons, B host ints each for i_frame and frame_no
    -> encode_frame_device's outputs stacked over the streams."""
    return tuple(_each_stream(y444.shape[0], lambda b: encode_frame_device(
        y444[b], u444[b], v444[b], prev_y[b], prev_u[b], prev_v[b], int(i_frame[b]),
        int(frame_no[b]), yr=yr, ur=ur, q_level=q_level, row_cap=row_cap,
        frame_cap=frame_cap)))


def encode_gops_batched(frames_y, frames_u, frames_v, prev_y, prev_u, prev_v,
                        i_frame0: Sequence[int], frame_no0: Sequence[int],
                        pframes_count: int, *, yr: int, ur: int, q_level: int,
                        row_cap: int, frame_cap: int, seq_cap: int, program=None):
    """F frames of each of B streams, (B, F, H, W) stacks, through the batch
    program, or each stream through ``program`` (a function with
    encode_gop_scan's contract) where one is given.  Returns the outputs
    stacked over the streams: recon_y, recon_u, recon_v (B, ...), seq_words
    (B, seq_cap + frame_cap + 1) int64, seq_bits (B,), i_frame, frame_no (B
    host ints each), overflow (B,) bool, frame_bits (B, F), frame_i_frames
    (B, F) host ints.  The batch program's tensors are rewritten by its next
    call: clone what you keep past it."""
    kw = dict(yr=yr, ur=ur, q_level=q_level, row_cap=row_cap, frame_cap=frame_cap,
              seq_cap=seq_cap)
    with span("batch.gop"):
        if program is None:
            prog = gop_batch(frames_y, **kw)
            prog.start((frames_y, frames_u, frames_v), (prev_y, prev_u, prev_v), i_frame0,
                       frame_no0, pframes_count)
            for _ in range(frames_y.shape[1]):
                prog.feed()
            with span("batch.collect"):
                out = prog.result(frames_y.shape[1])
            count("batch_streams", frames_y.shape[0])
        else:
            out = _each_stream(frames_y.shape[0], lambda b: program(
                frames_y[b], frames_u[b], frames_v[b], prev_y[b], prev_u[b], prev_v[b],
                int(i_frame0[b]), int(frame_no0[b]), pframes_count, **kw))
        ry, ru, rv, sw, sb, i_f, fno, ovf, fbits, fifs = out
        with span("batch.sync"):
            i_f, fno, fifs = i_f.tolist(), fno.tolist(), fifs.tolist()
            count("host_syncs", 3)
    return (ry, ru, rv, sw, sb, i_f, fno, ovf, fbits, fifs)


class BatchEncoder:
    """Encode a batch of same-sized streams concurrently.

    Each stream keeps its own GOP index, timecode and byte assembly on the
    host.  ``push_frames`` steps one frame per stream; ``push_chunks``
    encodes several frames per stream with one upload and one download (the
    high-throughput path).  Without a mesh this process encodes all
    ``batch`` streams on ``device``; with a ``stream`` mesh each rank encodes
    its share on its own device, and ``finish`` gathers the streams so that
    every rank returns all of them.

    As in the JAX package, ``finish`` leaves each stream's payload empty and
    keeps the recon and GOP state, so a second sequence through the same
    object carries no sequence header: use one object per sequence.
    """

    def __init__(self, config: EncoderConfig, seq: SequenceConfig, batch: int,
                 mesh: Optional[DeviceMesh] = None, row_cap: int = DEFAULT_ROW_CAP,
                 frame_cap: int = DEFAULT_FRAME_CAP, device="cuda"):
        self.device = resolve_device(device)
        self.group = None if mesh is None else mesh.get_group("stream")
        self.config = config
        self.seq = seq.validate(config)
        self.batch = batch
        self.row_cap = row_cap
        self.frame_cap = frame_cap
        self.streams = range(batch) if mesh is None else local_range(batch, mesh, "stream")
        n, h, w = len(self.streams), self.seq.height, self.seq.width
        zc = torch.zeros((n, h // 2, w // 2), dtype=torch.uint8, device=self.device)
        self._prev = (torch.zeros((n, h, w), dtype=torch.uint8, device=self.device),
                      zc, zc.clone())
        self._i_frame = [0] * n
        self._frame_no = [0] * n
        hdr = sequence_start(self.seq.width, self.seq.height)
        self._payload: List[List[bytes]] = [[hdr] for _ in range(n)]

    def _kw(self):
        return dict(yr=self.config.yr, ur=self.config.ur, q_level=self.config.q_level)

    def _caps(self, n: int):
        return chunk_caps(self.row_cap, self.frame_cap, self.seq.width, self.seq.height, n)

    def _stack(self, planes) -> torch.Tensor:
        """One plane of each of this process's streams, stacked on the
        device; planes from outside must have the sequence's geometry and
        be uint8."""
        stack, want = np.stack(planes), (self.seq.height, self.seq.width)
        if stack.shape[-2:] != want or stack.dtype != np.uint8:
            raise ValueError(f"frames of {stack.shape[-2:]} {stack.dtype}, the sequence "
                             f"takes {want} uint8")
        return upload(stack, self.device)

    def _frames(self, frames: List[Frame]):
        """This process's streams' frames as three (B_l, H, W) device stacks."""
        return tuple(self._stack([frames[b][i] for b in self.streams]) for i in range(3))

    def _chunks(self, chunks: List[List[Frame]]):
        """This process's streams' chunks as three (B_l, F, H, W) device stacks."""
        return tuple(self._stack([np.stack([f[i] for f in chunks[b]]) for b in self.streams])
                     for i in range(3))

    def _append_payloads(self, words: torch.Tensor, bits: torch.Tensor) -> None:
        """Each stream's (B_l, N) words up to its bits, in one download of
        the longest stream's words."""
        bits_h = bits.tolist()
        host = words[:, :(max(bits_h) + 31) // 32].cpu()
        for j, nbits in enumerate(bits_h):
            self._payload[j].append(payload_bytes(host[j], nbits))

    def _check_batch(self, items: Sequence) -> None:
        if len(items) != self.batch:
            raise ValueError(f"{len(items)} streams given, the batch has {self.batch}")

    def push_frames(self, frames: List[Frame]) -> None:
        """One YUV 4:4:4 uint8 frame per stream (all ``batch`` of them; each
        rank encodes its own)."""
        self._check_batch(frames)
        args = (*self._frames(frames), *self._prev,
                self._i_frame, self._frame_no)

        def attempt(caps):
            out = encode_frames_batched(*args, **self._kw(), row_cap=caps["row_cap"],
                                        frame_cap=caps["frame_cap"])
            return None if bool(out[5].any()) else out
        ry, ru, rv, fw, fb, _ = within_bounds(attempt, self._caps(1), "frame")
        self._prev = (ry, ru, rv)
        self._append_payloads(fw, fb)
        self._i_frame = [next_i_frame(i, self.seq.pframes_count) for i in self._i_frame]
        self._frame_no = [n + 1 for n in self._frame_no]

    def push_chunks(self, chunks: List[List[Frame]]) -> None:
        """Several frames per stream, the same number for every stream,
        encoded with one upload and one payload download."""
        self._check_batch(chunks)
        n_frames = len(chunks[0])
        if any(len(c) != n_frames for c in chunks):
            raise ValueError("every stream's chunk must hold the same number of frames")
        args = (*self._chunks(chunks), *self._prev,
                self._i_frame, self._frame_no, self.seq.pframes_count)

        def attempt(caps):
            out = encode_gops_batched(*args, **self._kw(), **caps)
            return None if bool(out[7].any()) else out
        ry, ru, rv, sw, sb, i_f, fno, _, _, _ = within_bounds(attempt, self._caps(n_frames),
                                                              "chunk")
        # the batch program's recons are its own tensors, which the next
        # call of its key (another BatchEncoder's too) rewrites
        self._prev = (ry.clone(), ru.clone(), rv.clone())
        self._append_payloads(sw, sb)
        self._i_frame, self._frame_no = i_f, fno

    def finish(self) -> List[bytes]:
        """End every stream's sequence: all ``batch`` streams, in order, on
        every rank."""
        mine = {}
        for j, b in enumerate(self.streams):
            data = b"".join(self._payload[j])
            mine[b] = data + sequence_end(len(data))
        self._payload = [[b""] for _ in self.streams]
        if self.group is None:
            return [mine[b] for b in range(self.batch)]
        parts = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(parts, mine, group=self.group)
        streams = {}
        for part in parts:
            streams.update(part)
        return [streams[b] for b in range(self.batch)]
