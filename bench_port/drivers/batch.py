"""Several channels' frames already in device memory, through the port's
batch program ``parallel/dp.encode_gops_batched``: the configuration's
``streams`` sequences continue through the window side by side, each unit
one call of ``chunk_frames`` frames a channel, each channel's recon and GOP
state carried from call to call, and each channel's payload downloaded up
to its bits into a reused page-locked (streams, N) host buffer before the
next call, as a headend hands its multiplex on.

Channel b reads the content pool from frame ``channel_offset`` * b, so that
the channels' frames differ and a mix-up between channels changes bytes.
Set-up stacks, for each offset into the pool at which a unit can start,
the (streams, chunk_frames, H, W) planes that the units then read.

The batch loops over the cell's single-stream program (``programs.py``):
the port's ``encode_gop_scan``, or the control's or a fault's, each brought
to ``encode_gop_scan``'s output shapes first.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from answers import Answer, Unit, words_to_bytes


def _to_contract(gop):
    """``gop`` with encode_gop_scan's output shapes: the payload's words in a
    (seq_cap + frame_cap + 1,) buffer and the GOP state as 0-d int32
    tensors (the control returns its payload's length in words, the
    stale-state fault the ints it was given)."""
    def call(fy, *args, seq_cap, frame_cap, **kw):
        out = list(gop(fy, *args, seq_cap=seq_cap, frame_cap=frame_cap, **kw))
        words = torch.zeros(seq_cap + frame_cap + 1, dtype=torch.int64, device=fy.device)
        words[:out[3].numel()] = out[3]
        out[3] = words
        out[5:7] = [torch.as_tensor(v, dtype=torch.int32, device=fy.device) for v in out[5:7]]
        return tuple(out)
    return call


def _batch_over(gop):
    """The port's batch program over the single-stream program ``gop``."""
    from fpga_mpeg2_encoder_tpu_torch.models.encoder import encode_gop_scan
    from fpga_mpeg2_encoder_tpu_torch.parallel.dp import encode_gops_batched
    if gop is encode_gop_scan:
        return encode_gops_batched
    return functools.partial(encode_gops_batched, program=_to_contract(gop))


class Driver:
    def __init__(self, cell):
        self.cell, self.cfg = cell, cell.config
        self.n, self.streams = cell.traffic["chunk_frames"], cell.config["streams"]
        self.offset = cell.traffic["channel_offset"]

    def setup(self) -> None:
        c, dev, pool = self.cfg, self.cell.device, self.cell.pool
        self.batch = _batch_over(self.cell.program.encode_gop_scan)
        src = [self.source(b) for b in range(self.streams)]
        self.stacks = {}
        for u in range(len(pool)):
            o = self.n * u % len(pool)
            if o not in self.stacks:
                self.stacks[o] = [torch.as_tensor(np.stack([
                    np.stack([s(o + j)[p] for j in range(self.n)]) for s in src])).to(dev)
                    for p in range(3)]
        self.kw = dict(yr=2 * c["vector_level"], ur=c["vector_level"], q_level=c["q_level"],
                       row_cap=c["row_cap"], frame_cap=c["frame_cap"],
                       seq_cap=c["frame_cap"] * max(1, self.n // 4))
        self.host = torch.empty((self.streams, self.kw["seq_cap"] + c["frame_cap"] + 1),
                                dtype=torch.int64, pin_memory=dev.type == "cuda")
        self._call(0, self._start_state())            # the warm-up and the capture
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.state = self._start_state()

    def _start_state(self):
        h, w, dev, s = self.cfg["height"], self.cfg["width"], self.cell.device, self.streams
        z = torch.zeros((s, h, w), dtype=torch.uint8, device=dev)
        zc = torch.zeros((s, h // 2, w // 2), dtype=torch.uint8, device=dev)
        return (z, zc, zc, [0] * s, [0] * s)

    def _call(self, first: int, state):
        frames = self.stacks[first % len(self.cell.pool)]
        return self.batch(*frames, *state, self.cfg["pframes_count"], **self.kw)

    def unit(self, index: int) -> Unit:
        first = index * self.n
        with self.cell.span("encode_gops_batched"):
            ry, ru, rv, words, bits, i_f, fno, ovf, _, _ = self._call(first, self.state)
        with self.cell.span("download"):
            nbits = bits.tolist()
            if bool(ovf.any()):
                raise RuntimeError(f"call {index} overflowed caps that no frame can overflow")
            for b, nb in enumerate(nbits):
                k = (nb + 31) // 32
                self.host[b, :k].copy_(words[b, :k])
        self.state = (ry, ru, rv, i_f, fno)
        for b, nb in enumerate(nbits):
            self.cell.sampler.offer(Answer(b, first, self.n, b""),
                                    snapshot=functools.partial(self._kept, b, nb))
        return Unit(self.streams * self.n, sum(nbits))

    def _kept(self, b: int, nbits: int):
        """Channel b's payload copied out of the reused buffer, and the
        function that gives its bytes."""
        kept = self.host[b, :(nbits + 31) // 32].clone()
        return lambda: words_to_bytes(kept.numpy(), nbits)

    def source(self, seq: int):
        pool = self.cell.pool
        return lambda k: pool[(self.offset * seq + k) % len(pool)]
