"""One live channel: host frames one at a time through the public
``Encoder.push_frame``, each returning with its bytes on the host.  The
latency of a frame is its ``push_frame`` call.  ``sequence_frames`` frames a
sequence, ``finish`` at its end (outside every frame's latency).
"""
from __future__ import annotations

import time

import torch

from answers import Answer, Unit


class Driver:
    def __init__(self, cell):
        self.cell, self.cfg = cell, cell.config
        self.per_seq = cell.traffic["sequence_frames"]

    def setup(self) -> None:
        c, prog = self.cfg, self.cell.program
        self.enc = prog.Encoder(prog.EncoderConfig(xl=c["xl"], yl=c["yl"],
                                                   vector_level=c["vector_level"],
                                                   q_level=c["q_level"]),
                                row_cap=c["row_cap"], frame_cap=c["frame_cap"],
                                device=self.cell.device)
        self.seq = prog.SequenceConfig(c["width"], c["height"], c["pframes_count"])
        self.enc.start_sequence(self.seq)               # the warm-up and the capture
        self.enc.push_frame(*self.cell.pool[0])
        self.enc.finish()
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def unit(self, index: int) -> Unit:
        seq, k = divmod(index, self.per_seq)
        if k == 0:
            self.enc.start_sequence(self.seq)
        frame = self.source(seq)(k)
        with self.cell.span("push_frame"):
            t0 = time.perf_counter()
            self.enc.push_frame(*frame)
            latency = time.perf_counter() - t0
        if k + 1 == self.per_seq:
            with self.cell.span("finish"):
                stream = self.enc.finish()
            self.cell.sampler.offer(Answer(seq, 0, self.per_seq, stream, True))
        return Unit(1, latencies=[latency])

    def close(self, units: int) -> None:
        seq, k = divmod(units, self.per_seq)
        if k:
            self.cell.sampler.offer(Answer(seq, 0, k, self.enc.finish(), True))

    def source(self, seq: int):
        pool, base = self.cell.pool, seq * self.per_seq
        return lambda k: pool[(base + k) % len(pool)]
