"""Host frames through the public ``Encoder``, constructed as the command
line constructs it: ``push_chunk`` of ``chunk_frames`` frames back to back,
``sequence_frames`` frames a sequence, ``finish`` at its end.  A unit is a
chunk; the unit that ends a sequence includes its ``finish``.
"""
from __future__ import annotations

import torch

from answers import Answer, Unit


class Driver:
    def __init__(self, cell):
        self.cell, self.cfg, t = cell, cell.config, cell.traffic
        self.n, self.per_seq = t["chunk_frames"], t["sequence_frames"]
        if self.per_seq % self.n:
            raise ValueError("sequence_frames must be a multiple of chunk_frames")

    def setup(self) -> None:
        c, prog = self.cfg, self.cell.program
        self.enc = prog.Encoder(prog.EncoderConfig(xl=c["xl"], yl=c["yl"],
                                                   vector_level=c["vector_level"],
                                                   q_level=c["q_level"]),
                                row_cap=c["row_cap"], frame_cap=c["frame_cap"],
                                device=self.cell.device)
        self.seq = prog.SequenceConfig(c["width"], c["height"], c["pframes_count"])
        self.enc.start_sequence(self.seq)               # the warm-up and the capture
        self.enc.push_chunk(self._frames(0, 0))
        self.enc.finish()
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def _frames(self, seq: int, first: int):
        src = self.source(seq)
        return [src(k) for k in range(first, first + self.n)]

    def unit(self, index: int) -> Unit:
        seq, first = divmod(index * self.n, self.per_seq)
        if first == 0:
            self.enc.start_sequence(self.seq)
        with self.cell.span("push_chunk"):
            self.enc.push_chunk(self._frames(seq, first))
        if first + self.n == self.per_seq:
            with self.cell.span("finish"):
                stream = self.enc.finish()
            self.cell.sampler.offer(Answer(seq, 0, self.per_seq, stream, True))
        return Unit(self.n)

    def close(self, units: int) -> None:
        """Finish the sequence that the window's end left open."""
        seq, first = divmod(units * self.n, self.per_seq)
        if first:
            self.cell.sampler.offer(Answer(seq, 0, first, self.enc.finish(), True))

    def source(self, seq: int):
        pool, base = self.cell.pool, seq * self.per_seq
        return lambda k: pool[(base + k) % len(pool)]
