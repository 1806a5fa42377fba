"""Frames already in device memory, through the compiled program
``models/encoder.encode_gop_scan``: one sequence that continues through the
window in chunks of ``chunk_frames``, the recon and the GOP state carried on
the device from chunk to chunk, each chunk's payload downloaded to the host
before the next call, into a page-locked host buffer that is reused, as a
GPU pipeline hands its output on.
"""
from __future__ import annotations

import numpy as np
import torch

from answers import Answer, Unit, words_to_bytes


class Driver:
    def __init__(self, cell):
        self.cell, self.cfg = cell, cell.config
        self.n = cell.traffic["chunk_frames"]

    def setup(self) -> None:
        c, dev = self.cfg, self.cell.device
        pool = self.cell.pool
        # the pool and its first n - 1 frames again, so that every chunk is
        # one contiguous slice
        self.stacks = [torch.as_tensor(np.stack([pool[i % len(pool)][p]
                                                 for i in range(len(pool) + self.n - 1)]))
                       .to(dev) for p in range(3)]
        self.kw = dict(yr=2 * c["vector_level"], ur=c["vector_level"], q_level=c["q_level"],
                       row_cap=c["row_cap"], frame_cap=c["frame_cap"],
                       seq_cap=c["frame_cap"] * max(1, self.n // 4))
        self.host = torch.empty(self.kw["seq_cap"] + c["frame_cap"] + 1, dtype=torch.int64,
                                pin_memory=dev.type == "cuda")
        self._call(0, self._start_state())            # the warm-up and the capture
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.state = self._start_state()

    def _start_state(self):
        h, w, dev = self.cfg["height"], self.cfg["width"], self.cell.device
        z = torch.zeros((h, w), dtype=torch.uint8, device=dev)
        zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
        return (z, zc, zc, 0, 0)

    def _call(self, first: int, state):
        o = first % len(self.cell.pool)
        frames = [s[o:o + self.n] for s in self.stacks]
        return self.cell.program.encode_gop_scan(*frames, *state, self.cfg["pframes_count"],
                                                 **self.kw)

    def unit(self, index: int) -> Unit:
        first = index * self.n
        with self.cell.span("encode_gop_scan"):
            ry, ru, rv, words, bits, i_f, fno, ovf, _, _ = self._call(first, self.state)
        with self.cell.span("download"):
            nbits = int(bits)
            if bool(ovf):
                raise RuntimeError(f"chunk {index} overflowed caps that no frame can overflow")
            n = (nbits + 31) // 32
            self.host[:n].copy_(words[:n])
        self.state = (ry, ru, rv, i_f, fno)
        self.cell.sampler.offer(Answer(0, first, self.n, b""), snapshot=lambda: (
            lambda kept=self.host[:n].clone(): words_to_bytes(kept.numpy(), nbits)))
        return Unit(self.n, nbits)

    def source(self, seq: int):
        pool = self.cell.pool
        return lambda k: pool[k % len(pool)]
