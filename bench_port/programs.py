"""The system under test, and what the check of the check puts in its place.

``port()`` is the PyTorch and CUDA port: its compiled program
``encode_gop_scan`` and its public ``Encoder``.  Outside this directory the
benchmark imports only these and, to read the port's spans and counters
(``tally.py``), ``fpga_mpeg2_encoder_tpu_torch.utils.profiling``.
``control()`` is the plain reference encoder at the next coarser quantiser
(q_level + 1), in the port's place: the one step down in precision that a
faster encoder could be tempted by.  The check has to find its streams not
correct.  ``fault(name)`` is the port with one fault planted where its
state or its answers are produced:

* ``stale_state``: a step that returns its state unchanged: the recon that
  the next P-frame predicts from, the GOP position and the frame number are
  not carried, so the next chunk or frame repeats the GOP headers' timecodes
  (and, where it predicts, predicts from a stale picture);
* ``altered_answer``: one bit of the payload flipped where it is produced.

The check has to find each of them not correct as well.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from reference.mpeg2 import Reference, sequence_end, sequence_header


def port() -> types.SimpleNamespace:
    from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig
    from fpga_mpeg2_encoder_tpu_torch.models.encoder import encode_gop_scan
    from fpga_mpeg2_encoder_tpu_torch.runtime import graphs
    return types.SimpleNamespace(Encoder=Encoder, EncoderConfig=EncoderConfig,
                                 SequenceConfig=SequenceConfig,
                                 encode_gop_scan=encode_gop_scan, release=graphs.clear)


def _coarser(q_level: int) -> int:
    if q_level >= 4:
        raise ValueError("the control needs a q_level below 4")
    return q_level + 1


def _bytes_to_words(blob: bytes, device) -> torch.Tensor:
    """Bytes -> the port's payload form: 32-bit big-endian words as int64."""
    blob += b"\x00" * (-len(blob) % 4)
    return torch.as_tensor(np.frombuffer(blob, ">u4").astype(np.int64), device=device)


def _control_gop_scan(fy, fu, fv, prev_y, prev_u, prev_v, i_frame0, frame_no0,
                      pframes_count, *, yr, ur, q_level, row_cap, frame_cap, seq_cap):
    """encode_gop_scan's contract, computed by the reference at q_level + 1."""
    del ur, row_cap, frame_cap, seq_cap
    dev = fy.device
    ref = Reference(fy.shape[2], fy.shape[1], yr=yr, q_level=_coarser(q_level),
                    pframes_count=int(pframes_count), device=dev)
    i_f, fno, prev, out, fifs = int(i_frame0), int(frame_no0), (prev_y, prev_u, prev_v), [], []
    for k in range(fy.shape[0]):
        data, prev = ref.frame((fy[k], fu[k], fv[k]), prev, i_f, fno)
        out.append(data)
        fifs.append(i_f)
        i_f, fno = 0 if i_f >= int(pframes_count) else i_f + 1, fno + 1
    blob = b"".join(out)
    scalar = lambda v, dt=torch.int64: torch.tensor(v, dtype=dt, device=dev)   # noqa: E731
    return (*prev, _bytes_to_words(blob, dev), scalar(8 * len(blob)),
            scalar(i_f, torch.int32), scalar(fno, torch.int32), scalar(False, torch.bool),
            torch.tensor([8 * len(d) for d in out], device=dev), torch.tensor(fifs, device=dev))


class _ControlEncoder:
    """The public Encoder's streaming and chunked calls, computed by the
    reference at q_level + 1."""

    def __init__(self, config, row_cap=None, frame_cap=None, device="cuda"):
        del row_cap, frame_cap
        self.config, self.device = config, torch.device(device)

    def start_sequence(self, seq) -> None:
        self._ref = Reference(seq.width, seq.height, yr=self.config.yr,
                              q_level=_coarser(self.config.q_level),
                              pframes_count=seq.pframes_count, device=self.device)
        z = torch.zeros((seq.height, seq.width), dtype=torch.uint8, device=self.device)
        zc = torch.zeros((seq.height // 2, seq.width // 2), dtype=torch.uint8,
                         device=self.device)
        self._prev, self._k = (z, zc, zc), 0
        self._payload = [sequence_header(seq.width, seq.height)]

    def push_frame(self, y, u, v) -> None:
        data, self._prev = self._ref.frame((y, u, v), self._prev,
                                           self._ref.gop_position(self._k), self._k)
        self._payload.append(data)
        self._k += 1

    def push_chunk(self, frames) -> None:
        for f in frames:
            self.push_frame(*f)

    def finish(self) -> bytes:
        data = b"".join(self._payload)
        return data + sequence_end(len(data))


def control() -> types.SimpleNamespace:
    base = port()
    return types.SimpleNamespace(**{**vars(base), "Encoder": _ControlEncoder,
                                    "encode_gop_scan": _control_gop_scan})


def fault(name: str) -> types.SimpleNamespace:
    base = port()
    if name not in ("stale_state", "altered_answer"):
        raise ValueError(f"unknown fault {name!r}")

    def gop_scan(fy, fu, fv, prev_y, prev_u, prev_v, i_frame0, frame_no0, *args, **kw):
        out = base.encode_gop_scan(fy, fu, fv, prev_y, prev_u, prev_v, i_frame0, frame_no0,
                                   *args, **kw)
        if name == "stale_state":
            return (prev_y, prev_u, prev_v, *out[3:5], i_frame0, frame_no0, *out[7:])
        words, bits = out[3], int(out[4])
        words[bits // 64] ^= 1 << 7
        return out

    class Encoder(base.Encoder):
        def _planted(self, call, *args):
            state = self._prev, self._i_frame, self._frame_no
            call(*args)
            if name == "stale_state":
                self._prev, self._i_frame, self._frame_no = state
            elif name == "altered_answer":
                last = bytearray(self._payload[-1])
                last[len(last) // 2] ^= 0x80
                self._payload[-1] = bytes(last)

        def push_frame(self, y, u, v) -> None:
            self._planted(super().push_frame, y, u, v)

        def push_chunk(self, frames) -> None:
            self._planted(super().push_chunk, frames)

    return types.SimpleNamespace(**{**vars(base), "Encoder": Encoder,
                                    "encode_gop_scan": gop_scan})
