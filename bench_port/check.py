"""The comparison that decides ``correct``: the answers that the window
produced, sampled from the seed, against the plain reference's bytes.

A frame's bytes are located in the port's output by start codes alone:
each frame begins with its picture start code (00 00 01 00), or with the GOP
header (00 00 01 B8) that comes before it, and ends where the next frame or
the sequence end code (00 00 01 B7) begins.  MPEG-2's codes never emulate a
start code, so the port's own counts are not needed to cut its stream.

The number compared is ``mismatches``, with the limit 0 (the comparison
is exact): the sum of

* ``frames_differing``: sampled frames whose bytes differ from the
  reference's, or that are missing;
* ``framing_errors``: a whole sequence's header, end code and padding that
  differ from the reference's, and the difference between its count of
  pictures and the frames that were pushed; a chunk's count of pictures
  against its frames.
"""
from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Tuple

from answers import Answer
from reference.mpeg2 import Reference, sequence_end, sequence_header

LIMITS = {"mismatches": 0}
_START = re.compile(b"\x00\x00\x01[\x00\xb7\xb8]", re.DOTALL)


def frame_spans(data: bytes) -> Tuple[List[Tuple[int, int]], Optional[int]]:
    """(start, end) of every frame in ``data``, and the offset of the
    sequence end code (None where there is none)."""
    starts, gop, end_code = [], None, None
    for m in _START.finditer(data):
        code = data[m.start() + 3]
        if code == 0xB8:
            gop = m.start()
        elif code == 0x00:
            starts.append(m.start() if gop is None else gop)
            gop = None
        else:
            end_code = m.start()
            break
    ends = starts[1:] + [len(data) if end_code is None else end_code]
    return list(zip(starts, ends)), end_code


def check(answers: List[Answer], make_reference, source_of, seed: int, ranges: int,
          range_frames: int) -> Dict[str, int]:
    """Compare every answer in ``answers``.  A chunk's frames are compared
    all; a whole sequence's framing is compared, and ``ranges`` runs of
    ``range_frames`` frames in it, drawn from the seed.  ``make_reference()``
    gives a Reference, ``source_of(seq)`` the frames of sequence ``seq``.
    Returns ``mismatches``, its two parts and ``frames_checked``."""
    rng = random.Random(seed)
    ref: Reference = make_reference()
    out = {"frames_differing": 0, "framing_errors": 0, "frames_checked": 0}
    for ans in sorted(answers, key=lambda a: (a.seq, a.first)):
        data = ans.bytes()
        spans, end_code = frame_spans(data)
        if ans.whole:
            header = sequence_header(ref.width, ref.height)
            body_end = len(data) if end_code is None else end_code
            out["framing_errors"] += int(data[:len(header)] != header)
            out["framing_errors"] += int(end_code is None
                                         or data[body_end:] != sequence_end(body_end))
            out["framing_errors"] += abs(len(spans) - ans.n)
            picks = sorted({rng.randrange(max(1, ans.n - range_frames + 1))
                            for _ in range(ranges)})
            runs = [(a, min(ans.n, a + range_frames)) for a in picks]
        else:
            out["framing_errors"] += abs(len(spans) - ans.n) + int(end_code is not None)
            runs = [(ans.first, ans.first + ans.n)]
        offset = 0 if ans.whole else ans.first
        for a, b in runs:
            want = ref.frames(source_of(ans.seq), a, b)
            for k, frame in enumerate(want, start=a - offset):
                got = data[spans[k][0]:spans[k][1]] if k < len(spans) else b""
                out["frames_differing"] += int(got != frame)
                out["frames_checked"] += 1
    out["mismatches"] = out["frames_differing"] + out["framing_errors"]
    return out
