"""The batch program of the eight-channel headend, parallel/dp.py's
encode_gops_batched, on the CPU: each stream's bytes equal the plain
reference's (bench_port/reference/mpeg2.py, plain PyTorch) and the
single-stream program's, chunk by chunk with the recon and GOP state
carried, with the port's batch program or a single-stream program passed
in, which it loops over; the two paths give the same outputs; under a
profiler each records its spans and counts its streams, syncs and
launches."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from fpga_mpeg2_encoder_tpu_torch.models.encoder import (
    bound_caps, encode_gop_scan, words_to_bytes)
from fpga_mpeg2_encoder_tpu_torch.parallel import dp
from fpga_mpeg2_encoder_tpu_torch.utils import profiling
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import video

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench_port.reference.mpeg2 import Reference  # noqa: E402

STREAMS = 3
YR, UR, Q = 4, 2, 2
BATCH_SPANS = ("batch.gop", "gop.start", "gop.feed", "batch.stream", "batch.collect",
               "batch.sync")


def _videos(w, h, n):
    """STREAMS clips of distinct seeded content, noise in the middle one."""
    return [video(31 + b, w, h, n, "noise" if b == 1 else "pan") for b in range(STREAMS)]


def _stacks(videos, first, n):
    return tuple(torch.as_tensor(np.stack([np.stack([v[first + j][p] for j in range(n)])
                                           for v in videos])) for p in range(3))


def _caps(w, h, n):
    row_cap, frame_cap = bound_caps(w, h)
    return dict(yr=YR, ur=UR, q_level=Q, row_cap=row_cap, frame_cap=frame_cap,
                seq_cap=frame_cap * n)


def _zero_state(w, h, streams):
    z = torch.zeros((streams, h, w), dtype=torch.uint8)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8)
    return (z, zc, zc.clone(), [0] * streams, [0] * streams)


@pytest.mark.parametrize("given", [False, True], ids=["port", "given"])
@pytest.mark.parametrize("w, h, pframes, chunks", [
    (64, 64, 2, (2, 3)),       # the second chunk starts on a P-frame, crosses a GOP
    (416, 64, 3, (3, 3)),
    (64, 64, 0, (2, 2)),       # I-frames only
])
def test_batch_equals_reference_and_single_streams(w, h, pframes, chunks, given):
    videos = _videos(w, h, sum(chunks))
    calls = []

    def program(*args, **kw):
        calls.append(args[7])                   # the stream's first frame number
        return encode_gop_scan(*args, **kw)

    state = _zero_state(w, h, STREAMS)
    single = [tuple(s[b] for s in state[:3]) + (0, 0) for b in range(STREAMS)]
    first = 0
    for n in chunks:
        kw = _caps(w, h, n)
        stacks = _stacks(videos, first, n)
        ry, ru, rv, sw, sb, i_f, fno, ovf, fbits, fifs = dp.encode_gops_batched(
            *stacks, *state, pframes, **kw, **(dict(program=program) if given else {}))
        assert not bool(ovf.any())
        assert i_f == [(first + n) % (pframes + 1)] * STREAMS and fno == [first + n] * STREAMS
        for b in range(STREAMS):
            bits = int(sb[b])
            got = words_to_bytes(sw[b, :(bits + 31) // 32].numpy(), bits)
            assert fifs[b] == [(first + j) % (pframes + 1) for j in range(n)]
            assert int(fbits[b].sum()) == bits
            out = encode_gop_scan(*(s[b] for s in stacks), *single[b], pframes, **kw)
            alone = words_to_bytes(out[3][:(int(out[4]) + 31) // 32].numpy(), int(out[4]))
            single[b] = (out[0].clone(), out[1].clone(), out[2].clone(), int(out[5]),
                         int(out[6]))
            ref = Reference(w, h, yr=YR, q_level=Q, pframes_count=pframes, device="cpu")
            want = b"".join(ref.frames(lambda k, v=videos[b]: v[k], first, first + n))
            assert got == alone == want, (b, first)
            for mine, theirs in zip((ry[b], ru[b], rv[b]), single[b][:3]):
                assert torch.equal(mine, theirs)
        state = (ry, ru, rv, i_f, fno)
        first += n
    firsts = [sum(chunks[:k]) for k in range(len(chunks))]
    assert calls == ([f for f in firsts for _ in range(STREAMS)] if given else [])


@pytest.mark.parametrize("path", ["batch", "loop"])
def test_batch_spans_and_counters(tmp_path, path):
    """One chunk of 2 frames of 3 streams: the spans nest as documented and
    the counters take their counts.  The batch program: a ``gop.start``, a
    ``gop.feed`` a frame-step, ``batch.collect`` around the result and
    ``batch.sync``, no ``batch.stream``; its host launches a call (none a
    frame on the CPU) the plane tables' and the GOP state's 2 uploads, 3
    recon copies, 3 zeroings and the result's 2 ops.  The loop over a given
    program: a ``batch.stream`` and a ``batch.collect`` a stream, the
    single-stream programs' launches (per chunk the stacks' 6 table writes,
    3 plane copies, 3 scalar fills, 4 zeroings and the result's 2 ops) plus
    10 copies a stream.  Both read every frame in place, sync 3 times and
    give the same outputs."""
    w = h = 64
    kw = _caps(w, h, 2)
    given = dict(program=encode_gop_scan) if path == "loop" else {}
    stacks, state = _stacks(_videos(w, h, 2), 0, 2), _zero_state(w, h, STREAMS)
    want = [v.clone() if torch.is_tensor(v) else v for v in dp.encode_gops_batched(
        *stacks, *state, 2, **kw, program=encode_gop_scan)]
    profiling.reset()
    path_ = str(tmp_path / "trace.json")
    try:
        with profiling.trace_to(path_):
            got = dp.encode_gops_batched(*stacks, *state, 2, **kw, **given)
        spans, counts = profiling.traced()
    finally:
        profiling.reset()
    if path == "batch":
        calls = {"batch.gop": 1, "gop.start": 1, "gop.feed": 2, "batch.stream": 0,
                 "batch.collect": 1, "batch.sync": 1}
        order = ["gop.start", "gop.feed", "gop.feed", "batch.collect", "batch.sync"]
        launches = 2 + 3 + 3 + 2
    else:
        calls = {"batch.gop": 1, "gop.start": STREAMS, "gop.feed": 2 * STREAMS,
                 "batch.stream": STREAMS, "batch.collect": STREAMS, "batch.sync": 1}
        order = ["batch.stream", "batch.collect"] * STREAMS + ["batch.sync"]
        launches = STREAMS * (2 * 0 + 18 + 10)
    assert {s: spans.get(s, (0,))[0] for s in BATCH_SPANS} == calls
    assert counts["host_syncs"] == 3 and counts["batch_streams"] == STREAMS
    assert counts["host_launches"] == launches
    assert counts["frames_in_place"] == 2 * STREAMS and "stack_copies" not in counts
    for a, b in zip(got, want):
        assert (a == b) if isinstance(a, list) else torch.equal(a, b)

    with open(path_) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("name") in BATCH_SPANS]
    outer = next(e for e in events if e["name"] == "batch.gop")
    # the loop's gop.start and gop.feed lie inside its batch.stream spans
    inside = sorted((e for e in events if e is not outer
                     and (path == "batch" or not e["name"].startswith("gop."))),
                    key=lambda e: e["ts"])
    assert all(outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
               for e in inside)
    assert [e["name"] for e in inside] == order


@pytest.mark.parametrize("streams, strided", [(1, False), (3, False), (3, True)])
def test_batch_program_equals_the_loop(streams, strided):
    """The default path (the batch program, its channels' steps the
    branches of one step, run one after another on the CPU) equals the loop
    over encode_gop_scan given as ``program``, in all ten outputs, over
    three calls: the first from mid-GOP positions and frame numbers that
    differ between the streams, each later one from the recon and GOP state
    the last returned, the GOP wrapping and chunks of 3, 2 and 4 frames.
    Stacks of every other column are copied once a call, each plane
    (``stack_copies``); others are read in place."""
    w, h, pframes = 64, 64, 2
    videos = [video(61 + b, w, h, 9, "noise" if b == 1 else "pan") for b in range(streams)]
    z = torch.zeros((streams, h, w), dtype=torch.uint8)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8)
    starts = ([1 + b % 2 for b in range(streams)], [1438 + 5 * b for b in range(streams)])
    state = {path: (z, zc, zc.clone(), *starts) for path in ("batch", "loop")}
    first = 0
    for n in (3, 2, 4):
        kw = _caps(w, h, 4)
        stacks = tuple(torch.as_tensor(np.stack([np.stack([v[first + j][p] for j in range(n)])
                                                 for v in videos])) for p in range(3))
        if strided:
            stacks = tuple(s.repeat_interleave(2, dim=-1)[..., ::2] for s in stacks)
        loop = dp.encode_gops_batched(*stacks, *state["loop"], pframes, **kw,
                                      program=encode_gop_scan)
        before = dict(profiling.COUNTS)
        batch = dp.encode_gops_batched(*stacks, *state["batch"], pframes, **kw)
        counted = {k: profiling.COUNTS.get(k, 0) - before.get(k, 0)
                   for k in ("frames_in_place", "stack_copies")}
        assert counted == ({"frames_in_place": 0, "stack_copies": 3} if strided
                           else {"frames_in_place": streams * n, "stack_copies": 0})
        assert not bool(batch[7].any())
        for a, b in zip(batch, loop):
            assert (a == b) if isinstance(a, list) else torch.equal(a, b)
        assert batch[6] == [f + first + n for f in starts[1]]
        state = {"batch": (*batch[:3], batch[5], batch[6]),
                 "loop": (*loop[:3], loop[5], loop[6])}
        first += n
