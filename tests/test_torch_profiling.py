"""The port's spans and counters (utils/profiling.py) inside the public API
and the compiled programs, on the CPU at 64x64: nothing is recorded while
no profiler records; under one, the spans nest in the exported Chrome trace
and the tally counts each call and each blocking device read; the bytes do
not change; an overflow retry is counted."""
import json

import pytest
import torch

torch.set_num_threads(1)

import torch_ranks as R
from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.utils import profiling

W = H = 64
CHILDREN = {
    "push_chunk": (".stack", ".upload", ".program", ".sync", ".download", ".carry"),
    "push_frame": (".upload", ".program", ".sync", ".download", ".carry"),
}
# blocking device reads a call makes: the overflow flag, then the bit count,
# (chunks) the frames' bits and types and the GOP state, then the payload
SYNCS = {"push_chunk": 7, "push_frame": 3}


@pytest.fixture(autouse=True)
def clean_tally():
    profiling.reset()
    profiling.COUNTS.clear()
    yield
    profiling.reset()


def _encode(api, frames, **caps):
    """``frames`` through ``api`` (push_chunk: chunks of 2) -> the stream."""
    enc = Encoder(EncoderConfig(xl=4, yl=4), device="cpu", **caps)
    enc.start_sequence(SequenceConfig(W, H, 1))
    if api == "push_chunk":
        for i in range(0, len(frames), 2):
            enc.push_chunk(frames[i:i + 2])
    else:
        for f in frames:
            enc.push_frame(*f)
    return enc.finish()


def test_span_records_nothing_without_a_profiler():
    a, b = profiling.span("push_chunk", 0), profiling.span("gop.feed")
    assert a is b
    with a:
        profiling.count("host_syncs", 2)
    assert profiling.traced() == ({}, {})
    assert profiling.COUNTS == {"host_syncs": 2}


@pytest.mark.parametrize("api", ["push_chunk", "push_frame"])
def test_public_api_spans_nest_in_the_chrome_trace(tmp_path, api):
    frames = R.video(120, W, H, 4)
    calls = 2 if api == "push_chunk" else 4
    path = str(tmp_path / "trace.json")
    with profiling.trace_to(path):
        stream = _encode(api, frames)
    spans, counts = profiling.traced()
    names = [api] + [api + c for c in CHILDREN[api]]
    for name in names:
        assert spans[name][0] == calls and spans[name][1] > 0, name
    assert counts["host_syncs"] == SYNCS[api] * calls
    # the CPU has no graph: the programs' host copies and fills, no replay
    # (push_chunk: nothing per frame, the frames read from the stack in
    # place; per chunk the stack's 6 table writes, 3 plane copies, 3
    # scalars, 4 zeroings and 2 ops; push_frame: 6 plane copies, 2 scalars)
    assert counts["host_launches"] == (4 * 0 + calls * 18 if api == "push_chunk" else 4 * 8)
    if api == "push_chunk":
        assert counts["frames_in_place"] == 4 and "stack_copies" not in counts
    assert spans["gop.feed" if api == "push_chunk" else "frame.feed"][0] == 4
    assert not any(s.startswith(("replay.", "capture.")) for s in spans)
    assert profiling.COUNTS.get("graph_captures", 0) == 0
    assert "overflow_retries" not in counts

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("name") in names]
    outer = sorted((e for e in events if e["name"] == api), key=lambda e: e["ts"])
    assert len(outer) == calls
    for o in outer:
        inside = sorted((e for e in events if e["name"] != api
                         and o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]),
                        key=lambda e: e["ts"])
        assert [e["name"] for e in inside] == names[1:]
    assert stream == _encode(api, frames)


@pytest.mark.parametrize("api", ["push_chunk", "push_frame"])
def test_overflow_retry_is_counted(tmp_path, api):
    """Caps that a noise frame overflows: the call (a chunk of 2, or 1
    frame) is encoded again at the bounds, once, and the stream equals the
    one at the default caps."""
    frames = R.video(121, W, H, 2 if api == "push_chunk" else 1, "noise")
    with profiling.trace_to(str(tmp_path / "trace.json")):
        stream = _encode(api, frames, row_cap=4, frame_cap=8)
    spans, counts = profiling.traced()
    assert counts["overflow_retries"] == 1 == profiling.COUNTS["overflow_retries"]
    assert spans[api + ".program"][0] == spans[api + ".sync"][0] == 2
    assert counts["host_syncs"] == SYNCS[api] + 1
    assert stream == _encode(api, frames)
