"""The check of the check: a whole run of each cell, driven here at 64x64
on the CPU past run.py's look for a card, is correct with the port, and
not correct with the control (the reference at the next coarser quantiser
in the port's place) or with a fault planted in the port: a step that
returns its state unchanged, an answer altered where it is produced.  The
cells run on one stream and one chip, so they can have no batch left half
out and no exchange between chips left out."""
import numpy as np
import pytest
import torch

import harness
import programs
from fpga_mpeg2_encoder_tpu_torch.models.encoder import bound_caps

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SMALL = dict(zip(("width", "height"), (64, 64)),
             **dict(zip(("row_cap", "frame_cap"), bound_caps(64, 64))))


def run(cell, program):
    # three units: a chunk or a frame whose prediction crosses a unit's
    # boundary is then among those that can be drawn
    return harness.run_cell(cell, 2 ** 31 + 3, 0.0, False, "cpu", program, 0.0,
                            overrides=SMALL, log=lambda msg: None, min_units=3)


@pytest.mark.parametrize("cell", CELLS)
def test_port_is_correct(cell):
    res = run(cell, programs.port())
    assert res["correct"], res["checks"]
    assert res["window"]["frames_checked"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run(cell, programs.control())
    assert not res["correct"]
    assert res["checks"]["mismatches"]["value"] > 0
    assert res["window"]["frames_differing"] == res["window"]["frames_checked"]


@pytest.mark.parametrize("fault", ["stale_state", "altered_answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    res = run(cell, programs.fault(fault))
    assert not res["correct"], res["checks"]


def small_chunk(n):
    frames = harness.load("content", "synthetic").make(64, 64, n, 5)
    return frames, [torch.as_tensor(np.stack([f[p] for f in frames])) for p in range(3)]


def test_stale_state_scan_returns_its_state_unchanged():
    # the recon planes, the GOP position and the frame number passed in come
    # back as they went in, so a stream with no P-frame shows the fault too
    _, planes = small_chunk(3)
    prev = (torch.full((64, 64), 7, dtype=torch.uint8),
            torch.full((32, 32), 9, dtype=torch.uint8),
            torch.full((32, 32), 11, dtype=torch.uint8))
    args = (*planes, *prev, 1, 17, 2)           # GOP position 1, frame 17, 2 P-frames
    kw = dict(yr=6, ur=3, q_level=2, row_cap=SMALL["row_cap"], frame_cap=SMALL["frame_cap"],
              seq_cap=SMALL["frame_cap"])
    good = programs.port().encode_gop_scan(*args, **kw)
    out = programs.fault("stale_state").encode_gop_scan(*args, **kw)
    assert all(a is b for a, b in zip(out[:3], prev))
    assert (out[5], out[6]) == (1, 17)
    assert (int(good[5]), int(good[6])) == (1, 20)
    assert torch.equal(out[3], good[3]) and int(out[4]) == int(good[4])


def test_stale_state_encoder_keeps_its_state():
    frames, _ = small_chunk(3)
    base = programs.port()
    enc = programs.fault("stale_state").Encoder(base.EncoderConfig(), device="cpu")
    enc.start_sequence(base.SequenceConfig(64, 64, 0))
    enc.push_chunk(frames)
    enc.push_frame(*frames[0])
    assert (enc._prev, enc._i_frame, enc._frame_no) == (None, 0, 0)
    assert len(enc._payload) == 3               # the sequence header and two answers
