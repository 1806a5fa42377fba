"""The eight-channel headend's cell (``sd576x8_p11_vl2.batch_resident``) on
the CPU at 64x64 (where the port runs its plain versions): the ``batch``
driver's answers are the reference's in every channel; the check finds
crossed channels, the control and the planted faults not correct; the
harness's I/P pattern of a traced unit is every channel's own."""
import types

import numpy as np
import pytest
import torch

import check
import harness
from answers import Sampler, Unit
import programs
from fpga_mpeg2_encoder_tpu_torch.models.encoder import bound_caps
from reference.mpeg2 import Reference

W = H = 64
CONFIG, TRAFFIC = "sd576x8_p11_vl2", "batch_resident"


def make_cell(program, streams=3, chunk_frames=6):
    """The cell at 64x64 with fewer channels; chunks of 6 frames start in
    the middle of a 12-frame GOP, so each call's first P-frame predicts from
    the recon that the previous call carried."""
    rc, fc = bound_caps(W, H)
    config = dict(harness.load_json("configs", CONFIG), width=W, height=H, row_cap=rc,
                  frame_cap=fc, streams=streams)
    traffic = dict(harness.load_json("traffic", TRAFFIC), chunk_frames=chunk_frames)
    content = harness.load("content", traffic["content"])
    pool = content.make(W, H, content.PERIOD, 2 ** 31 + 11)
    return harness.Cell(f"{CONFIG}.{TRAFFIC}", config, traffic, 11, torch.device("cpu"),
                        program, pool, Sampler(10 ** 6, 11))


def drive_and_check(program, units=3, **kw):
    cell = make_cell(program, **kw)
    drv = harness.load("drivers", "batch").Driver(cell)
    drv.setup()
    done = [drv.unit(i) for i in range(units)]
    c = cell.config
    out = check.check(cell.sampler.kept, lambda: Reference(
        W, H, yr=2 * c["vector_level"], q_level=c["q_level"], pframes_count=c["pframes_count"],
        device="cpu"), drv.source, 11, 1, 1)
    return cell, drv, done, out


def test_batch_driver_answers_are_the_references():
    cell, drv, done, out = drive_and_check(programs.port())
    assert [u.frames for u in done] == [18] * 3
    assert sorted((a.seq, a.first) for a in cell.sampler.kept) == [
        (b, f) for b in range(3) for f in (0, 6, 12)]
    assert out == dict(frames_differing=0, framing_errors=0, frames_checked=54, mismatches=0)
    assert sum(u.bits for u in done) == 8 * sum(len(a.bytes()) for a in cell.sampler.kept)
    # the channels' content differs, so a mix-up between them changes bytes
    assert not np.array_equal(drv.source(0)(0)[0], drv.source(1)(0)[0])


def _crossed(gop):
    """A single-stream program that hands each stream the recon that the
    batch gave the stream before it (stream b gets stream b - 1's)."""
    last = []

    def call(fy, fu, fv, py, pu, pv, *args, **kw):
        mine = (py.clone(), pu.clone(), pv.clone())
        given = last.pop() if last else mine
        last.append(mine)
        return gop(fy, fu, fv, *given, *args, **kw)
    return call


def test_crossed_streams_are_not_correct():
    port = programs.port()
    crossed = types.SimpleNamespace(**{**vars(port), "encode_gop_scan": _crossed(
        port.encode_gop_scan)})
    _, _, _, out = drive_and_check(crossed)
    assert out["mismatches"] > 0 and out["framing_errors"] == 0


@pytest.mark.parametrize("name", ["control", "fault:stale_state", "fault:altered_answer"])
def test_control_and_faults_reach_the_batch(name):
    program = programs.control() if name == "control" else programs.fault(name.split(":")[1])
    _, _, _, out = drive_and_check(program)
    assert out["frames_checked"] == 54 and out["mismatches"] > 0


def test_traced_pattern_is_every_channels_own():
    """48-frame chunks (four whole GOPs) of 8 channels, stacked channel after
    channel in a unit: the harness's I/P pattern of the unit's frames is each
    channel's, frame for frame."""
    traffic = harness.load_json("traffic", TRAFFIC)
    config = harness.load_json("configs", CONFIG)
    n, s, p = traffic["chunk_frames"], config["streams"], config["pframes_count"]
    for u in range(5):
        got = [f.is_i for f in harness._frames_of(Unit(s * n, 1000), u * s * n, p)]
        want = [(u * n + j) % (p + 1) == 0 for _ in range(s) for j in range(n)]
        assert got == want

