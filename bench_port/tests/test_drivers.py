"""Each traffic driver, driven here at 64x64 on the CPU (where the port runs
its plain versions), yields the stream that Encoder.encode gives for the
same frames."""
import pytest
import torch

import harness
from answers import Sampler
from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig
from fpga_mpeg2_encoder_tpu_torch.models.encoder import bound_caps
import programs
from reference.mpeg2 import sequence_end, sequence_header

W = H = 64


def make_cell(config_name, traffic_name, **traffic):
    rc, fc = bound_caps(W, H)
    config = dict(harness.load_json("configs", config_name), width=W, height=H,
                  row_cap=rc, frame_cap=fc)
    t = dict(harness.load_json("traffic", traffic_name), **traffic)
    content = harness.load("content", t["content"])
    pool = content.make(W, H, content.PERIOD, 11)
    return harness.Cell(f"{config_name}.{traffic_name}", config, t, 11,
                        torch.device("cpu"), programs.port(), pool, Sampler(10 ** 6, 11))


def encode(cell, frames):
    c = cell.config
    enc = Encoder(EncoderConfig(xl=c["xl"], yl=c["yl"], vector_level=c["vector_level"],
                                q_level=c["q_level"]), device="cpu")
    return enc.encode(frames, W, H, pframes_count=c["pframes_count"])


def drive(cell, units):
    drv = harness.load("drivers", cell.traffic["driver"]).Driver(cell)
    drv.setup()
    done = [drv.unit(i) for i in range(units)]
    if hasattr(drv, "close"):
        drv.close(units)
    return drv, done


def test_resident_chunks_are_the_encoders_stream():
    cell = make_cell("sd576_p11_vl2", "resident", chunk_frames=5)
    drv, done = drive(cell, 4)
    body = sequence_header(W, H) + b"".join(a.bytes() for a in cell.sampler.kept)
    src = drv.source(0)
    assert sum(u.frames for u in done) == 20
    assert sum(u.bits for u in done) == 8 * (len(body) - len(sequence_header(W, H)))
    assert body + sequence_end(len(body)) == encode(cell, [src(k) for k in range(20)])


@pytest.mark.parametrize("traffic, extra, units, lengths", [
    ("host_chunks", dict(chunk_frames=4, sequence_frames=12), 7, [12, 12, 4]),
    ("live", dict(sequence_frames=9), 14, [9, 5])])
def test_sequences_are_the_encoders_streams(traffic, extra, units, lengths):
    cell = make_cell("hd1152_p23_vl3", traffic, **extra)
    drv, done = drive(cell, units)
    seqs = sorted(cell.sampler.kept, key=lambda a: a.seq)
    assert [a.n for a in seqs] == lengths and [a.seq for a in seqs] == list(range(len(lengths)))
    assert all(a.whole for a in seqs)
    assert sum(lengths) == sum(u.frames for u in done)
    for a in seqs:
        src = drv.source(a.seq)
        assert a.bytes() == encode(cell, [src(k) for k in range(a.n)])


def test_live_times_every_frame():
    cell = make_cell("sd576_p11_vl2", "live", sequence_frames=4)
    _, done = drive(cell, 5)
    assert all(len(u.latencies) == 1 and u.latencies[0] > 0 for u in done)
