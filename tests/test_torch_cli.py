"""The port's command line (cli/encode.py, cli/decode.py), its copies of the
golden decoder and ISO validator, utils/yuv.py, utils/profiling.py and
runtime/invariants.py, against the JAX package's, exact.  The encode
command runs as a subprocess with ``--device cpu`` (the plain versions),
three sequences back to back through one encoder as the reference
testbench does (README.md:655)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import torch_ranks as R
from fpga_mpeg2_encoder_tpu.cli import decode as jax_decode_cli
from fpga_mpeg2_encoder_tpu.cli import encode as jax_encode_cli
from fpga_mpeg2_encoder_tpu.config import EncoderConfig as JaxConfig
from fpga_mpeg2_encoder_tpu.config import SequenceConfig as JaxSeq
from fpga_mpeg2_encoder_tpu.golden import decoder as JD
from fpga_mpeg2_encoder_tpu.golden import encoder as G
from fpga_mpeg2_encoder_tpu.golden import validator as JV
from fpga_mpeg2_encoder_tpu.utils import yuv as jax_yuv
from fpga_mpeg2_encoder_tpu_torch import EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.cli import decode as decode_cli
from fpga_mpeg2_encoder_tpu_torch.cli import encode as encode_cli
from fpga_mpeg2_encoder_tpu_torch.golden import decoder as D
from fpga_mpeg2_encoder_tpu_torch.golden import encoder as PG
from fpga_mpeg2_encoder_tpu_torch.golden import validator as V
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M
from fpga_mpeg2_encoder_tpu_torch.runtime.invariants import verify_recon_chain
from fpga_mpeg2_encoder_tpu_torch.utils import yuv
from fpga_mpeg2_encoder_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(64, 64), (96, 64), (80, 80)]


def _encode_cli(args):
    """The port's encode command in a subprocess on the CPU -> its stdout."""
    r = subprocess.run([sys.executable, "-m", "fpga_mpeg2_encoder_tpu_torch.cli.encode",
                        *args, "--device", "cpu", "--quiet"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                            "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three clips and the port CLI's streams of them, back to back, with
    --chunk 1 and with --chunk 4: (dir, args of each run, stats of each run)."""
    d = tmp_path_factory.mktemp("cli")
    runs = {}
    for chunk in (1, 4):
        args = []
        for i, (w, h) in enumerate(SIZES):
            src = str(d / f"in{i}.yuv")
            if chunk == 1:
                yuv.write_frames(src, R.video(70 + i, w, h, 5, ("pan", "noise", "pan")[i]))
            args += ["--input", src, "--size", f"{w}x{h}",
                     "--out", str(d / f"out{i}_c{chunk}.m2v")]
        args += ["--pframes", "1", "--chunk", str(chunk)]
        stdout = _encode_cli(args + ["--stats"])
        runs[chunk] = (args, [json.loads(ln) for ln in stdout.splitlines() if ln])
    return d, runs


def test_cli_three_sequences_back_to_back(clips):
    """The port CLI's streams equal the golden model's on the three clips,
    and the JAX CLI's (run in this process) on the first: the JAX CLI
    compiles its frame step for each size, ~15 s a size here, and
    tests/test_runtime_tools.py holds it to the golden model at all three."""
    d, runs = clips
    assert jax_encode_cli.main(["--input", str(d / "in0.yuv"), "--size", "64x64",
                                "--out", str(d / "out0_jax.m2v"), "--pframes", "1",
                                "--quiet"]) == 0
    assert (d / "out0_c1.m2v").read_bytes() == (d / "out0_jax.m2v").read_bytes()
    for i, (w, h) in enumerate(SIZES):
        frames = yuv.read_all(str(d / f"in{i}.yuv"), w, h)
        gold = G.encode_sequence(JaxConfig(xl=5, yl=5), JaxSeq(w, h, 1), frames)
        assert (d / f"out{i}_c1.m2v").read_bytes() == gold, i


def test_cli_stats_equal_between_chunk_1_and_chunk_4(clips):
    """Per-frame stats (bits and frame types) and the streams are the same
    whether the CLI streams frames or pushes chunks of 4 (5 frames: a chunk
    of 4 and one of 1); both report a frame rate from the encoder's wall
    time and count the blocking device reads (3 a frame streamed, 7 a
    chunk); on the CPU no kernel is launched, no graph captured, and no
    overflow retried at the CLI's caps."""
    d, runs = clips
    for i in range(len(SIZES)):
        a, b = runs[1][1][i], runs[4][1][i]
        for key in ("frames", "bytes", "avg_bits_per_frame", "frame_bits", "types"):
            assert a[key] == b[key], (i, key)
        assert a["types"] == "IPIPI" and a["frames"] == 5
        assert not any(a["kernel_launches"].values())
        for run, syncs in ((a, 3 * 5), (b, 7 * 2)):
            assert run["fps"] is not None and run["mpixels_per_s"] is not None
            assert run["wall_s"] > 0
            assert (run["host_syncs"], run["overflow_retries"], run["graph_captures"]) \
                == (syncs, 0, 0)
        assert (d / f"out{i}_c1.m2v").read_bytes() == (d / f"out{i}_c4.m2v").read_bytes()


@pytest.mark.parametrize("chunk", [1, 2])
def test_cli_caps_hold_the_largest_size(tmp_path, monkeypatch, chunk):
    """The CLI's caps are the analytic bounds of its largest size: noise
    clips of two sizes are encoded once a frame (or chunk), at those caps,
    with no overflow retry, and equal the golden model's streams."""
    calls = []
    for name in ("encode_frame_device", "encode_gop_scan"):
        real = getattr(M, name)

        def rec(*a, _real=real, **kw):
            calls.append((kw["row_cap"], kw["frame_cap"]))
            return _real(*a, **kw)
        monkeypatch.setattr(M, name, rec)
    sizes, args = [(64, 64), (96, 80)], []
    for i, (w, h) in enumerate(sizes):
        yuv.write_frames(str(tmp_path / f"in{i}.yuv"), R.video(95 + i, w, h, 2, "noise"))
        args += ["--input", str(tmp_path / f"in{i}.yuv"), "--size", f"{w}x{h}",
                 "--out", str(tmp_path / f"out{i}.m2v")]
    assert encode_cli.main(args + ["--pframes", "1", "--chunk", str(chunk), "--device", "cpu",
                                   "--quiet"]) == 0
    assert calls == [M.bound_caps(96, 80)] * (4 // chunk)
    for i, (w, h) in enumerate(sizes):
        gold = G.encode_sequence(JaxConfig(xl=5, yl=5), JaxSeq(w, h, 1),
                                 yuv.read_all(str(tmp_path / f"in{i}.yuv"), w, h))
        assert (tmp_path / f"out{i}.m2v").read_bytes() == gold, i


def test_decode_cli_validate_matches_jax(clips, capsys):
    """decode --validate --ref: the port's command (its own decoder and
    validator copies) prints what the JAX package's prints."""
    d, _ = clips
    args = ["--input", str(d / "out1_c1.m2v"), "--ref", str(d / "in1.yuv"), "--validate",
            "--out-yuv", str(d / "port.yuv420")]
    assert decode_cli.main(args) == 0
    got = json.loads(capsys.readouterr().out)
    args[-1] = str(d / "jax.yuv420")
    assert jax_decode_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want and got["validator"] == "pass" and got["psnr_y_mean"] > 0
    assert (d / "port.yuv420").read_bytes() == (d / "jax.yuv420").read_bytes()


@pytest.mark.parametrize("w,h,n,kind,pframes", [(64, 64, 4, "pan", 2), (416, 64, 3, "noise", 23),
                                                (96, 80, 5, "still", 1)])
def test_golden_decoder_and_validator_copies_match_reference(w, h, n, kind, pframes):
    """On golden streams: the port's decoder gives the reference decoder's
    pictures, and its validator the reference validator's results."""
    frames = R.video(80 + w, w, h, n, kind)
    data = G.encode_sequence(JaxConfig(xl=5, yl=5), JaxSeq(w, h, pframes), frames)
    got, want = D.decode_sequence(data), JD.decode_sequence(data)
    assert (got.width, got.height, len(got.pictures)) == (want.width, want.height, n)
    for p, q in zip(got.pictures, want.pictures):
        assert p.coding_type == q.coding_type
        assert all(np.array_equal(getattr(p, c), getattr(q, c)) for c in "yuv")
    vg = V.validate_sequence(data, expected_frames=n)
    vw = JV.validate_sequence(data, expected_frames=n)
    recon = [(p.y, p.u, p.v) for p in want.pictures]
    assert vg.gop_timecodes == vw.gop_timecodes
    assert vg.psnr_vs(recon, 0) == vw.psnr_vs(recon, 0)
    with pytest.raises(V.ValidationError):
        V.validate_sequence(data[:len(data) // 2] + b"\x00" * 64, expected_frames=n)
    for c in range(3):
        assert np.array_equal(PG.subsample_420(*frames[0])[c], G.subsample_420(*frames[0])[c])


def test_recon_chain_invariant():
    rep = verify_recon_chain(EncoderConfig(xl=4, yl=4), SequenceConfig(64, 64, 2),
                             R.video(90, 64, 64, 4), recheck_every=2, device="cpu")
    assert rep == {"frames": 4, "checkpoints_verified": 2}


def test_yuv_files_match_reference(tmp_path):
    frames = R.video(91, 96, 64, 3, "noise")
    yuv.write_frames(str(tmp_path / "a.yuv"), frames)
    jax_yuv.write_frames(str(tmp_path / "b.yuv"), frames)
    assert (tmp_path / "a.yuv").read_bytes() == (tmp_path / "b.yuv").read_bytes()
    with open(tmp_path / "a.yuv", "ab") as f:
        f.write(b"\x01" * 100)                      # a trailing partial frame
    assert yuv.frame_count(str(tmp_path / "a.yuv"), 96, 64) == 3
    got = yuv.read_all(str(tmp_path / "a.yuv"), 96, 64)
    assert all(np.array_equal(a, b) for g, f in zip(got, frames) for a, b in zip(g, f))


def test_stage_timer_and_trace(tmp_path):
    """trace_to writes the profiler's Chrome trace with the spans in it;
    a span records into the tally only while a profiler records."""
    profiling.reset()
    with profiling.span("add", 7):
        torch.ones(64).add_(1)
    assert profiling.traced() == ({}, {})
    path = str(tmp_path / "trace.json")
    with profiling.trace_to(path) as prof:
        for _ in range(2):
            with profiling.span("add", 7):
                torch.ones(64).mul_(3)
    calls, seconds = profiling.traced()[0]["add"]
    assert calls == 2 and seconds > 0
    assert any("mul" in e.key for e in prof.key_averages())
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e["cat"] for e in events if e.get("name") == "add"] == ["user_annotation"] * 2
    profiling.reset()
    assert profiling.traced() == ({}, {})
