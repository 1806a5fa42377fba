"""The port's tools (fpga_mpeg2_encoder_tpu_torch/tools/) on the CPU: the
quality sweep's q_level 2 / vector_level 3 row at its real geometry equals
docs/QUALITY.md's; the chunked soak at a small size gives the JAX golden
model's stream; the benchmark and profiling tools run their --device cpu
smoke modes and print rows of the expected shape (no device times: there is
no card); and every tool refuses to run without a card unless the CPU is
asked for."""
import hashlib
import json
import re

import pytest
import torch

torch.set_num_threads(1)

from fpga_mpeg2_encoder_tpu.config import EncoderConfig as JaxConfig
from fpga_mpeg2_encoder_tpu.config import SequenceConfig as JaxSeq
from fpga_mpeg2_encoder_tpu.golden import encoder as JG
from fpga_mpeg2_encoder_tpu_torch.tools import (bench_configs, common, profile_batched,
                                                profile_sharded, profile_stages,
                                                quality_filmic, quality_sweep,
                                                soak_chunked)

TOOLS = (bench_configs, profile_batched, profile_sharded, profile_stages, quality_filmic,
         quality_sweep, soak_chunked)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_quality_sweep_row_equals_quality_md(capsys):
    assert quality_sweep.main(["--device", "cpu", "--rows", "2/3"]) == 0
    out = capsys.readouterr().out
    assert "| 2 | 3 | 83008 | 26.6:1 | 38.28 dB | 33.78 dB |" in out.splitlines()
    (row,) = _json_lines(out)
    assert row["stream_bytes"] == 83008 and row["device"] == "cpu"


def test_soak_chunked_small_equals_jax_golden(capsys, monkeypatch):
    for k, v in dict(SOAK_W="64", SOAK_H="64", SOAK_NF="30", SOAK_CHUNKS="8,5").items():
        monkeypatch.setenv(k, v)
    assert soak_chunked.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"SOAK OK  bytes=(\d+)  digest=([0-9a-f]{64})", out)
    assert m, out
    frames = common.bench_content().make_frames(64, 64, 30)
    want = JG.encode_sequence(JaxConfig(4, 4), JaxSeq(64, 64, 23), frames)
    assert (int(m.group(1)), m.group(2)) == (len(want), hashlib.sha256(want).hexdigest())
    assert out.count("sha256=" + m.group(2)) == 2


def test_bench_configs_smoke(capsys):
    assert bench_configs.main(["--device", "cpu", "--smoke", "--reps", "2",
                               "--batches", "1"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [(r["metric"], r["q_level"]) for r in rows] == [
        ("smoke_single", 1), ("smoke_single", 2), ("smoke_batch", 2)]
    for r in rows:
        assert r["unit"] == "MPixels/s" and r["value"] > 0 and r["device"] == "cpu"
        assert len(r["ms_per_rep"]) == 1 and len(r["ms_per_rep"][0]) == 2
    assert len(rows[2]["payload_bytes"]) == 2


def test_profile_stages_smoke(capsys):
    assert profile_stages.main(["--device", "cpu", "--size", "64x64", "--reps", "2"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["stage"] for r in rows[:-1]] == list(profile_stages.STAGES) + ["whole step"]
    for r in rows[:-1]:
        assert r["device_ms"] is None and r["host_ms"] > 0 and r["device"] == "cpu"
    assert rows[-1]["stages_device_ms"] is None


def test_profile_batched_smoke(capsys):
    assert profile_batched.main(["--device", "cpu", "--size", "64x64", "--streams", "2",
                                 "--reps", "1", "--frames", "2"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["stage"] for r in rows] == list(profile_stages.STAGES) + ["whole step",
                                                                        "frame loop"]
    for r in rows:
        assert r["b1"]["device_ms"] is None and r["b2"]["host_ms"] > 0
        assert r["host_ms_ratio"] > 0


def test_profile_sharded_smoke(capsys):
    assert profile_sharded.main(["--device", "cpu", "--size", "64x64", "--frames", "3"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert [r["metric"] for r in rows] == [
        "frame_step_plain_64x64", "frame_step_device_64x64",
        "frame_step_sharded1_eager_64x64", "frame_step_sharded1_64x64",
        "sharded_overhead_1rank_eager_pct", "sharded_overhead_1rank_pct",
        "frame_step_sharded_multicard_64x64"]
    assert all(len(r["ms_each"]) == 2 for r in rows[:4])
    assert rows[6]["value"] is None and "not run" in rows[6]["note"]


@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_tool_refuses_missing_cuda(tool):
    """A tool's default device is the card: without one it raises, never
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])
