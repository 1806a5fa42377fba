"""The harness finds cells, configurations, traffic mixes, drivers, content,
stages and metric readers by name, from files alone."""
import json
import os

import pytest

import harness
from fpga_mpeg2_encoder_tpu_torch.models.encoder import bound_caps

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_from_files(cell):
    w = harness.workload(BENCH, cell)
    config = harness.load_json("configs", w["config"])
    traffic = harness.load_json("traffic", w["traffic"])
    assert config["name"] == w["config"]
    assert hasattr(harness.load("drivers", traffic["driver"]), "Driver")
    assert hasattr(harness.load("content", traffic["content"]), "make")
    for key in ("end_to_end", "per_layer"):
        entries = harness.metrics_of(BENCH, key, cell)
        assert entries, (cell, key)
        for m in entries:
            mod, _ = harness.reader(m["name"])
            assert callable(mod.read)
    names = {m["name"] for m in harness.metrics_of(BENCH, "end_to_end", cell)}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_and_caps(entry):
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["source"] == entry["source"] and config["name"] == entry["name"]
    assert (config["row_cap"], config["frame_cap"]) == bound_caps(config["width"],
                                                                  config["height"])
    assert config["width"] <= 16 << config["xl"] and config["height"] <= 16 << config["yl"]


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)


def test_dotted_metric_falls_back_to_its_family_reader():
    mod, part = harness.reader("idle_pct.resident")
    assert part == "resident" and mod.__name__.endswith("idle_pct")
    mod, part = harness.reader("frame_roofline_pct")
    assert part is None


@pytest.mark.parametrize("stage", harness.stage_names())
def test_every_stage_names_kernels_and_counts_work(stage):
    assert harness.reader(f"{stage}_roofline")[0].read
    mod = harness.load("stages", stage)
    assert mod.KERNELS
    nbytes, ops = mod.work(harness.Geometry(720, 576, 4), harness.Frame(False, bits=8000))
    assert nbytes > 0 and ops >= 0


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.workload(BENCH, "no_such.cell")
    with pytest.raises(FileNotFoundError):
        harness.load("stages", "no_such_stage")



def test_forbidden_modules_compare_whole_top_level_names():
    import run
    assert run.forbidden_modules(["fpga_mpeg2_encoder_tpu_torch.ops", "torch", "jaxtyping"]) == []
    assert run.forbidden_modules(["fpga_mpeg2_encoder_tpu.ops", "jaxlib.xla", "torch"]) \
        == ["fpga_mpeg2_encoder_tpu", "jaxlib"]


@pytest.mark.parametrize("cell", CELLS)
def test_host_threads_are_absent_or_a_positive_count(cell):
    threads = harness.load_json("traffic", harness.workload(BENCH, cell)["traffic"]) \
        .get("host_threads")
    assert threads is None or (isinstance(threads, int) and threads >= 1)


def test_run_takes_its_host_threads_from_the_traffic(monkeypatch):
    import torch

    import run
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: seen.append(
        torch.get_num_threads()) or {"checks": {}})
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        assert run.main(["--workload", "hd1152_p23_vl3.host_chunks", "--seed", "1",
                         "--seconds", "1"]) == 0
        assert seen == [1]
    finally:
        torch.set_num_threads(before)
