"""The readers of the port's own spans and counters (``tally.py``), on a
fake run whose tally is filled by hand: each returns the tally over the
traced frames, and None where the tally holds nothing or the port has no
``traced()``."""
import types

import pytest

import harness
from fpga_mpeg2_encoder_tpu_torch.utils import profiling

FRAMES = 80
SPANS = {"push_chunk.stack": (2, 0.08), "push_chunk.upload": (2, 0.12),
         "push_chunk.sync": (2, 0.016), "push_chunk.download": (2, 0.024),
         "gop.feed": (80, 0.0064)}
COUNTERS = {"host_syncs": 14, "host_launches": 334}
# each metric's reading of SPANS and COUNTERS over 80 traced frames
READINGS = {
    "stack_ms_per_frame.host": 1.0,
    "upload_host_ms_per_frame.host": 1.5,
    "sync_ms_per_frame.host": 0.2,
    "download_host_ms_per_frame.host": 0.3,
    "host_syncs_per_frame.host": 0.175,
    "enqueue_us_per_frame.hd1152": 80.0,
    "enqueue_us_per_frame.sd576": 80.0,
    "host_launches_per_frame.hd1152": 4.175,
    "host_launches_per_frame.sd576": 4.175,
}
RUN = types.SimpleNamespace(traced_frames=[harness.Frame(False, bits=4096)] * FRAMES)


def test_every_new_metric_is_in_the_benchmark():
    names = {m["name"] for m in harness.benchmark()["per_layer"]}
    assert set(READINGS) <= names


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_divides_the_tally_by_the_traced_frames(monkeypatch, metric):
    monkeypatch.setattr(profiling, "traced", lambda: (dict(SPANS), dict(COUNTERS)))
    mod, part = harness.reader(metric)
    assert mod.read(RUN, part) == pytest.approx(READINGS[metric])


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_is_none_on_an_empty_tally(monkeypatch, metric):
    mod, part = harness.reader(metric)
    monkeypatch.setattr(profiling, "traced", lambda: ({}, {}))
    assert mod.read(RUN, part) is None
    assert mod.read(types.SimpleNamespace(traced_frames=[]), part) is None
    monkeypatch.delattr(profiling, "traced")        # a port without the spans
    assert mod.read(RUN, part) is None
