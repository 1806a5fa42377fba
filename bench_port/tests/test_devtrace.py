"""The reduction of a chrome trace to busy time, idle gaps and the
per-layer metrics' readings, on a trace written by hand."""
import pytest

import devtrace
import harness
import peaks


def span(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    span(devtrace.WINDOW, "user_annotation", 1000.0, 100.0),
    span("push_chunk", "user_annotation", 1000.0, 60.0),
    span("cudaGraphLaunch", "cuda_runtime", 1040.0, 5.0),
    span("void (anonymous namespace)::me_fused_kernel<6>(int)", "kernel", 1010.0, 20.0),
    span("transform_kernel", "kernel", 1025.0, 10.0),           # overlaps the first
    span("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1060.0, 20.0),
    span("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1090.0, 30.0),   # past the end
    span("outside_kernel", "kernel", 900.0, 50.0),
]


def test_reduce_busy_idle_and_gaps():
    t = devtrace.reduce(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    assert len(t.ops) == 4
    # busy: [10, 35) + [60, 80) + [90, 100)
    assert t.busy_s == pytest.approx(55e-6)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["push_chunk"] == pytest.approx(10e-6 + 25e-6)
    assert gaps["no host span"] == pytest.approx(10e-6)
    ops = dict(t.breakdown()["device_ops"])
    assert ops["me_fused_kernel"] == pytest.approx(20e-6)


def test_reduce_needs_the_window_span():
    with pytest.raises(RuntimeError):
        devtrace.reduce(EVENTS[1:])


class FakeRun:
    def __init__(self, trace, frames):
        self.trace, self.traced_frames = trace, frames
        self.geometry = harness.Geometry(64, 64, 6)
        self.peaks = peaks.Peaks(132, 1980.0)

    stage = harness.Run.stage
    stages = harness.Run.stages
    roofline_share = harness.Run.roofline_share


def test_readers_on_the_trace():
    run = FakeRun(devtrace.reduce(EVENTS), [harness.Frame(False, bits=4096)] * 2)
    idle, _ = harness.reader("idle_pct.resident")
    assert idle.read(run, "resident") == pytest.approx(45.0)
    up, _ = harness.reader("upload_ms_per_frame.host")
    assert up.read(run, "host") == pytest.approx(20e-6 * 1e3 / 2)
    kpf, _ = harness.reader("kernels_per_frame")
    assert kpf.read(run) == 2.0
    roof, part = harness.reader("motion_roofline")
    bound = 2 * run.peaks.bound_s(*run.stage("motion").work(run.geometry, run.traced_frames[0]))
    assert roof.read(run, part) == pytest.approx(100 * bound / 20e-6)


def test_download_reader_on_the_trace():
    run = FakeRun(devtrace.reduce(EVENTS), [harness.Frame(True, bits=4096)] * 2)
    for name in ("download_ms_per_frame.hd1152", "download_ms_per_frame.hd1152i"):
        down, part = harness.reader(name)
        # the DtoH copy's 10 us inside the window, over 2 frames
        assert down.read(run, part) == pytest.approx(10e-6 * 1e3 / 2)
    empty = FakeRun(devtrace.reduce(EVENTS[:1]), [harness.Frame(True)])
    assert down.read(empty, part) is None


def test_readers_return_nothing_where_nothing_ran():
    run = FakeRun(devtrace.reduce(EVENTS), [harness.Frame(True)])
    roof, part = harness.reader("acsym_roofline")
    assert roof.read(run, part) is None
    empty = FakeRun(devtrace.reduce(EVENTS[:1]), [harness.Frame(True)])
    for name in ("idle_pct.live", "upload_ms_per_frame.live", "kernels_per_frame",
                 "frame_roofline_pct"):
        mod, part = harness.reader(name)
        assert mod.read(empty, part) is None, name


def test_short_names():
    assert devtrace.short_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int, 2>(int*)") \
        == "at::native::CatArrayBatchedCopy"


def test_frame_ms_p95_is_the_nearest_rank():
    mod, _ = harness.reader("frame_ms_p95")

    class R:
        latencies = [i / 1e3 for i in range(1, 101)]
    assert mod.read(R()) == pytest.approx(95.0)
    R.latencies = []
    assert mod.read(R()) is None
