"""The benchmark's engine: it finds a cell's configuration, traffic mix,
content, driver, stages and metric readers by name, from files alone, runs
the set-up and the measured window, reads the trace, checks the answers
and assembles the result line.

Layout, under this directory:

* ``configs/<name>.json``: a deployment (sizes, knobs, caps, guarantees);
* ``traffic/<name>.json``: a traffic mix's parameters, naming its driver
  and its content;
* ``drivers/<name>.py``: the entry into the program a mix drives;
* ``content/<name>.py``: a generator of frames from the seed;
* ``stages/<name>.py``: a stage's work count and the kernels that do it;
* ``metrics/<name>.py``: a metric's reader; ``a.b`` is read by ``a.b.py``
  where there is one, else by ``a.py`` with the part ``b``;
* ``BENCHMARK.json``, at the checkout's root, names the cells and which
  metrics each reports.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_port_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def reader(name: str):
    """(reader module, part) of the metric ``name``."""
    if os.path.isfile(os.path.join(HERE, "metrics", f"{name}.py")):
        return load("metrics", name), None
    family, _, part = name.partition(".")
    return load("metrics", family), part or None


def stage_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "stages"))
                  if f.endswith(".py"))


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, key: str, cell: str) -> List[dict]:
    """The entries of ``bench[key]`` that the cell reports."""
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Geometry:
    width: int
    height: int
    yr: int

    @property
    def mbx(self) -> int:
        return self.width // 16

    @property
    def mby(self) -> int:
        return self.height // 16

    @property
    def mb(self) -> int:
        return self.mbx * self.mby


@dataclasses.dataclass
class Frame:
    """A traced frame, as the stages' work counts read it: its type, its
    bits, the words its rows fill and the bit offset it is appended at."""
    is_i: bool
    bits: float = 0
    row_words: Optional[float] = None
    bit_offset: int = 0

    def __post_init__(self):
        if self.row_words is None:
            self.row_words = -(-self.bits // 32)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    device: object
    program: object
    pool: list
    sampler: object
    span: object = nullcontext


class Run:
    """What the window measured, and what the metric readers read."""

    def __init__(self, cell: Cell, setup_s: float):
        c = cell.config
        self.cell, self.setup_s = cell, setup_s
        self.geometry = Geometry(c["width"], c["height"], 2 * c["vector_level"])
        self.frames, self.elapsed_s, self.latencies = 0, 0.0, []
        self.trace, self.traced_frames, self.peaks = None, [], None

    def mpix_per_s(self) -> Optional[float]:
        g = self.geometry
        return g.width * g.height * self.frames / self.elapsed_s / 1e6 if self.frames else None

    def stage(self, name: str):
        return load("stages", name)

    def stages(self) -> Dict[str, object]:
        return {n: load("stages", n) for n in stage_names()}

    def roofline_share(self, name: str) -> Optional[float]:
        """The stage's bound over its device time, in percent, over the
        traced frames: the bound of a frame is the larger of its bytes over
        HBM's rate and its integer operations over the INT32 rate, the device
        time that of the kernels the stage file names.  None where the trace
        holds none of them."""
        stage = self.stage(name)
        t = self.trace.time_of(stage.KERNELS)
        if t <= 0:
            return None
        bound = sum(self.peaks.bound_s(*stage.work(self.geometry, f))
                    for f in self.traced_frames)
        return 100.0 * bound / t


def _frames_of(unit, first: int, pframes: int) -> List[Frame]:
    """The traced frames of a unit whose first frame has sequence index
    ``first``; its bits spread evenly (the work counts are linear in them)."""
    return [Frame((first + k) % (pframes + 1) == 0, unit.bits / unit.frames)
            for k in range(unit.frames)]


def _quantiles(values: List[float]) -> Optional[Dict[str, float]]:
    """p50, p90, p95, p99 and the largest of ``values`` (nearest rank)."""
    if not values:
        return None
    v = sorted(values)
    pick = {f"p{p}": v[max(0, -(-p * len(v) // 100) - 1)] for p in (50, 90, 95, 99)}
    return dict(pick, max=v[-1])


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, program,
             t_start: float, overrides: Optional[dict] = None, log=None,
             min_units: int = 1) -> dict:
    """One run of the cell ``name``; returns the result line's object.  The
    window lasts ``seconds`` and at least ``min_units`` units."""
    import torch

    import check as check_mod
    import devtrace
    import peaks as peaks_mod
    from answers import Sampler
    from reference.mpeg2 import Reference

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = benchmark()
    w = workload(bench, name)
    config = dict(load_json("configs", w["config"]), **(overrides or {}))
    traffic = load_json("traffic", w["traffic"])
    device = torch.device(device)
    content = load("content", traffic["content"])
    t_pool = time.perf_counter()
    pool = content.make(config["width"], config["height"], content.PERIOD, seed)
    t_pool = time.perf_counter() - t_pool
    cell = Cell(name, config, traffic, seed, device, program, pool,
                Sampler(traffic["check_answers"], seed))
    traced = trace and device.type == "cuda"
    if traced:
        cell.span = torch.profiler.record_function
    driver = load("drivers", traffic["driver"]).Driver(cell)
    t_driver = time.perf_counter()
    driver.setup()
    t_driver = time.perf_counter() - t_driver
    run = Run(cell, time.perf_counter() - t_start)
    if traced:
        run.peaks = peaks_mod.read(device)
        profiler = devtrace.Profiler(device)
    skip, n_traced = traffic["trace_skip_units"], traffic["trace_units"]
    log(f"{name}: set-up {run.setup_s:.3f} s (content {t_pool:.3f} s, the driver's "
        f"upload, warm-up and capture {t_driver:.3f} s), window {seconds} s")

    # set-up's objects out of the collector's way: a collection in the window
    # then walks only what the window allocates
    gc.collect()
    gc.freeze()
    unit_s = []
    units, t0 = 0, time.perf_counter()
    while True:
        t_unit = time.perf_counter()
        if traced and units == skip:
            profiler.start()
        with cell.span(traffic["driver"]):
            unit = driver.unit(units)
        if traced and skip <= units < skip + n_traced:
            first = units * unit.frames
            if "sequence_frames" in traffic:
                first %= traffic["sequence_frames"]
            run.traced_frames += _frames_of(unit, first, config["pframes_count"])
        unit_s.append(time.perf_counter() - t_unit)
        units += 1
        run.frames += unit.frames
        run.latencies += unit.latencies
        if traced and units == skip + n_traced:
            run.trace = profiler.stop()
        if time.perf_counter() - t0 >= seconds and units >= min_units \
                and (not traced or run.trace is not None):
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.elapsed_s = time.perf_counter() - t0
    gc.unfreeze()
    if hasattr(driver, "close"):
        driver.close(units)
    on_card = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    card = peaks_mod.card_state() if on_card else None

    # the program's state freed before the reference runs on the same card
    source_of = driver.source
    answers = cell.sampler.kept
    del driver
    program.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checked = check_mod.check(
        answers, lambda: Reference(config["width"], config["height"],
                                   yr=2 * config["vector_level"], q_level=config["q_level"],
                                   pframes_count=config["pframes_count"], device=device),
        source_of, seed, traffic.get("check_ranges", 1), traffic.get("check_range_frames", 1))
    log(f"{name}: checked {checked['frames_checked']} frames of {len(answers)} answers "
        f"in {time.perf_counter() - t_check:.3f} s")

    metrics = {}
    wanted = [] if trace and run.trace is None else \
        metrics_of(bench, "per_layer" if trace else "end_to_end", name)
    for m in wanted:
        mod, part = reader(m["name"])
        value = mod.read(run, part)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = check_mod.LIMITS
    checks = {k: {"value": checked[k], "limit": limits[k]} for k in limits}
    correct = checked["frames_checked"] > 0 and all(v["value"] <= v["limit"]
                                                   for v in checks.values())
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": w["chips"], "memory_peak_bytes": memory_peak}
    if run.peaks is not None:
        dev.update(power_limit_w=run.peaks.power_limit_w, sms=run.peaks.sms,
                   max_sm_clock_mhz=run.peaks.max_sm_clock_mhz)
    result = {"correct": correct, "attempted": run.frames, "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["window"] = {"seconds": run.elapsed_s, "frames": run.frames, "units": units,
                        **{k: checked[k] for k in ("frames_checked", "frames_differing",
                                                   "framing_errors")},
                        "unit_s_quantiles": _quantiles(unit_s),
                        "latency_s_quantiles": _quantiles(run.latencies),
                        "card_after": card}
    result["checks"] = checks
    return result
