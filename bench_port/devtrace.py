"""The device trace of a run's traced stretch, from ``torch.profiler``.

The profiler runs only over the traced units, inside a host span named
``bench_window``; the run synchronises the card before the span opens and
before it closes, so the span holds all the device work of those units.
From the trace this module reads the device's operations (kernels, copies,
fills) with their times, the busy time (the union of their intervals), the
idle gaps between them and what the host was doing in each.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    start: float       # seconds from the window's start
    end: float


@dataclasses.dataclass
class Trace:
    ops: List[Op]                      # device operations inside the window
    window_s: float
    busy_s: float
    gaps: List[Tuple[str, float]]      # each idle gap: what the host was doing, seconds

    def time_of(self, names) -> float:
        """Device seconds of the operations whose name contains one of ``names``."""
        return sum(o.end - o.start for o in self.ops if any(n in o.name for n in names))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_op: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by_op[short_name(o.name)] += o.end - o.start
        by_host: Dict[str, float] = defaultdict(float)
        for what, s in self.gaps:
            by_host[what] += s
        return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                                    key=lambda kv: -kv[1])[:top]}


def short_name(name: str) -> str:
    """A kernel's name without its namespaces' "(anonymous namespace)", its
    argument list and its template arguments."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    depth, out = 0, []
    for ch in base:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">" and depth > 0
    return "".join(out).replace("void ", "").strip()[:80]


class Profiler:
    """Starts and stops torch.profiler around the traced units."""

    def __init__(self, device):
        self.device = device

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._span = record_function(WINDOW)
        self._span.__enter__()

    def stop(self) -> Trace:
        import torch
        torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return reduce(events)


def reduce(events: List[dict]) -> Trace:
    """Chrome-trace events -> the window's Trace."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    t0, t1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    ops = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            if s + d > t0 and s < t1:
                ops.append(Op(e["name"], e["cat"], (max(s, t0) - t0) / 1e6,
                              (min(s + d, t1) - t0) / 1e6))
    ops.sort(key=lambda o: o.start)
    busy, gaps, cursor = 0.0, [], 0.0
    host = [(float(e["ts"]) - t0, float(e["ts"]) + float(e["dur"]) - t0, e["name"])
            for e in spans if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]

    def host_doing(a: float, b: float) -> str:
        mid = (a + b) / 2 * 1e6
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        return min(inside)[1] if inside else "no host span"

    window_s = (t1 - t0) / 1e6
    for o in ops + [Op("", "", window_s, window_s)]:
        if o.start > cursor:
            gaps.append((host_doing(cursor, o.start), o.start - cursor))
        busy += max(0.0, o.end - max(o.start, cursor))
        cursor = max(cursor, o.end)
    return Trace(ops, window_s, busy, gaps)
