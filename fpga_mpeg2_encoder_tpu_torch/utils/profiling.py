"""Stage profiling for the encoder pipeline.

``StageTimer`` accumulates wall time per named stage.  Work on a card is
asynchronous, so on a CUDA device it synchronises the device at each stage's
start and end: a stage's time is then the time of its own device work, and
the synchronisation costs what the pipeline would otherwise overlap.
``trace_to`` records a torch.profiler trace (host calls and, on a card, the
kernels) and writes it as a Chrome trace, viewable in Perfetto.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


class StageTimer:
    """Accumulates wall time per named stage on ``device`` (a CUDA device
    is synchronised at stage boundaries; None or a CPU device is not)."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> List[str]:
        out = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            out.append(f"{name:24s} {tot * 1000:9.2f} ms total"
                       f"  ({tot / n * 1000:8.2f} ms x {n})")
        return out


@contextlib.contextmanager
def trace_to(path: str):
    """Context manager: trace the enclosed work with torch.profiler (the
    CUDA activity too when torch sees a card) and write it to ``path`` as a
    Chrome trace.  Yields the profiler, whose ``key_averages()`` sum the
    time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
