"""What the tools share: the repo root on the import path (for bench.py's
content), the card's name and power limit, and timing on the card or the
host."""
from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_content():
    """bench.py (make_frames, make_filmic_frames, PAYLOAD_SHA256); its
    module level imports no jax."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import bench
    return bench


def card(dev: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device() if len(out) > 1 else 0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class RepTimer:
    """Times reps queued back to back: CUDA events between the reps on a
    card (the device's timeline), the host clock on the CPU.  ``mark()``
    after each rep; ``ms()`` -> each rep's milliseconds."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self):
        sync(self.dev)
        if self.dev.type == "cuda":
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
