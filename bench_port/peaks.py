"""The card's peaks that the roofline shares are taken against.

* HBM: 3.35 TB/s, NVIDIA's H100 SXM data sheet.
* INT32: the card's SM count x 64 INT32 lanes a clock x its maximum SM
  clock (``nvidia-smi clocks.max.sm``), read on the card.  The 64 lanes are
  the Hopper SM's (NVIDIA's H100 architecture whitepaper), not a data-sheet
  rate: the sheet gives none for INT32.  The motion search's byte-SIMD
  absolute differences run four to an INT32 operation.
"""
from __future__ import annotations

import dataclasses
import subprocess
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


@dataclasses.dataclass
class Peaks:
    sms: int
    max_sm_clock_mhz: float
    power_limit_w: Optional[float] = None

    @property
    def int32_ops_per_s(self) -> float:
        return self.sms * INT32_LANES_PER_SM * self.max_sm_clock_mhz * 1e6

    def bound_s(self, nbytes: float, ops: float) -> float:
        """The least time the card could take: bytes over HBM's rate or
        operations over the INT32 rate, whichever is longer."""
        return max(nbytes / HBM_BYTES_PER_S, ops / self.int32_ops_per_s)


def _smi(field: str) -> Optional[float]:
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def card_state() -> dict:
    """The card's SM clock (MHz), power draw (W) and temperature (C) now."""
    return {f: _smi(f) for f in ("clocks.sm", "power.draw", "temperature.gpu")}


def read(device) -> Peaks:
    """The peaks of the card ``device``, read on it."""
    import torch
    clock = _smi("clocks.max.sm")
    if clock is None:
        raise RuntimeError("nvidia-smi gave no clocks.max.sm: the INT32 peak is unknown")
    return Peaks(torch.cuda.get_device_properties(device).multi_processor_count, clock,
                 _smi("power.limit"))
