"""What the port's own spans and counters recorded over the traced units:
``fpga_mpeg2_encoder_tpu_torch.utils.profiling.traced()``, which holds only
what happened while a profiler recorded, per traced frame.  The readers of
the program's spans and counters (``metrics/``) go through here.  A port
that records nothing there (one without the spans, or ``--program
control``, which does not run it) reads None.
"""
from __future__ import annotations

from typing import Optional


def _traced():
    from fpga_mpeg2_encoder_tpu_torch.utils import profiling
    traced = getattr(profiling, "traced", None)
    return None if traced is None else traced()


def span_per_frame(run, name: str, scale: float) -> Optional[float]:
    """Host seconds in the program's span ``name`` per traced frame, times
    ``scale``; None where the span never ran."""
    tally, n = _traced(), len(run.traced_frames)
    if tally is None or not n or name not in tally[0]:
        return None
    return scale * tally[0][name][1] / n


def count_per_frame(run, name: str) -> Optional[float]:
    """The program's counter ``name`` per traced frame; None where it
    counted nothing."""
    tally, n = _traced(), len(run.traced_frames)
    if tally is None or not n or not tally[1].get(name):
        return None
    return tally[1][name] / n
