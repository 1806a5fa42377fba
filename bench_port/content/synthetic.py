"""Synthetic content: an entropy-heavy texture over diagonal ramps that pans
2 pixels down and 3 across a frame, inside every search range.  The pan
repeats every 64 frames, so a pool of PERIOD frames cycles seamlessly.
At seed 42 the frames are those of the repository's headline benchmark.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

PERIOD = 64
_PAD = 64


def make(width: int, height: int, n: int, seed: int
         ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """n frames of (y, u, v) uint8 (height, width) 4:4:4 planes from ``seed``."""
    rng = np.random.default_rng(seed % (1 << 64))
    yy, xx = np.mgrid[0:height + _PAD, 0:width + _PAD]
    tex = rng.integers(0, 48, (height + _PAD, width + _PAD)).astype(np.int32)
    y = (((xx * 3 + yy * 2) // 4) % 200 + tex).astype(np.uint8)
    u = ((xx - yy) // 3 % 160 + 48).astype(np.uint8)
    v = ((xx + yy) // 5 % 120 + 64).astype(np.uint8)
    out = []
    for i in range(n):
        dy, dx = (i * 2) % _PAD, (i * 3) % _PAD
        out.append(tuple(p[dy:dy + height, dx:dx + width].copy() for p in (y, u, v)))
    return out
