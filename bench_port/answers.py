"""What a run keeps for the check: a seeded sample of the answers that the
window produced, and the answers themselves."""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, List, Union

import numpy as np


@dataclasses.dataclass
class Answer:
    """Frames [first, first + n) of sequence ``seq``.  ``data`` is their
    bytes, or a function that gives them (a payload is turned into bytes
    only if it is sampled).  ``whole`` marks a finished sequence: its
    header, its frames and its end code."""
    seq: int
    first: int
    n: int
    data: Union[bytes, Callable[[], bytes]]
    whole: bool = False

    def bytes(self) -> bytes:
        return self.data if isinstance(self.data, bytes) else self.data()


class Sampler:
    """A uniform sample of ``k`` of the answers offered, drawn from the seed
    (reservoir sampling): which ones it keeps does not depend on how many
    the window produces."""

    def __init__(self, k: int, seed: int):
        self.k, self._rng, self._seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, answer: Answer, snapshot=None) -> None:
        """Offer ``answer``; where it is kept and ``snapshot`` is given, its
        data becomes ``snapshot()`` (a copy out of a buffer that the next
        unit overwrites)."""
        j = len(self.kept) if len(self.kept) < self.k else self._rng.randrange(self._seen + 1)
        self._seen += 1
        if j >= self.k:
            return
        if snapshot is not None:
            answer.data = snapshot()
        if j == len(self.kept):
            self.kept.append(answer)
        else:
            self.kept[j] = answer


def words_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    """The port's payload (32-bit words as int64, MSB first) -> its bytes."""
    return np.asarray(words).astype(">u4").tobytes()[: (nbits + 7) // 8]


@dataclasses.dataclass
class Unit:
    """What one unit of a window's work completed: frames whose bytes
    reached the host, their bits where the driver reads them, and the
    latencies of the calls the traffic times one by one (seconds)."""
    frames: int
    bits: int = 0
    latencies: List[float] = dataclasses.field(default_factory=list)
