"""Raw YUV 4:4:4 file I/O.

File format matches the reference's fixture spec (README.md:284-294): per frame,
a full-resolution Y plane, then U, then V, each H*W bytes, frames concatenated
(`ffmpeg -i in.mp4 -pix_fmt yuv444p out.yuv`)."""
from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

Frame = Tuple[np.ndarray, np.ndarray, np.ndarray]


def frame_count(path: str, width: int, height: int) -> int:
    fsz = os.path.getsize(path)
    return fsz // (3 * width * height)


def read_frames(path: str, width: int, height: int) -> Iterator[Frame]:
    """Yield (Y, U, V) uint8 planes per frame; trailing partial frames are ignored
    (the reference testbench reads until EOF the same way, SIM/tb_mpeg2encoder.v:220)."""
    plane = width * height
    with open(path, "rb") as f:
        while True:
            buf = f.read(3 * plane)
            if len(buf) < 3 * plane:
                return
            a = np.frombuffer(buf, np.uint8)
            yield (a[:plane].reshape(height, width),
                   a[plane:2 * plane].reshape(height, width),
                   a[2 * plane:].reshape(height, width))


def read_all(path: str, width: int, height: int) -> List[Frame]:
    return list(read_frames(path, width, height))


def write_frames(path: str, frames: List[Frame]) -> None:
    with open(path, "wb") as f:
        for y, u, v in frames:
            f.write(np.ascontiguousarray(y, np.uint8).tobytes())
            f.write(np.ascontiguousarray(u, np.uint8).tobytes())
            f.write(np.ascontiguousarray(v, np.uint8).tobytes())
