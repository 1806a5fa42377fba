"""CLI: raw YUV 4:4:4 -> MPEG-2 elementary stream.

The equivalent of the reference testbench (SIM/tb_mpeg2encoder.v:142-274):
reads planar YUV frames, validates dimensions the same way (tb:189-201), feeds
the encoder, writes the `.m2v` stream.  It runs on a CUDA card unless
``--device cpu`` asks for the plain versions on the CPU.

    python -m fpga_mpeg2_encoder_tpu_torch.cli.encode \\
        --input data/288x208.yuv --size 288x208 --out data/288x208.m2v \\
        --pframes 23 --q-level 2 --vector-level 3 --chunk 8

Multiple --input/--size/--out triples encode several sequences back-to-back
through one encoder instance, exercising sequence restart like the reference's
3-video run (SIM/tb_mpeg2encoder.v:150, README.md:655).  ``--stats`` prints a
JSON line per sequence: the summary (``fps`` and ``mpixels_per_s`` from the
encoder's wall time, chunked or not), each frame's bits and type, the
kernel launches of the sequence (zero on the CPU) and its counts of blocking
device reads (``host_syncs``), overflow re-encodes (``overflow_retries``),
programs captured (``graph_captures``, zero on the CPU), chunked frames
copied up through page-locked slots (``staged_frames``, zero on the CPU) and
waits for a slot's copy to end (``staging_waits``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ..config import EncoderConfig, SequenceConfig
from ..models.encoder import Encoder, bound_caps
from ..ops.kernels import _build
from ..utils import profiling, yuv
from ..utils.logging import ProgressLogger

STATS_COUNTERS = ("host_syncs", "overflow_retries", "graph_captures", "staged_frames",
                  "staging_waits")


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _level_for(extent: int) -> int:
    for xl in (4, 5, 6, 7):
        if extent <= (16 << xl):
            return xl
    raise SystemExit(f"dimension {extent} exceeds the 2048 maximum")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="fpga_mpeg2_encoder_tpu_torch.cli.encode",
        description="MPEG-2 encoder on a CUDA card: raw YUV 4:4:4 in, .m2v out")
    p.add_argument("--input", action="append", required=True,
                   help="planar YUV 4:4:4 file (frame-major Y,U,V planes)")
    p.add_argument("--size", action="append", required=True,
                   help="WxH, multiples of 16, each in [64, 2048]")
    p.add_argument("--out", action="append", required=True, help="output .m2v")
    p.add_argument("--pframes", type=int, default=23,
                   help="P-frames between I-frames (0..255; default 23 like the "
                        "reference testbench)")
    p.add_argument("--q-level", type=int, default=2, choices=(1, 2, 3, 4))
    p.add_argument("--vector-level", type=int, default=3, choices=(1, 2, 3))
    p.add_argument("--chunk", type=int, default=1,
                   help="frames per device-resident chunk (1 = streaming)")
    p.add_argument("--stop-mode", default="clean",
                   choices=("clean", "coincident"),
                   help="sequence-stop semantics; both produce identical streams "
                        "(stop on the last pixel cycle pads nothing, RTL:1048-1079)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--stats", action="store_true", help="print JSON stats")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    if not (len(args.input) == len(args.size) == len(args.out)):
        p.error("--input/--size/--out must be given the same number of times")

    sizes = [_parse_size(s) for s in args.size]
    for w, h in sizes:
        if w % 16 or h % 16 or not (64 <= w <= 2048 and 64 <= h <= 2048):
            p.error(f"invalid size {w}x{h}: multiples of 16 in [64, 2048]")

    max_w, max_h = max(w for w, _ in sizes), max(h for _, h in sizes)
    # caps at the bounds of the largest size: no frame overflows them, so
    # every frame is encoded once, wholly on the device
    row_cap, frame_cap = bound_caps(max_w, max_h)
    enc = Encoder(EncoderConfig(xl=_level_for(max_w), yl=_level_for(max_h),
                                vector_level=args.vector_level, q_level=args.q_level),
                  row_cap=row_cap, frame_cap=frame_cap, device=args.device)
    log = ProgressLogger(enabled=not args.quiet)

    for src, (w, h), dst in zip(args.input, sizes, args.out):
        n = yuv.frame_count(src, w, h)
        log.info(f"encoding {src} ({w}x{h}, {n} frames) -> {dst}")
        t0 = time.perf_counter()
        _build.reset_launches()
        profiling.COUNTS.clear()
        enc.start_sequence(SequenceConfig(w, h, args.pframes))
        if args.chunk > 1:
            buf = []
            for f in yuv.read_frames(src, w, h):
                buf.append(f)
                if len(buf) == args.chunk:
                    enc.push_chunk(buf)
                    buf = []
            if buf:
                enc.push_chunk(buf)
        else:
            for idx, f in enumerate(yuv.read_frames(src, w, h)):
                enc.push_frame(*f)
                st = enc.stats.frames[-1]
                log.frame(idx, st.i_frame, st.bits // 8)
        stats = enc.stats
        stream = enc.finish(stop_mode=args.stop_mode)
        with open(dst, "wb") as f:
            f.write(stream)
        dt = time.perf_counter() - t0
        log.info(f"  wrote {len(stream)} bytes in {dt:.2f}s "
                 f"({n * w * h / dt / 1e6:.1f} MPixels/s)")
        if args.stats:
            print(json.dumps({
                "input": src, "out": dst, **stats.summary(),
                "frame_bits": [fs.bits for fs in stats.frames],
                "types": "".join("P" if fs.i_frame else "I" for fs in stats.frames),
                "kernel_launches": dict(_build.LAUNCHES),
                **{k: profiling.COUNTS.get(k, 0) for k in STATS_COUNTERS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
