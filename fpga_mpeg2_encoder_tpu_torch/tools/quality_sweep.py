#!/usr/bin/env python3
"""Quality and size across q_level and vector_level, on a CUDA card (or
``--device cpu``).

    python3 fpga_mpeg2_encoder_tpu_torch/tools/quality_sweep.py [--rows 2/3,4/1]

The JAX package's sweep (tools/quality_sweep.py, its table in
docs/QUALITY.md): bench.py's content at 320x192, 12 frames, one GOP of 12
(pframes_count 11), encoded by the port's Encoder at q_level 1-4 and
vector_level 1 and 3, decoded by the port's copy of the conformance
decoder (golden/decoder); PSNR-Y against the 4:2:0 source.  The bytes are
the JAX package's, so every row must equal docs/QUALITY.md's.  Prints each
row as Markdown and as one JSON line; writes no file.
"""
import argparse
import json
import os
import sys

if __package__ in (None, ""):      # run as a script from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.golden import decoder as D  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.golden.encoder import subsample_420  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.models.encoder import resolve_device  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.tools import common  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.utils.logging import psnr  # noqa: E402

W, H, NF = 320, 192, 12
ROWS = tuple((q, vl) for q in (1, 2, 3, 4) for vl in (1, 3))


def sweep_row(frames, q, vl, dev) -> dict:
    cfg = EncoderConfig(xl=5, yl=5, vector_level=vl, q_level=q)
    stream = Encoder(cfg, device=dev).encode(frames, W, H, pframes_count=11)
    dec = D.decode_sequence(stream, cfg)
    ps = [psnr(p.y, subsample_420(*f)[0]) for p, f in zip(dec.pictures, frames)]
    if len(ps) != NF:
        raise AssertionError(f"q {q} vl {vl}: decoded {len(ps)} pictures of {NF}")
    return {"q_level": q, "vector_level": vl, "stream_bytes": len(stream),
            "compression": NF * W * H * 3 / len(stream),
            "psnr_y_mean": float(np.mean(ps)), "psnr_y_min": float(np.min(ps))}


def markdown(r: dict) -> str:
    return (f"| {r['q_level']} | {r['vector_level']} | {r['stream_bytes']} | "
            f"{r['compression']:.1f}:1 | {r['psnr_y_mean']:.2f} dB | {r['psnr_y_min']:.2f} dB |")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--rows", default=",".join(f"{q}/{vl}" for q, vl in ROWS),
                   help="q_level/vector_level pairs, comma-separated")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rows = [tuple(int(x) for x in r.split("/")) for r in args.rows.split(",")]
    frames = common.bench_content().make_frames(W, H, NF)
    card = common.card(dev)
    print(f"device: {card}  {W}x{H}, {NF} frames, pframes_count 11")
    print("| q_level | vector_level | stream bytes | compression | PSNR-Y mean | PSNR-Y min |")
    print("|---|---|---|---|---|---|")
    for q, vl in rows:
        r = sweep_row(frames, q, vl, dev)
        print(markdown(r), flush=True)
        print(json.dumps({**r, "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
