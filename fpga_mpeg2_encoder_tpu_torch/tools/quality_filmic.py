#!/usr/bin/env python3
"""The reference-geometry quality row on filmic content, on a CUDA card (or
``--device cpu``).

    python3 fpga_mpeg2_encoder_tpu_torch/tools/quality_filmic.py

The JAX package's tools/quality_filmic.py: 24 frames of
bench.make_filmic_frames at 1440x704, the reference testbench's parameters
(vector_level 3, q_level 2, one GOP of 24: pframes_count 23), one frame at
a time through models/encoder.encode_frame_core with the frames on the
device.  PSNR-Y against the 4:2:0 source from the encoder's recon planes,
then the stream through the port's copy of the ISO validator
(golden/validator: syntax and a decode by the spec's formulas, sharing no
code with the encoder), whose pictures' PSNR-Y is printed too.  The row
must equal docs/QUALITY.md's filmic row (422336 bytes, 40.42 and 40.07 dB).
Prints the row as Markdown and as one JSON line; writes no file.
"""
import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):      # run as a script from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fpga_mpeg2_encoder_tpu_torch import EncoderConfig  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.core.bitstream import (  # noqa: E402
    sequence_end, sequence_start)
from fpga_mpeg2_encoder_tpu_torch.golden.encoder import subsample_420  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.golden.validator import validate_sequence  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.models.encoder import (  # noqa: E402
    bound_caps, encode_frame_core, next_i_frame, payload_bytes, resolve_device)
from fpga_mpeg2_encoder_tpu_torch.tools import common  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.utils.logging import psnr  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    w, h, nf = 1440, 704, 24
    cfg = EncoderConfig(xl=7, yl=6, vector_level=3, q_level=2)
    frames = common.bench_content().make_filmic_frames(w, h, nf)
    srcs = [subsample_420(*f) for f in frames]
    row_cap, frame_cap = bound_caps(w, h)      # caps never change the bytes
    kw = dict(yr=cfg.yr, ur=cfg.ur, q_level=cfg.q_level, row_cap=row_cap,
              frame_cap=frame_cap)
    prev = (torch.zeros((h, w), dtype=torch.uint8, device=dev),
            torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev),
            torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev))
    payloads, ps = [], []
    i_f = 0
    for fi, f in enumerate(frames):
        t0 = time.perf_counter()
        planes = (torch.as_tensor(p, device=dev) for p in f)
        ry, ru, rv, fw, fb, ovf = encode_frame_core(*planes, *prev, i_f, fi, **kw)
        if bool(ovf):
            raise AssertionError(f"frame {fi}: overflow at the analytic bounds")
        nbits = int(fb)
        payloads.append(payload_bytes(fw, nbits))
        prev = (ry, ru, rv)
        ps.append(psnr(ry.cpu().numpy(), srcs[fi][0]))
        i_f = next_i_frame(i_f, 23)
        print(f"frame {fi}: {len(payloads[-1])} B  PSNR-Y {ps[-1]:.2f} dB  "
              f"({time.perf_counter() - t0:.3f} s host wall)", flush=True)

    stream = sequence_start(w, h) + b"".join(payloads)
    stream += sequence_end(len(stream))
    raw = nf * w * h * 3

    vs = validate_sequence(stream, expected_frames=nf)
    vps = [psnr(vp.y, s[0]) for vp, s in zip(vs.pictures, srcs)]
    card = common.card(dev)
    row = {"clip": f"filmic {w}x{h}x{nf}", "stream_bytes": len(stream),
           "compression": raw / len(stream), "psnr_y_mean": float(np.mean(ps)),
           "psnr_y_min": float(np.min(ps)), "validator": "pass",
           "validator_pictures": len(vs.pictures),
           "validator_psnr_y_mean": float(np.mean(vps)), "device": card}
    print(f"validator: {len(vs.pictures)} pictures pass, PSNR-Y of its pictures "
          f"against the source, mean {np.mean(vps):.2f} dB")
    print("| clip | stream bytes | compression | PSNR-Y mean | PSNR-Y min |")
    print("|---|---|---|---|---|")
    print(f"| {row['clip']} | {len(stream)} | {row['compression']:.1f}:1 | "
          f"{row['psnr_y_mean']:.2f} dB | {row['psnr_y_min']:.2f} dB |")
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
