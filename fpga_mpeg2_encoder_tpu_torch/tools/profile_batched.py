#!/usr/bin/env python3
"""Device time of each stage per stream-frame, one stream against a batch,
on a CUDA card.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/profile_batched.py [--streams 8] [--reps 4]

The JAX package batches streams with vmap, and its tools/profile_batched.py
looks for the stage that pays a tax for it.  The port's stages launch once a
stream and frame, so each stream-frame should cost what a frame costs
alone; its batch program (parallel/dp.py) runs the streams' steps as
concurrent branches of one graph, so its frame loop may cost less a
stream-frame than one stream's (the stages' device times are summed per
kernel, overlapping or not).  This tool records both.  It runs
profile_stages.py's stages (the same split, each under torch.profiler) on
1 stream and on ``--streams`` streams, ``--reps`` frames of each stream
(other content for every stream and rep), and prints each stage's device
time and kernels per stream-frame at both, with their ratio.  Then the
batch's frame loop itself: parallel/dp.encode_gops_batched over
``--frames`` frames of each stream (the frames on the device), per
stream-frame, against one stream through the same loop.  One JSON line a row.

``--device cpu`` runs the same on the CPU, with the host's time only.
"""
import argparse
import json
import os
import sys

if __package__ in (None, ""):      # run as a script from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fpga_mpeg2_encoder_tpu_torch import EncoderConfig  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.models.encoder import chunk_caps, resolve_device  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.parallel.dp import encode_gops_batched  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.tools import common  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.tools.profile_stages import (  # noqa: E402
    CAPS, STAGES, WHOLE, parse_size, profile, stage_calls)


def loop_calls(dev, w, h, streams, nf, reps, cfg):
    """``reps`` calls of the batch's frame loop over ``streams`` streams of
    ``nf`` frames (each call on other frames), as BatchEncoder.push_chunks
    runs it at its first caps (``chunk_caps``)."""
    pool = common.bench_content().make_frames(w, h, nf + streams + reps)
    zy = torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8, device=dev)
    kw = dict(yr=cfg.yr, ur=cfg.ur, q_level=cfg.q_level,
              **chunk_caps(CAPS["row_cap"], CAPS["frame_cap"], w, h, nf)[0])
    calls = []
    for r in range(reps):
        stacks = [torch.as_tensor(np.stack([np.stack([pool[r + b + k][i] for k in range(nf)])
                                            for b in range(streams)]), device=dev)
                  for i in range(3)]

        def run(s=stacks):
            out = encode_gops_batched(*s, zy, zc, zc, [0] * streams, [0] * streams, 23, **kw)
            if bool(out[7].any()):
                raise AssertionError("the frame loop overflowed its caps")
            return out
        calls.append(run)
    return calls


def per_stream_frame(row: dict, n: int) -> dict:
    """A profile of calls of n stream-frames each, per stream-frame."""
    out = {}
    for k, v in row.items():
        if isinstance(v, float):
            out[k] = v / n
        elif isinstance(v, dict):
            out[k] = {name: c / n for name, c in v.items()}
        elif k != "top":
            out[k] = v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--size", default="1920x1152")
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--frames", type=int, default=6)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = parse_size(args.size)
    card = common.card(dev)
    cfg = EncoderConfig(xl=7, yl=7)
    per = {}
    for b in sorted({1, args.streams}):
        calls = stage_calls(dev, w, h, streams=b, reps=args.reps, cfg=cfg)
        per[b] = {s: profile(dev, calls[s]) for s in STAGES + (WHOLE,)}
        del calls
        lc = loop_calls(dev, w, h, b, args.frames, 2, cfg)
        per[b]["frame loop"] = per_stream_frame(profile(dev, lc), b * args.frames)
        del lc
    one, many = per[1], per[args.streams]
    for stage in STAGES + (WHOLE, "frame loop"):
        a, b = one[stage], many[stage]
        key = "device_ms" if dev.type == "cuda" else "host_ms"
        print(json.dumps({"stage": stage, "size": f"{w}x{h}", "streams": args.streams,
                          "b1": a, f"b{args.streams}": b,
                          f"{key}_ratio": b[key] / a[key], "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
