#!/usr/bin/env python3
"""BASELINE.json configurations 2-5 on a CUDA card.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/bench_configs.py [--reps 3] [--batches 2]

* config 2: 352x288 CIF, pframes_count 3, vector_level 1, 384 frames;
* config 3: 720x576 SD, pframes_count 11, vector_level 2, q_level 1 to 4,
  192 frames;
* config 4: 1920x1152, pframes_count 255 (one I, then P), vector_level 3,
  48 frames;
* config 5: 8 streams of 1920x1152 through BatchEncoder's frame loop
  (parallel/dp.encode_gops_batched), pframes_count 23, 12 frames a stream.
q_level 2 where not swept.  The content is bench.py's (make_frames; stream
b of config 5 is rolled by 3b frames).  The JAX tool's method (its
tools/bench_configs.py) as far as CUDA allows: the frames already on the
card; each timed batch queues ``--reps`` encodes back to back, each on other
content (the frame stack rolled along its frames); CUDA events between the
encodes; the best batch's mean counts, and every rep is printed.  No rep may
set the overflow flag.  Before timing, the payload is held to the port's
own encode at another chunking (Encoder.encode, or BatchEncoder.push_chunks
in two chunks), and config 5's streams each to their single-stream
Encoder.encode.  One JSON line a row: MPixels/s, each rep's milliseconds,
the launches of each kernel a frame (ops/kernels/_build.LAUNCHES over the
timed reps) and the card's name and power limit.  The JAX tool's unroll
sweep has no counterpart (the knob is not ported).

``--smoke`` runs the same code at 64x64 and a few frames; ``--device cpu``
runs on the CPU with the host's clock.
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

from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.core.bitstream import (  # noqa: E402
    sequence_end, sequence_start)
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.parallel.dp import BatchEncoder, encode_gops_batched  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.tools import common  # noqa: E402

FPGA_MPIXELS = 268      # the reference FPGA IP's published rate (README.md)

# (label, streams, w, h, frames, pframes_count, vector_level, q_levels, row_cap,
#  frame_cap, seq_cap a stream): caps that no frame or sequence of this content
#  overflows (config 5's streams 4-7 cross the content's pan wrap at frame 22,
#  whose P-frame is large: stream 7 needs 829 678 words)
CONFIGS = (
    ("cif_352x288_p3_vl1", 1, 352, 288, 384, 3, 1, (2,), 2048, 65536, 8388608),
    ("sd_720x576_p11_vl2", 1, 720, 576, 192, 11, 2, (1, 2, 3, 4), 4096, 262144, 8388608),
    ("hd_1920x1152_p255_vl3", 1, 1920, 1152, 48, 255, 3, (2,), 4096, 262144, 8388608),
    ("batch_8x1920x1152_p23_vl3", 8, 1920, 1152, 12, 23, 3, (2,), 4096, 262144, 3145728),
)
SMOKE = (
    ("smoke_single", 1, 64, 64, 6, 3, 1, (1, 2), 256, 4096, 65536),
    ("smoke_batch", 2, 64, 64, 4, 23, 3, (2,), 256, 4096, 32768),
)


def config_for(w, h, vl, q):
    xl = max(4, (w - 1).bit_length() - 4)      # 16 << xl >= w
    yl = max(4, (h - 1).bit_length() - 4)
    return EncoderConfig(xl=xl, yl=yl, vector_level=vl, q_level=q)


def stream_bytes(w, h, words, nbits) -> bytes:
    """A sequence's stream from its payload: the sequence header, the
    payload, the end code and the zero pad, as Encoder.finish makes it."""
    data = sequence_start(w, h) + M.payload_bytes(words, nbits)
    return data + sequence_end(len(data))


def run_config(label, ns, w, h, nf, pframes, vl, q, caps, seq_cap, clips, rolled,
               dev, args, card):
    """One row: ``clips`` are the streams' frames (host), ``rolled`` the
    device stacks (B, F, H, W) of each rep, the first the clips' own."""
    cfg = config_for(w, h, vl, q)
    zy = torch.zeros((ns, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((ns, h // 2, w // 2), dtype=torch.uint8, device=dev)
    kw = dict(yr=cfg.yr, ur=cfg.ur, q_level=q, **caps, seq_cap=seq_cap)

    def run(st):
        """-> (words (B, N), bits (B,), overflow (B,)): one stream through the
        main path's frame loop, several through the batch's."""
        if ns == 1:
            out = M.encode_gop_scan_core(*(t[0] for t in st), zy[0], zc[0], zc[0], 0, 0,
                                         pframes, **kw)
            return out[3][None], out[4][None], out[7][None]
        out = encode_gops_batched(*st, zy, zc, zc, [0] * ns, [0] * ns, pframes, **kw)
        return out[3], out[4], out[7]

    words, bits, ovf = run(rolled[0])         # warm-up, and the payload checks
    if bool(ovf.any()):
        raise AssertionError(f"{label} q{q}: overflow")
    got = [stream_bytes(w, h, words[b], int(bits[b])) for b in range(ns)]
    half = max(1, nf // 2)
    if ns == 1:
        other = [Encoder(cfg, device=dev, **caps).encode(clips[0], w, h, pframes,
                                                         chunk_frames=half)]
    else:
        be = BatchEncoder(cfg, SequenceConfig(w, h, pframes), ns, device=dev, **caps)
        be.push_chunks([c[:half] for c in clips])
        be.push_chunks([c[half:] for c in clips])
        other = be.finish()
        single = [Encoder(cfg, device=dev, **caps).encode(c, w, h, pframes, chunk_frames=nf)
                  for c in clips]
        if single != got:
            raise AssertionError(f"{label} q{q}: a stream != its single-stream encode")
    if other != got:
        raise AssertionError(f"{label} q{q}: payload != the encode at chunks of {half}")

    _build.reset_launches()
    reps_ms, best = [], float("inf")
    for bi in range(args.batches):
        batch = rolled[1 + bi * args.reps:1 + (bi + 1) * args.reps]
        timer = common.RepTimer(dev)
        outs = []
        for st in batch:
            outs.append(run(st)[2])
            timer.mark()
        ms = timer.ms()
        if any(bool(o.any()) for o in outs):
            raise AssertionError(f"{label} q{q}: a timed rep overflowed")
        reps_ms.append(ms)
        best = min(best, sum(ms) / len(ms))
    n_frames = args.batches * args.reps * ns * nf
    mpix = ns * nf * w * h / (best / 1e3) / 1e6
    row = {"metric": label, "q_level": q, "value": mpix, "unit": "MPixels/s",
           "vs_fpga_268": mpix / FPGA_MPIXELS, "ms_per_rep": reps_ms,
           "frames_per_rep": ns * nf,
           "launches_per_frame": {k: v / n_frames for k, v in _build.LAUNCHES.items() if v},
           "payload_bytes": [len(s) for s in got], "device": card}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--smoke", action="store_true", help="tiny geometry, same code")
    p.add_argument("--reps", type=int, default=3, help="encodes queued a timed batch")
    p.add_argument("--batches", type=int, default=2, help="timed batches (best counts)")
    args = p.parse_args(argv)
    dev = M.resolve_device(args.device)
    card = common.card(dev)
    make_frames = common.bench_content().make_frames
    for label, ns, w, h, nf, pframes, vl, qs, row_cap, frame_cap, seq_cap in (
            SMOKE if args.smoke else CONFIGS):
        pool = make_frames(w, h, nf + 3 * (ns - 1))
        clips = [pool[3 * b:3 * b + nf] for b in range(ns)]
        stacks = torch.stack([torch.as_tensor(np.stack([np.stack(f) for f in c]), device=dev)
                              for c in clips])             # (B, F, 3, H, W)
        rolled = [tuple(torch.roll(stacks, r, dims=1)[:, :, i].contiguous()
                        for i in range(3))
                  for r in range(1 + args.reps * args.batches)]
        del stacks
        for q in qs:
            run_config(label, ns, w, h, nf, pframes, vl, q,
                       dict(row_cap=row_cap, frame_cap=frame_cap), seq_cap, clips, rolled,
                       dev, args, card)
        del rolled
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
