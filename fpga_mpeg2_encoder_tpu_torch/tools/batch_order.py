#!/usr/bin/env python3
"""Time a batch of 1920x1152 streams in the two orders of its frame loop,
on a CUDA card.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/batch_order.py [--streams 8] [--frames 12]

"streams" is parallel/dp.py's encode_gops_batched: each stream through
models/encoder.encode_gop_scan_core, one after another.  "frames" is the
JAX package's order (a scan over frames of a vmap over streams): for each
frame, each stream's step, appended by the merge kernel into its stream's
row of one (B, N) buffer.  "single" is stream 0 alone through
encode_gop_scan_core, the same number of stream-frames in a row.  The
orders alternate (ABBA), each rep on other frames (bench.py's content
rolled), and each must give the same words and bits as the other.  Prints
the host wall time per stream-frame of each rep and the median of each
order, with the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench import make_frames  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch import EncoderConfig  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import pack as k_pack  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.parallel.dp import encode_gops_batched  # noqa: E402

W, H = 1920, 1152
CAPS = dict(row_cap=4096, frame_cap=262144)


def frames_first(fy, fu, fv, zy, zc, nf, kw, seq_cap):
    """The frames-then-streams loop -> (seq_words (B, N), seq_bits (B,))."""
    nb = fy.shape[0]
    seq_w = torch.zeros((nb, seq_cap + CAPS["frame_cap"] + 1), dtype=torch.int64,
                        device=fy.device)
    seq_b = [torch.zeros((), dtype=torch.int64, device=fy.device) for _ in range(nb)]
    prev = [(zy[b], zc[b], zc[b]) for b in range(nb)]
    i_f = [0] * nb
    for k in range(nf):
        for b in range(nb):
            ry, ru, rv, slots = M.symbolize_frame_core(fy[b, k], fu[b, k], fv[b, k], *prev[b],
                                                       i_f[b], k, **kw)
            words, bits, _ = k_pack.pack_slots(slots, CAPS["row_cap"])
            _, seq_b[b], _, _ = k_pack.merge_append(seq_w[b], seq_b[b], words, bits,
                                                    CAPS["frame_cap"])
            prev[b] = (ry, ru, rv)
            i_f[b] = 0 if i_f[b] >= 23 else i_f[b] + 1
    return seq_w, torch.stack(seq_b)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--frames", type=int, default=12)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("batch_order: no CUDA device")
    ns, nf = args.streams, args.frames
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)
    kw = dict(yr=cfg.yr, ur=cfg.ur, q_level=cfg.q_level)
    seq_cap = CAPS["frame_cap"] * max(1, nf // 4)
    dev = torch.device("cuda")
    pool = make_frames(W, H, nf + ns + 8)
    zy = torch.zeros((ns, H, W), dtype=torch.uint8, device=dev)
    zc = torch.zeros((ns, H // 2, W // 2), dtype=torch.uint8, device=dev)

    def stacks(rep):
        return [torch.as_tensor(np.stack([np.stack([pool[(rep + b + k) % len(pool)][i]
                                                    for k in range(nf)]) for b in range(ns)]),
                                device=dev) for i in range(3)]

    def run(order, fy, fu, fv):
        if order == "streams":
            out = encode_gops_batched(fy, fu, fv, zy, zc, zc, [0] * ns, [0] * ns, 23,
                                      **kw, **CAPS, seq_cap=seq_cap)
            return out[3], out[4]
        if order == "frames":
            return frames_first(fy, fu, fv, zy, zc, nf, kw, seq_cap)
        sw, sb = [], []
        for b in range(ns):     # stream 0's frames, ns times over
            out = M.encode_gop_scan_core(fy[0], fu[0], fv[0], zy[0], zc[0], zc[0], 0, 0, 23,
                                         **kw, **CAPS, seq_cap=seq_cap)
            sw.append(out[3])
            sb.append(out[4])
        return torch.stack(sw), torch.stack(sb)

    times = {"streams": [], "frames": [], "single": []}
    plan = ["streams", "frames", "single", "single", "frames", "streams"] * 2
    for rep, order in enumerate(["streams", "frames", "single"] + plan):
        fy, fu, fv = stacks(rep)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw, sb = run(order, fy, fu, fv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if order != "single":
            other = run("frames" if order == "streams" else "streams", fy, fu, fv)
            nw = (int(sb.max()) + 31) // 32
            if not (torch.equal(sb, other[1]) and torch.equal(sw[:, :nw], other[0][:, :nw])):
                raise AssertionError(f"rep {rep}: the two orders' payloads differ")
        if rep >= 3:            # the first three reps warm up
            times[order].append(dt * 1e3 / (ns * nf))
        print(f"rep {rep} {order}: {dt * 1e3 / (ns * nf):.3f} ms a stream-frame", flush=True)
    print(json.dumps({"card": smi, "streams": ns, "frames": nf,
                      "ms_per_stream_frame": times,
                      "median": {k: statistics.median(v) for k, v in times.items()}}))


if __name__ == "__main__":
    main()
