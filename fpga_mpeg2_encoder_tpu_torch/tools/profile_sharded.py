#!/usr/bin/env python3
"""Time per frame of the single-device frame step against the slice-sharded
one, on CUDA cards.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/profile_sharded.py [--frames 12]

Rows, one JSON line each:
* models/encoder.encode_frame_core, the eager single-device step;
* models/encoder.encode_frame_device, its compiled program (a CUDA graph);
* parallel/spatial.make_sharded_frame_encoder_core (the eager factory) on a
  one-rank ``slice`` mesh (NCCL, world size 1, in this process): the halo
  exchange posts nothing and the gather and the overflow all-reduce run
  over one rank, so its difference from the first row is what the
  sharding's machinery costs eagerly;
* parallel/spatial.make_sharded_frame_encoder (the local and tail graphs
  with the collectives between them) on the same mesh, beside the second
  row;
* the program over min(4, cards) ranks, one process a card, where there
  are two cards or more; with one card a line says it was not run (NCCL
  refuses two ranks on one card).
Each frame is another frame of bench.py's content, chained IPPP (each step
takes the previous step's recon), with the GOP position and frame number as
0-d int32 tensors on the device; the first frame warms up and is not
timed.  Times come from CUDA events between frames; each frame's outputs
are cloned before the next (a program rewrites its own) and each payload
must equal encode_frame_core's.  ``--device cpu`` runs the same over gloo on
the CPU, timed on the host's clock.
"""
import argparse
import json
import os
import sys
import tempfile

if __package__ in (None, ""):      # run as a script from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from fpga_mpeg2_encoder_tpu_torch.models.encoder import (  # noqa: E402
    encode_frame_core, encode_frame_device, resolve_device)
from fpga_mpeg2_encoder_tpu_torch.parallel.mesh import local_range, make_mesh  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.parallel.spatial import (  # noqa: E402
    make_sharded_frame_encoder, make_sharded_frame_encoder_core)
from fpga_mpeg2_encoder_tpu_torch.tools import common  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.tools.profile_stages import parse_size  # noqa: E402

KW = dict(yr=6, ur=3, q_level=2)
CAPS = dict(row_cap=4096, frame_cap=262144)


def run_frames(step, frames, dev, rows=None):
    """Each frame through ``step`` (rows ``rows`` of macroblock rows, or the
    whole frame), IPPP -> (ms of each frame after the first, [(bits, words)
    of each frame])."""
    h, w = frames[0][0].shape
    sl = slice(None) if rows is None else slice(16 * rows.start, 16 * rows.stop)
    hl = h if rows is None else 16 * len(rows)
    prev = (torch.zeros((hl, w), dtype=torch.uint8, device=dev),
            torch.zeros((hl // 2, w // 2), dtype=torch.uint8, device=dev),
            torch.zeros((hl // 2, w // 2), dtype=torch.uint8, device=dev))
    planes = [tuple(torch.as_tensor(np.ascontiguousarray(p[sl]), device=dev) for p in f)
              for f in frames]
    gop = [torch.full((), fi, dtype=torch.int32, device=dev) for fi in range(len(frames))]
    outs = []
    timer = None
    for fi, f in enumerate(planes):
        out = step(*f, *prev, gop[fi], gop[fi])
        prev = out[:3]
        outs.append(tuple(t.clone() for t in out[3:]))
        if fi == 0:
            common.sync(dev)
            timer = common.RepTimer(dev)
        else:
            timer.mark()
    ms = timer.ms()
    payloads = []
    for fw, fb, ovf in outs:
        if bool(ovf):
            raise AssertionError("a frame overflowed the caps")
        payloads.append((int(fb), fw[:(int(fb) + 31) // 32].cpu().numpy()))
    return ms, payloads


def sharded(dev, device, frames, world, factory=make_sharded_frame_encoder):
    mesh = make_mesh(world, axis="slice", device=device)
    h, w = frames[0][0].shape
    enc = factory(mesh, h, w, **KW, **CAPS)
    return run_frames(enc, frames, dev, local_range(h // 16, mesh, "slice"))


def _rank(rank, world, init, out, w, h, nf):
    torch.set_num_threads(1)
    dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank)
    try:
        frames = common.bench_content().make_frames(w, h, nf)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        ms, payloads = sharded(dev, "cuda", frames, world)
        if rank == 0:
            np.savez(os.path.join(out, "rank0.npz"), ms=np.array(ms),
                     bits=np.array([b for b, _ in payloads]),
                     **{f"words{k}": wd for k, (_, wd) in enumerate(payloads)})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def row(metric, ms, w, h, card):
    mean = float(np.mean(ms))
    return {"metric": metric, "ms_per_frame": mean, "ms_min": float(np.min(ms)),
            "ms_each": [float(m) for m in ms], "value": w * h / mean / 1e3,
            "unit": "MPixels/s", "device": card}


def check_equal(tag, got, want):
    for fi, ((gb, gw), (wb, ww)) in enumerate(zip(got, want)):
        if gb != wb or not np.array_equal(gw, ww):
            raise AssertionError(f"{tag}: frame {fi} payload != encode_frame_core's")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--size", default="1920x1152")
    p.add_argument("--frames", type=int, default=12)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = parse_size(args.size)
    card = common.card(dev)
    frames = common.bench_content().make_frames(w, h, args.frames)

    ms_plain, want = run_frames(
        lambda *a: encode_frame_core(*a, **KW, **CAPS), frames, dev)
    plain = row(f"frame_step_plain_{w}x{h}", ms_plain, w, h, card)
    print(json.dumps(plain), flush=True)
    ms_dev, got = run_frames(lambda *a: encode_frame_device(*a, **KW, **CAPS), frames, dev)
    check_equal("encode_frame_device", got, want)
    device = row(f"frame_step_device_{w}x{h}", ms_dev, w, h, card)
    print(json.dumps(device), flush=True)

    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            ms_core, got_core = sharded(dev, args.device, frames, 1,
                                        make_sharded_frame_encoder_core)
            ms1, got = sharded(dev, args.device, frames, 1)
        finally:
            dist.destroy_process_group()
    check_equal("one-rank eager shard", got_core, want)
    check_equal("one-rank shard program", got, want)
    core = row(f"frame_step_sharded1_eager_{w}x{h}", ms_core, w, h, card)
    one = row(f"frame_step_sharded1_{w}x{h}", ms1, w, h, card)
    print(json.dumps(core), flush=True)
    print(json.dumps(one), flush=True)
    for metric, mine, base in (("sharded_overhead_1rank_eager_pct", core, plain),
                               ("sharded_overhead_1rank_pct", one, device)):
        print(json.dumps({"metric": metric,
                          "value": 100 * (mine["ms_per_frame"] / base["ms_per_frame"] - 1),
                          "unit": "%", "device": card}), flush=True)

    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards < 2:
        print(json.dumps({"metric": f"frame_step_sharded_multicard_{w}x{h}",
                          "value": None, "note": f"not run: it needs two cards, "
                          f"this machine has {cards}", "device": card}), flush=True)
        return 0
    world = min(4, cards)
    while (h // 16) % world:
        world -= 1
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(world, f"file://{tmp}/store", tmp, w, h,
                                        args.frames),
                           nprocs=world, join=True, start_method="spawn")
        with np.load(os.path.join(tmp, "rank0.npz")) as f:
            res = dict(f)
    check_equal(f"{world}-rank shards", [(int(b), res[f"words{k}"])
                                         for k, b in enumerate(res["bits"])], want)
    print(json.dumps(row(f"frame_step_sharded{world}_{w}x{h}", list(res["ms"]), w, h,
                         card)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
