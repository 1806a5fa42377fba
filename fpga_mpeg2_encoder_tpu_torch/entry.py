"""Entry points of the port for a run-once check and a multi-rank dry run.

* ``entry(device)`` -> ``(fn, example_args)``: one frame through the whole
  single-frame pipeline (subsample, motion estimation, transform and
  reconstruction, symbolisation, packing, merge) at 192x128, the example
  tensors on ``device``.  ``fn(*example_args)`` launches each main-path
  kernel once on a card.
* ``dryrun_multichip(n_devices, device)``: the scale-out paths composed on
  tiny shapes, from inside an initialised process group of ``n_devices``
  ranks: the stream-parallel BatchEncoder, the halo exchange's SAD volume,
  the slice-sharded frame encoder against encode_frame_core, and (n >= 4,
  even) the 2-D stream x slice encoder.  Any disagreement raises.
* ``dryrun_ranks(n_devices, device)`` spawns those ranks (NCCL on cards,
  gloo on the CPU; a file store, one torch thread a rank) and runs the dry
  run on each.  NCCL refuses two ranks on one card, so on a single card run
  one rank.

The JAX package's Mosaic demotion ladder has no counterpart: a kernel that
fails raises.
"""
from __future__ import annotations

import functools
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import EncoderConfig, SequenceConfig
from .models.encoder import (
    DEFAULT_FRAME_CAP,
    DEFAULT_ROW_CAP,
    encode_frame_core,
    resolve_device,
)

KW = dict(yr=6, ur=3, q_level=2)


def entry(device="cuda"):
    """(fn, example_args): encode_frame_core at 192x128, yr 6, ur 3, q 2
    and the default caps, on a P-frame step (i_frame 1, frame 1) of random
    planes (seed 0) against a zero reference."""
    dev = resolve_device(device)
    h, w = 128, 192
    fn = functools.partial(encode_frame_core, **KW, row_cap=DEFAULT_ROW_CAP,
                           frame_cap=DEFAULT_FRAME_CAP)
    rng = np.random.default_rng(0)
    y, u, v = (torch.as_tensor(rng.integers(0, 256, (h, w), dtype=np.uint8), device=dev)
               for _ in range(3))
    py = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    pc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    return fn, (y, u, v, py, pc, pc, 1, 1)


def _planes(rng, shape, dev):
    return tuple(torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=dev)
                 for _ in range(3))


def _check_equal(tag, got, want):
    """got, want: (fwords, fbits, overflow) of one frame."""
    if bool(got[2]) or bool(want[2]):
        raise AssertionError(f"{tag}: overflow")
    nw = (int(want[1]) + 31) // 32
    if int(got[1]) != int(want[1]):
        raise AssertionError(f"{tag}: payload length {int(got[1])} != {int(want[1])} bits")
    if not torch.equal(got[0][:nw], want[0][:nw]):
        raise AssertionError(f"{tag}: payload words differ from encode_frame_core's")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The scale-out paths on an ``n_devices``-rank process group (which the
    caller initialised), each checked on this rank; raises on any
    difference.  Every rank draws the same content (seed 0), as the JAX
    package's single controller does, and takes its own part of it."""
    from .parallel.dp import BatchEncoder
    from .parallel.halo import sharded_row_sad
    from .parallel.mesh import local_range, make_mesh, make_mesh2d
    from .parallel.spatial import make_sharded_batch_encoder, make_sharded_frame_encoder

    resolve_device(device)
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs inside an initialised "
                           f"process group of {n_devices} ranks")
    mesh = make_mesh(n_devices, device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.device(device).type == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(0)

    # 1. stream data parallelism: one stream a rank, an I then a P step
    h, w = 64, 64
    cfg = EncoderConfig(xl=4, yl=4, vector_level=3, q_level=2)
    be = BatchEncoder(cfg, SequenceConfig(w, h, pframes_count=2), n_devices, mesh=mesh,
                      device=dev)
    frames = [tuple(rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3))
              for _ in range(n_devices)]
    be.push_frames(frames)
    be.push_frames(frames)
    streams = be.finish()
    if len(streams) != n_devices or not all(
            s[:4] == b"\x00\x00\x01\xb3" and len(s) % 32 == 0 for s in streams):
        raise AssertionError("BatchEncoder over the stream mesh: streams malformed")

    # 2. slice-row sharded SAD volume with the halo exchange
    smesh = make_mesh(n_devices, axis="slice", device=device)
    nrows = 16 * n_devices
    cur = torch.as_tensor(rng.integers(0, 256, (nrows, 64), dtype=np.uint8), device=dev)
    prev = torch.as_tensor(rng.integers(0, 256, (nrows, 64), dtype=np.uint8), device=dev)
    sad = sharded_row_sad(cur, prev, smesh, yr=6)
    if tuple(sad.shape) != (169, n_devices, 4):
        raise AssertionError(f"sharded_row_sad: shape {tuple(sad.shape)}")

    # 3. the slice-sharded frame pipeline against the single-device step, I then P
    sh, sw = 16 * n_devices, 64
    senc = make_sharded_frame_encoder(smesh, sh, sw, **KW)
    rows = local_range(sh // 16, smesh, "slice")
    ly, lc = slice(16 * rows.start, 16 * rows.stop), slice(8 * rows.start, 8 * rows.stop)
    prev_r = (torch.zeros((sh, sw), dtype=torch.uint8, device=dev),
              torch.zeros((sh // 2, sw // 2), dtype=torch.uint8, device=dev),
              torch.zeros((sh // 2, sw // 2), dtype=torch.uint8, device=dev))
    prev_s = (prev_r[0][ly], prev_r[1][lc], prev_r[2][lc])
    for fi in range(2):
        y, u, v = _planes(rng, (sh, sw), dev)
        # the GOP state as device scalars, as the JAX entry passes it
        fi_t = torch.full((), fi, dtype=torch.int32, device=dev)
        out_s = senc(y[ly], u[ly], v[ly], *prev_s, fi_t, fi_t)
        out_r = encode_frame_core(y, u, v, *prev_r, fi, fi, **KW,
                                  row_cap=DEFAULT_ROW_CAP, frame_cap=DEFAULT_FRAME_CAP)
        _check_equal(f"sharded frame {fi}", out_s[3:], out_r[3:])
        prev_s, prev_r = out_s[:3], out_r[:3]

    # 4. the 2-D stream x slice composition, the streams in opposite GOP phases
    if n_devices >= 4 and n_devices % 2 == 0:
        n_sl = n_devices // 2
        mesh2 = make_mesh2d(2, n_sl, device=device)
        bh, bw = 16 * n_sl, 64
        benc = make_sharded_batch_encoder(mesh2, 2, bh, bw, **KW)
        mine = local_range(2, mesh2, "stream")
        brows = local_range(bh // 16, mesh2, "slice")
        ly = slice(16 * brows.start, 16 * brows.stop)
        lc = slice(8 * brows.start, 8 * brows.stop)
        ref = [(torch.zeros((bh, bw), dtype=torch.uint8, device=dev),
                torch.zeros((bh // 2, bw // 2), dtype=torch.uint8, device=dev),
                torch.zeros((bh // 2, bw // 2), dtype=torch.uint8, device=dev))
               for _ in range(2)]
        pb = tuple(torch.stack([ref[b][i][sl] for b in mine])
                   for i, sl in enumerate((ly, lc, lc)))
        for fi in range(2):
            planes = [_planes(rng, (bh, bw), dev) for _ in range(2)]
            i_f = [fi, 1 - fi]
            ob = benc(*(torch.stack([planes[b][i][ly] for b in mine]) for i in range(3)),
                      *pb, torch.tensor([i_f[b] for b in mine], dtype=torch.int32, device=dev),
                      torch.full((len(mine),), fi, dtype=torch.int32, device=dev))
            for j, b in enumerate(mine):
                out_r = encode_frame_core(*planes[b], *ref[b], i_f[b], fi, **KW,
                                          row_cap=DEFAULT_ROW_CAP,
                                          frame_cap=DEFAULT_FRAME_CAP)
                _check_equal(f"2-D mesh stream {b} frame {fi}",
                             (ob[3][j], ob[4][j], ob[5][j]), out_r[3:])
                ref[b] = out_r[:3]
            pb = ob[:3]


def _dryrun_rank(rank, world, init_file, device):
    torch.set_num_threads(1)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        dryrun_multichip(world, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_ranks(n_devices: int, device="cuda", timeout: float = 600.0) -> None:
    """dryrun_multichip on ``n_devices`` spawned ranks; raises if a rank
    fails or they outlast ``timeout`` seconds."""
    import torch.multiprocessing as mp

    resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_dryrun_rank,
                                 args=(n_devices, os.path.join(tmp, "store"), device),
                                 nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{n_devices} ranks still running after {timeout} s")

