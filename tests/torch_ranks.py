"""Multi-rank cases of the port's scale-out paths, run over gloo on the CPU.

The test files (tests/test_torch_parallel.py, tests/test_torch_spatial.py)
start ``world`` processes with ``run_ranks``; each rank joins a process
group through a ``file://`` store under the test's temporary directory (no
TCP port, so test workers can run side by side), runs the named cases with
one torch thread and saves what it computed under that directory.  The test
process then holds the saved arrays against the single-device and the JAX
computations.  This module imports neither jax nor the JAX package, so the
spawned ranks do not either.
"""
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fpga_mpeg2_encoder_tpu_torch import EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.parallel.dp import BatchEncoder
from fpga_mpeg2_encoder_tpu_torch.parallel.halo import exchange_halo, sharded_row_sad
from fpga_mpeg2_encoder_tpu_torch.parallel.mesh import local_range, make_mesh, make_mesh2d
from fpga_mpeg2_encoder_tpu_torch.parallel.spatial import (
    make_sharded_batch_encoder,
    make_sharded_frame_encoder,
)

KW = dict(yr=6, ur=3, q_level=2)


def video(seed, w, h, n, kind="pan"):
    """Panning gradient + texture (real motion), a still picture, or noise
    (escape-heavy)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return [tuple(rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3))
                for _ in range(n)]
    pad = 48
    yy, xx = np.mgrid[0:h + pad, 0:w + pad]
    tex = rng.integers(0, 64, (h + pad, w + pad))
    base = [((xx * 3 + yy * 2) // 4 % 200 + tex) % 256,
            ((xx - yy) // 3 % 160 + 48 + tex // 2) % 256,
            ((xx + yy) // 5 % 120 + 64 + tex // 3) % 256]
    step = 0 if kind == "still" else 1
    return [tuple(b[2 * i * step % pad:2 * i * step % pad + h,
                    3 * i * step % pad:3 * i * step % pad + w].astype(np.uint8)
                  for b in base) for i in range(n)]


def sad_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h, w), dtype=np.uint8))


def batch_videos(w, h, n):
    """The four streams of the 2-D case: each its own content."""
    return [video(10 + b, w, h, n, kind) for b, kind in
            enumerate(("pan", "noise", "pan", "still"))]


def batch_i_frames(fi):
    """Per-stream GOP positions of frame ``fi`` of the 2-D case: the phases
    differ, so the streams' header rows differ in one batch."""
    return [fi, fi, (fi + 1) % 2, fi]


# ---- the cases: (world, rank, out_dir) -> files under out_dir ---------------

def _save(out, name, **arrays):
    np.savez(os.path.join(out, name + ".npz"), **arrays)


def case_row_sad(world, rank, out):
    mesh = make_mesh(world, axis="slice", device="cpu")
    cur, prev = sad_inputs(16 * 8, 64, 5)
    vol = sharded_row_sad(torch.from_numpy(cur), torch.from_numpy(prev), mesh, yr=6)
    rows = local_range(cur.shape[0] // 16, mesh, "slice")
    mine = torch.from_numpy(prev[16 * rows.start:16 * rows.stop].copy())
    halo = exchange_halo(mine, 8, mesh.get_group("slice"))
    _save(out, f"row_sad_r{rank}", vol=vol.numpy(), halo=halo.numpy(),
          rows=np.array([rows.start, rows.stop]))


FRAME_SHAPES = ((128, 128, "pan"), (96, 256, "noise"), (416, 64, "pan"))


def frame_scalar(fi):
    """Frame fi's GOP position and frame number as the sharded cases pass
    them: host ints on even frames, 0-d int32 tensors on odd ones."""
    return (fi, fi) if fi % 2 == 0 else (torch.tensor(fi, dtype=torch.int32),) * 2


def case_frames(world, rank, out):
    """4 frames IPPP of each shape through the slice-sharded frame program,
    each frame's recon fed back as the next frame's prev: this rank's recon
    rows and the frame payload."""
    mesh = make_mesh(world, axis="slice", device="cpu")
    for w, h, kind in FRAME_SHAPES:
        enc = make_sharded_frame_encoder(mesh, h, w, **KW)
        rows = local_range(h // 16, mesh, "slice")
        ly = slice(16 * rows.start, 16 * rows.stop)
        prev = (torch.zeros((16 * len(rows), w), dtype=torch.uint8),
                torch.zeros((8 * len(rows), w // 2), dtype=torch.uint8),
                torch.zeros((8 * len(rows), w // 2), dtype=torch.uint8))
        res = {}
        for fi, (y, u, v) in enumerate(video(w + h, w, h, 4, kind)):
            planes = (torch.from_numpy(y[ly].copy()), torch.from_numpy(u[ly].copy()),
                      torch.from_numpy(v[ly].copy()))
            ry, ru, rv, fw, fb, ovf = enc(*planes, *prev, *frame_scalar(fi))
            nw = (int(fb) + 31) // 32
            # the program's outputs are rewritten by its next call
            res.update({f"y{fi}": ry.numpy().copy(), f"u{fi}": ru.numpy().copy(),
                        f"v{fi}": rv.numpy().copy(), f"words{fi}": fw[:nw].numpy().copy(),
                        f"bits{fi}": np.int64(fb), f"ovf{fi}": np.bool_(ovf)})
            prev = (ry, ru, rv)
        _save(out, f"frames_{w}x{h}_r{rank}", rows=np.array([rows.start, rows.stop]), **res)


BATCH_COLLECTIVES = ("exchange_halo", "batch_isend_irecv", "all_gather_into_tensor",
                     "all_gather", "all_reduce")


def case_batch2d(world, rank, out):
    """3 frames of 4 streams through the 2 x (world/2) stream x slice
    program (2 x 1 on two ranks: the streams split, each frame whole), the
    GOP positions and frame numbers as (B_l,) int32 tensors, the recon fed
    back; the collectives it issues are counted."""
    import fpga_mpeg2_encoder_tpu_torch.parallel.spatial as S

    b, h, w = 4, 64, 96
    mesh = make_mesh2d(2, world // 2, device="cpu")
    enc = make_sharded_batch_encoder(mesh, b, h, w, **KW)
    streams = local_range(b, mesh, "stream")
    rows = local_range(h // 16, mesh, "slice")
    ly = slice(16 * rows.start, 16 * rows.stop)
    vids = batch_videos(w, h, 3)
    n = len(streams)
    prev = (torch.zeros((n, 16 * len(rows), w), dtype=torch.uint8),
            torch.zeros((n, 8 * len(rows), w // 2), dtype=torch.uint8),
            torch.zeros((n, 8 * len(rows), w // 2), dtype=torch.uint8))
    calls = dict.fromkeys(BATCH_COLLECTIVES, 0)

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return fn, wrapper

    patched = [(S, "exchange_halo")] + [(dist, k) for k in BATCH_COLLECTIVES[1:]]
    saved = []
    for mod, name in patched:
        fn, wrapper = counted(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, wrapper)
    res = {}
    try:
        for fi in range(3):
            planes = [torch.from_numpy(np.stack([vids[s][fi][i][ly] for s in streams]))
                      for i in range(3)]
            i_f = torch.tensor([batch_i_frames(fi)[s] for s in streams], dtype=torch.int32)
            ry, ru, rv, fw, fb, ovf = enc(*planes, *prev, i_f,
                                          torch.full((n,), fi, dtype=torch.int32))
            # the program's outputs are rewritten by its next call
            res.update({f"y{fi}": ry.numpy().copy(), f"u{fi}": ru.numpy().copy(),
                        f"v{fi}": rv.numpy().copy(), f"words{fi}": fw.numpy().copy(),
                        f"bits{fi}": fb.numpy().copy(), f"ovf{fi}": ovf.numpy().copy()})
            prev = (ry, ru, rv)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    _save(out, f"batch2d_r{rank}", streams=np.array([streams.start, streams.stop]),
          rows=np.array([rows.start, rows.stop]),
          calls=np.array([calls[k] for k in BATCH_COLLECTIVES]), **res)


def case_batch_encoder(world, rank, out):
    """BatchEncoder over a stream mesh: push_frames then a chunk of 3 frames;
    every rank returns all streams."""
    cfg, seq = EncoderConfig(xl=5, yl=4), SequenceConfig(416, 64, 2)
    vids = [video(20 + b, 416, 64, 4, "pan" if b % 2 else "noise") for b in range(4)]
    be = BatchEncoder(cfg, seq, 4, mesh=make_mesh(world, device="cpu"), device="cpu")
    be.push_frames([v[0] for v in vids])
    be.push_chunks([v[1:] for v in vids])
    streams = be.finish()
    _save(out, f"batch_encoder_r{rank}",
          **{f"s{b}": np.frombuffer(s, np.uint8) for b, s in enumerate(streams)})


CASES = {"row_sad": case_row_sad, "frames": case_frames, "batch2d": case_batch2d,
         "batch_encoder": case_batch_encoder}


def _rank_main(rank, world, init_file, cases, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        for name in cases:
            CASES[name](world, rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world, out, cases, timeout=240.0):
    """Run ``cases`` on ``world`` spawned gloo ranks; results under ``out``.
    Raises if a rank fails or the ranks outlast ``timeout`` seconds."""
    out = str(out)
    ctx = mp.start_processes(_rank_main, args=(world, os.path.join(out, "store"),
                                               list(cases), out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks still running after {timeout} s")
    if any(p.is_alive() for p in ctx.processes):
        raise AssertionError("a rank is still alive after join")


def load(out, name):
    with np.load(os.path.join(str(out), name + ".npz")) as f:
        return dict(f)
