#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):
1. device: card name and power limit; fails without a CUDA device;
2. build: compiles the kernels of fpga_mpeg2_encoder_tpu_torch/csrc and
   prints each kernel's registers and spills, and the count of VABSDIFF4
   (the motion search's byte-SIMD instruction) in the SASS of each
   me_fused_kernel (the +-4 and the +-6 window);
3. kernels: each kernel against its plain PyTorch version on the card, at
   1920x1152, 720x576 (chroma 360 wide, 8 mod 16), 416x64 and 64x64 shapes
   of bench.py content, exact equality (an integer codec: the tolerance is
   zero); the subsample kernel through both entries (the stack entry, the
   gop program's, on frame 1 of a (2, 3, H, W) stack, its Y plane copied
   out too); the motion kernels for I and P frames, and the fused one also
   against the luma kernel followed by the chroma kernel; the symbol glue
   for the P-frame with its header rows, the I-frame past the timecode's
   hour clamp, a band of rows from first_row 5 and the header rows alone;
   the pack kernel through the public entry and through the gop program's
   (the header rows and the slice rows as two operands: the same words
   under each row's bits, the same bits); the merge kernel as merge_rows
   and as merge_append (the frame loop's form) at every seq_bits & 31, cut
   at a cap and clamped; the
   gop program's carry kernel at the GOP wrap and with a row or the frame
   over its cap (untimed: a launch's worth of work).  At
   1920x1152 (and the fused motion kernel at 720x576 with the sd cells'
   vector_level 2 as well) both are timed two ways: device time from
   torch.profiler (the kernel alone; all the plain version's kernels), and
   time per call from
   CUDA events around back-to-back calls, which includes the host's cost
   where the host is the slower side;
4. stages: the time of each stage of one 1920x1152 P-frame, the subsample
   and the symbol glue as their kernels and as their plain versions, the
   merge and append both as two stages (merge_rows, then the plain append)
   and as the frame loop runs them (merge+append, one kernel);
5. end to end at 1920x1152, 96 frames, vl=3 q=2, IPPP (pframes_count=23):
   (a) the multi-frame path at bench.py's caps must hash to bench.py's
       PAYLOAD_SHA256, then a timed repeat gives MPixels/s;
   (b) the public Encoder.encode(chunk_frames=48) stream must be 16110848
       bytes with the SHA-256 of the JAX package's 1080p chunked soak;
   each run must launch every main-path kernel at least once per frame, and
   the split motion kernels never (phase 3 holds them against the fused one);
   (a) must run no plain append: the merge kernel appends each frame.
   (a) runs the eager frame loop (encode_gop_scan_core); (b), like every
   Encoder and BatchEncoder run below (phases 7, 9, 10a), replays the
   compiled programs' CUDA graphs, which phase 11 holds against the eager path;
6. profile: 16 frames of 5a's eager loop under torch.profiler: kernels
   launched and device time per frame, the device's idle share, and the
   kernels that take the most time;
7. multi-stream (BASELINE config 5's shape): parallel/dp.py's BatchEncoder,
   8 streams of 1920x1152 (bench.py's frames rolled by 3 a stream), vl=3
   q=2, pframes_count=23, 24 frames each in one push_chunks; each stream
   must equal the card's Encoder.encode of its frames, and each main-path
   kernel must be launched at least 8 times a frame; prints the batch's
   aggregate MPixels/s through push_chunks (upload included) and of its
   frame loop alone with the frames on the card, with the loop's kernels
   and device time a stream-frame and the device's idle share
   (informational);
8. slice shards on one card, in one process: parallel/spatial.py's
   local_step for 4 shards of 1920x1152 (18 macroblock rows each), halos
   cut from the whole recon, then the frame tail (header rows packed, rows
   merged), 8 frames IPPP; payload bits, words and recon must equal
   encode_frame_core's on every frame, with the motion kernel launched in
   its band form at first_mb_row 18, 36 and 54.  With two cards or more the
   same frames also go through make_sharded_frame_encoder over NCCL on
   min(4, cards) ranks; with one card a line says that part was not run;
9. command line: a 416x64 and a 1920x1152 clip (4 frames each) through
   `python -m fpga_mpeg2_encoder_tpu_torch.cli.encode --device cuda` in a
   subprocess (bytes equal to Encoder.encode at the default caps in this
   process; each main-path kernel launched there exactly once a frame: the
   CLI's caps are the analytic bounds, so no frame is encoded twice), then `cli.decode --validate --ref` (its main, in this
   process) on the 416x64 stream: the validator passes, PSNR-Y printed;
10. the card against the golden model, and the package's entry points:
   (a) Encoder(device="cuda") streams of utils/testdata.GOLDEN_MATRIX
       (vector levels 1 and 2, q_level 1, 3 and 4, the partial stop, GOP
       wrap, 64 and 416 px wide, 3-7 frames, streaming and chunked) must
       equal golden/encoder.encode_sequence (NumPy, sharing only core/
       with the encoder), each main-path kernel launched at least once a
       frame; (b) entry.entry()'s fn on its example tensors launches each
       main-path kernel exactly once, and its payload and recon equal the
       same call on the CPU; (c) entry.dryrun_multichip(1) in a one-rank
       NCCL group completes;
11. the compiled programs (models/encoder.encode_gop_scan and
   encode_frame_device: a captured CUDA graph of one frame's step, replayed
   frame after frame with the GOP state on the card), against the eager
   path of 5a, 5b, 7 and 10a: (a) encode_gop_scan over 5a's 96 frames at
   bench caps: words equal to 5a's (so PAYLOAD_SHA256), each main-path
   kernel and the carry kernel counted exactly once a frame under replay and
   the split motion kernels never, timed as 5a is (CUDA events, best of 3); (b) 16 frames
   of it profiled as in phase 6: kernels, device ms, wall ms a frame and
   the idle share, beside phase 6's; (c) Encoder.encode(chunk_frames=48)
   gives the soak digest with each kernel exactly once a frame; (d) every
   GOLDEN_MATRIX case streaming (encode_frame_device) and chunked
   (encode_gop_scan) equals the golden copy; (e) phase 7's 8 x 1080p
   BatchEncoder streams equal each stream's eager encode_gop_scan_core; (f)
   16 frames streamed one at a time with each payload downloaded (push_frame's
   pattern, frames on the card), encode_frame_core against
   encode_frame_device in turns, host clock, ms a frame;
12. the sharded programs (parallel/spatial.py: a rank's local steps one
   captured graph, its frame tails another, the halo exchange, the row
   gather and the overflow all-reduce enqueued between them): (a) phase 8's
   4 shards through make_shards_encoder (4 local graphs, each captured with
   the motion kernel's band form at its first_mb_row, and the tail graph),
   8 frames, payload and recon equal to phase 8's encode_frame_core and the
   kernels counted under replay as phase 8 counts them; (b) a one-rank
   NCCL make_sharded_frame_encoder over 16 frames, each recon fed straight
   back, equal to encode_frame_device frame by frame, the subsample, F, T,
   A and M counted once and the glue and P twice a frame; wall and device ms a frame, kernels a
   frame and the idle share, beside make_sharded_frame_encoder_core (the
   eager factory) in the same run; (c) a one-rank 2-D mesh
   make_sharded_batch_encoder with 4 streams of 1920x1152 in one block,
   each stream equal to its encode_frame_core; (d) with two cards or more,
   sharded_rank through the programs over NCCL (a line says it did not
   run on one card).
Then the seconds each phase took, and, as the last lines, a JSON summary of
the kernels (``launches``: 5b's run, through the graphs), the card and the
device line.
"""
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SOAK_BYTES = 16110848
SOAK_SHA256 = "d0f0b0ec9f2fabb3a581369b8ef410dbf0660881d46c9a0f9cfbd0ad6ddfa1d8"
W, H, NF = 1920, 1152, 96
SD = (720, 576)                # the sd cells' frame, where phase 3 times F too
CAPS = dict(row_cap=4096, frame_cap=262144)
SEQ_CAP = 8388608
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA's data sheet
INT32_LANES_PER_SM = 64        # Hopper SM: 64 INT32 lanes per clock
# byte-SIMD __vsadu4 (SASS VABSDIFF4): four absolute-difference adds.  Its
# rate, measured on an H100 at 700 W (CHANGES.md, the entry on the motion
# kernel's redesign for the H100), is 61.4-62.1 lanes per clock per SM with
# the loop's own instructions issued beside it: the full INT32 rate, so the
# ME's bound uses the INT32 peak.
SAD_PER_OP = 4
WORD_BYTES = 4                 # packed words are 32-bit values, carried as int64 for
                               # the CPU's plain code; the bounds of P, S and M count 4 bytes
MAIN_PATH = ("subsample", "me_fused", "transform", "glue", "acsym", "pack_slots", "merge_rows")
OFF_PATH = ("me_luma", "chroma_pred", "pack_symbols")
REPLACES = {
    "transform": "fpga_mpeg2_encoder_tpu/ops/pallas/transform.py:264",
    "acsym": "fpga_mpeg2_encoder_tpu/ops/pallas/acsym.py:206",
    "pack_slots": "fpga_mpeg2_encoder_tpu/ops/pallas/pack.py:207",
    "merge_rows": "fpga_mpeg2_encoder_tpu/ops/pallas/pack.py:386",
    "me_fused": "fpga_mpeg2_encoder_tpu/ops/pallas/me.py:492",
    "me_luma": "fpga_mpeg2_encoder_tpu/ops/pallas/me.py:401",
    "chroma_pred": "fpga_mpeg2_encoder_tpu/ops/pallas/me.py:626",
    "pack_symbols": "fpga_mpeg2_encoder_tpu/ops/pallas/pack.py:199",
    "glue": "fpga_mpeg2_encoder_tpu/ops/entropy.py:209",
    "subsample": "fpga_mpeg2_encoder_tpu/ops/colorspace.py:55",
}
# the stages that are XLA code inside the JAX package's jitted step, not Pallas
XLA_STAGES = {"glue": "the non-AC part of symbolize_frame and _header_rows (entropy.py:182)",
              "subsample": "subsample_420"}
SOURCES = {k: f"fpga_mpeg2_encoder_tpu_torch/csrc/{f}" for k, f in (
    ("transform", "transform.cu"), ("acsym", "acsym.cu"), ("pack_slots", "pack.cu"),
    ("merge_rows", "pack.cu"), ("me_fused", "me.cu"), ("me_luma", "me.cu"),
    ("chroma_pred", "me.cu"), ("glue", "glue.cu"), ("subsample", "subsample.cu"))}
SOURCES["pack_symbols"] = "fpga_mpeg2_encoder_tpu_torch/ops/kernels/pack.py"
REDESIGNED = {"me_fused": "PR 3", "transform": "PR 3", "acsym": "PR 4", "pack_slots": "PR 4",
              "merge_rows": "PR 5", "chroma_pred": "PR 5"}
TIMED_APPEND = "append s=13"   # the merge kernel's timed check: merge_append, the main path's form
KERNEL_SYMBOLS = {"transform": "transform_kernel", "acsym": "acsym_kernel",
                  "pack_slots": "pack_slots_kernel", "merge_rows": "merge_rows_kernel",
                  "me_fused": "me_fused_kernel", "me_luma": "me_luma_kernel",
                  "chroma_pred": "chroma_pred_kernel", "glue": "glue_kernel",
                  "subsample": "subsample_kernel",
                  "pack_symbols": None}   # all its kernels: the slot forming and pack_slots


def cuda_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_events(fn, reps):
    """The CUDA kernel events of ``reps`` calls of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, match=None, reps=10, tries=3):
    """Device time per call of the CUDA kernels that ``fn`` launches: those
    whose name contains ``match``, or all of them.  From torch.profiler,
    which now and then returns a window without a short kernel's events:
    such a window is profiled again."""
    for _ in range(tries):
        ev = [e for e in profile_events(fn, reps) if match is None or match in e.name]
        if ev:
            return sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3
    raise AssertionError(f"the profiler saw no device time for {match or 'a plain version'}"
                         f" in {tries} windows")


def max_abs_err(a, b):
    import torch
    outs_a = a if isinstance(a, (tuple, list)) else (a,)
    outs_b = b if isinstance(b, (tuple, list)) else (b,)
    if len(outs_a) != len(outs_b):
        raise AssertionError(f"{len(outs_a)} outputs != {len(outs_b)}")
    err = 0
    for x, y in zip(outs_a, outs_b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def sharded_rank(rank, world, init, backend, out, nf, program):
    """One rank of the multi-card parts of phases 8 and 12: over ``backend``
    on ``world`` ranks, nf frames IPPP of bench.py's content through
    make_sharded_frame_encoder_core (phase 8, eager) or, with ``program``,
    make_sharded_frame_encoder (phase 12d, the graphs, the GOP state as
    device scalars); saves this rank's recon rows and each frame's
    payload."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from bench import make_frames
    from fpga_mpeg2_encoder_tpu_torch import EncoderConfig
    from fpga_mpeg2_encoder_tpu_torch.parallel.mesh import local_range, make_mesh
    from fpga_mpeg2_encoder_tpu_torch.parallel.spatial import (
        make_sharded_frame_encoder, make_sharded_frame_encoder_core)

    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    try:
        device = "cuda" if backend == "nccl" else "cpu"
        mesh = make_mesh(world, axis="slice", device=device)
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"
        cfg = EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)    # main()'s
        factory = make_sharded_frame_encoder if program else make_sharded_frame_encoder_core
        enc = factory(mesh, H, W, yr=cfg.yr, ur=cfg.ur, q_level=cfg.q_level, **CAPS)
        rows = local_range(H // 16, mesh, "slice")
        ly = slice(16 * rows.start, 16 * rows.stop)
        prev = (torch.zeros((16 * len(rows), W), dtype=torch.uint8, device=dev),
                torch.zeros((8 * len(rows), W // 2), dtype=torch.uint8, device=dev),
                torch.zeros((8 * len(rows), W // 2), dtype=torch.uint8, device=dev))
        res = {"rows": np.array([rows.start, rows.stop])}
        for fi, f in enumerate(make_frames(W, H, nf)):
            planes = [torch.as_tensor(np.ascontiguousarray(p[ly]), device=dev) for p in f]
            gop = torch.full((), fi, dtype=torch.int32, device=dev) if program else fi
            ry, ru, rv, fw, fb, ovf = enc(*planes, *prev, gop, gop)
            nw = (int(fb) + 31) // 32
            # copies: a program's outputs are rewritten by its next call
            res.update({f"y{fi}": ry.cpu().numpy(), f"u{fi}": ru.cpu().numpy(),
                        f"v{fi}": rv.cpu().numpy(), f"bits{fi}": np.int64(fb),
                        f"words{fi}": fw[:nw].cpu().numpy(), f"ovf{fi}": np.bool_(ovf)})
            prev = (ry, ru, rv)
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_sharded_ranks(world, backend, nf, program=False, timeout=600):
    """The ranks of phase 8 (or, with ``program``, 12d) in spawned processes
    (a file store in a temporary directory) -> each rank's saved arrays."""
    import numpy as np
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out:
        init = "file://" + os.path.join(out, "rendezvous")
        ctx = mp.start_processes(sharded_rank, args=(world, init, backend, out, nf, program),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"{'12d' if program else 'phase 8'}: {world} ranks still "
                                   f"running after {timeout} s")
        res = []
        for r in range(world):
            with np.load(os.path.join(out, f"rank{r}.npz")) as f:
                res.append(dict(f))
        return res


def phase_10(device):
    """Phase 10 on ``device`` ("cuda"; the dry run's group is NCCL there,
    gloo on the CPU) -> its lines."""
    import torch
    import torch.distributed as dist
    from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig
    from fpga_mpeg2_encoder_tpu_torch import entry as E
    from fpga_mpeg2_encoder_tpu_torch.golden import encoder as G
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
    from fpga_mpeg2_encoder_tpu_torch.utils.testdata import GOLDEN_MATRIX, video

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    lines, cases = [], []
    for w, h, q, vl, n, kind, pf, stop, groups, chunk in GOLDEN_MATRIX:
        cfg = EncoderConfig(xl=5, yl=4, vector_level=vl, q_level=q)
        clip = video(w + n, w, h, n, kind)
        _build.reset_launches()
        got = Encoder(cfg, device=device).encode(clip, w, h, pf, stop_mode=stop,
                                                 partial_groups=groups, chunk_frames=chunk)
        sync()
        low = {k: _build.LAUNCHES[k] for k in MAIN_PATH if _build.LAUNCHES[k] < n}
        if low:
            raise AssertionError(f"10a {w}x{h} q{q} vl{vl}: kernels launched fewer than "
                                 f"{n} times: {low}")
        want = G.encode_sequence(cfg, SequenceConfig(w, h, pf), clip, stop_mode=stop,
                                 partial_groups=groups)
        if got != want:
            raise AssertionError(f"10a {w}x{h} q{q} vl{vl} {kind} {stop} chunk {chunk}: "
                                 f"stream ({len(got)} bytes) != golden ({len(want)} bytes)")
        cases.append(f"{w}x{h} q{q} vl{vl} {n}f {kind} {stop}/p{pf}/chunk {chunk}")
    lines.append(f"10a golden matrix: {len(cases)} streams byte-equal to "
                 f"golden.encoder.encode_sequence: {'; '.join(cases)}")

    fn, args = E.entry(device)
    _build.reset_launches()
    got = fn(*args)
    sync()
    once = {k: _build.LAUNCHES[k] for k in MAIN_PATH}
    if any(v != 1 for v in once.values()):
        raise AssertionError(f"10b entry(): launches {once}, each should be 1")
    cfn, cargs = E.entry("cpu")
    want = cfn(*cargs)
    nw = (int(want[4]) + 31) // 32
    if bool(got[5]) or int(got[4]) != int(want[4]) \
            or not torch.equal(got[3][:nw].cpu(), want[3][:nw]) \
            or not all(torch.equal(a.cpu(), b) for a, b in zip(got[:3], want[:3])):
        raise AssertionError("10b entry(): the card's payload or recon != the CPU's")
    lines.append(f"10b entry(): {int(got[4])} payload bits, payload and recon equal the "
                 f"CPU's, launches {once}")

    with tempfile.TemporaryDirectory() as tmp:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", world_size=1,
                                rank=0)
        try:
            E.dryrun_multichip(1, device)
        finally:
            dist.destroy_process_group()
    lines.append(f"10c dryrun_multichip(1) over {backend}: BatchEncoder on a stream mesh, "
                 f"sharded_row_sad, the one-rank sharded frame encoder equal to "
                 f"encode_frame_core: ok")
    return lines


def main():
    import torch

    starts = {1: time.perf_counter()}      # phase -> its start on the host clock

    # ---- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_per_s = sms * INT32_LANES_PER_SM * float(clock) * 1e6
    print(f"1 device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {sms} SMs, max SM clock {clock} MHz: "
          f"INT32 peak {int32_per_s / 1e12:.2f} TOP/s, memory {MEM_BYTES_PER_S / 1e12} TB/s",
          flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from bench import PAYLOAD_SHA256, make_frames
    from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig
    from fpga_mpeg2_encoder_tpu_torch.core.bitstream import sequence_end, sequence_start
    from fpga_mpeg2_encoder_tpu_torch.models import encoder as M
    from fpga_mpeg2_encoder_tpu_torch.ops import bitpack, colorspace, dct, entropy, motion
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import acsym as k_acsym
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import carry as k_carry
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import colorspace as k_cs
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import glue as k_glue
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import me as k_me
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import pack as k_pack
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import transform as k_tf
    from fpga_mpeg2_encoder_tpu_torch.utils.testdata import random_sequence

    def bound(nbytes_moved, ops):
        """(bound_ms, bound_by): the larger of the bytes over the memory rate
        and the integer operations over the INT32 rate."""
        t_bytes, t_ops = nbytes_moved / MEM_BYTES_PER_S, ops / int32_per_s
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    # ---- 2. build ---------------------------------------------------------------
    starts[2] = time.perf_counter()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    with open(lib[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
    print(f"2 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib, root)}",
          flush=True)
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    # me_fused_kernel<YRC>: the +-4 window (vector_level 1, 2) and the +-6 (3)
    for yrc in (4, 6):
        ops = [op.split()[1] if op.startswith("@") else op.split()[0]
               for op in _build.sass(lib, f"me_fused_kernelILi{yrc}E")]
        vabs = [k for k, op in enumerate(ops) if op.startswith("VABSDIFF4")]
        if not vabs:
            raise AssertionError(f"me_fused_kernel<{yrc}>: no VABSDIFF4 in its SASS")
        print(f"2 sass me_fused_kernel<{yrc}>: {len(vabs)} VABSDIFF4 of {len(ops)} "
              f"instructions; {vabs[-1] - vabs[0] + 1} instructions from the first "
              f"VABSDIFF4 to the last", flush=True)

    # ---- 3. kernels against their plain versions --------------------------------
    starts[3] = time.perf_counter()
    cfg = EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)
    yr, ur = cfg.yr, cfg.ur
    timing, timing_sd = {}, {}    # at 1920x1152; F at 720x576, vector_level 2
    gen = torch.Generator(device="cpu").manual_seed(0)

    def carry_call(fn, rows, i_frame, over):
        """The gop program's carry (kernel or plain) on made-up operands:
        ``rows`` rows at exactly a cap of 16 words, the last one over it
        (``over`` "row"), or the frame over its cap ("frame"); GOP position
        ``i_frame`` of 24, frame 1439, k at the last of 64 slots.  Returns
        every tensor it writes."""
        t = lambda v, dtype=torch.int64: torch.tensor(v, dtype=dtype, device=dev)
        row_bits = torch.full((rows,), 32 * 16, dtype=torch.int64, device=dev)
        row_bits[rows - 1] += 8 if over == "row" else 0
        state = (t(1000), t(False, torch.bool), t(i_frame, torch.int32), t(23, torch.int32),
                 t(1439, torch.int32), t([63]))
        per_frame = (torch.zeros(64, dtype=torch.int64, device=dev),
                     torch.zeros(64, dtype=torch.int32, device=dev))
        fn(row_bits, 16, t(4000), t(over == "frame", torch.bool), t(5000), state, per_frame)
        return state + per_frame

    for (w, h) in ((W, H), (720, 576), (416, 64), (64, 64)):
        f0, f1 = make_frames(w, h, 2)
        y0, u0, v0 = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f0))
        planes1 = tuple(torch.as_tensor(p, device=dev) for p in f1)
        y1, u1, v1 = colorspace.subsample_420(*planes1)
        nby, nbx = h // 16, w // 16
        n_mb = nby * nbx
        checks = []   # (label, kernel name, kernel call, plain call, (bytes, ops) or None)

        # the subsample: both chroma planes read once and their 4:2:0 planes
        # written once; three byte averages an output byte (720 px wide: a
        # chroma width of 360, 8 mod 16)
        checks.append(("", "subsample", lambda: k_cs.subsample_420(*planes1),
                       lambda: colorspace.subsample_420(*planes1),
                       (nbytes(*planes1[1:]) + nbytes(u1, v1), 3 * (u1.numel() + v1.numel()))))
        # its stack entry, the gop program's: frame 1 of a (2, 3, H, W) stack
        # read through the plane table, its Y plane copied out as well
        stack = torch.stack([torch.stack([torch.as_tensor(p, device=dev) for p in f])
                             for f in (f0, f1)])
        stacks = tuple(stack[:, i] for i in range(3))
        table = torch.empty(6, dtype=torch.int64, device=dev)
        k1 = torch.ones(1, dtype=torch.int64, device=dev)
        k_cs.plane_table(stacks, table)
        y_out = torch.empty_like(planes1[0])
        checks.append(("stack", "subsample",
                       lambda: k_cs.subsample_420_stack(stacks, table, k1, y_out),
                       lambda: colorspace.subsample_420(*planes1),
                       (nbytes(*planes1) + nbytes(planes1[0], u1, v1),
                        3 * (u1.numel() + v1.numel()))))

        # motion: fused, luma, chroma, I and P; the fused kernel is also held
        # against the luma kernel followed by the chroma kernel
        me_in = nbytes(y1, y0, u0, v0)
        me_out = nbytes(*k_me.motion_estimate_fused(y1, y0, u0, v0, False, yr, ur,
                                                    as_plane=True))
        luma_out = nbytes(*k_me.motion_estimate(y1, y0, False, yr, as_plane=True))
        for is_i in (False, True):
            tag = "I" if is_i else "P"
            # the search: (2yr+1)^2 full-pel + 9 half-pel + 1 intra candidate
            # absolute-difference adds per pixel, plus the pixel sum, four
            # to an instruction; an I-frame skips it
            ops = 0 if is_i else n_mb * 256 * ((2 * yr + 1) ** 2 + 11) // SAD_PER_OP
            checks.append((f"{tag}", "me_fused",
                           lambda i=is_i: k_me.motion_estimate_fused(
                               y1, y0, u0, v0, i, yr, ur, as_plane=True),
                           lambda i=is_i: tuple(motion.estimate_and_predict_planes(
                               y1, u1, v1, y0, u0, v0, i, yr, ur)),
                           (me_in + me_out, ops)))
            checks.append((f"{tag}", "me_luma",
                           lambda i=is_i: k_me.motion_estimate(y1, y0, i, yr, as_plane=True),
                           lambda i=is_i: (lambda r: (*r[:3], motion.to_planes(r[3])))(
                               motion.estimate_luma(y1, motion.pad_halo(y0, 8), i, yr, 0, nby)),
                           (nbytes(y1, y0) + luma_out, ops)))
        inter, mvx, mvy = k_me.motion_estimate_fused(y1, y0, u0, v0, False, yr, ur)[:3]
        mixed = (torch.rand((nby, nbx), generator=gen) < 0.5).to(dev)
        chroma_out = nbytes(*k_me.chroma_pred(u0, v0, inter, mvx, mvy, ur, as_plane=True))
        for label, imap in (("P maps", inter), ("mixed inter map", mixed)):
            n_inter = int(imap.sum())
            checks.append((label, "chroma_pred",
                           lambda m=imap: k_me.chroma_pred(u0, v0, m, mvx, mvy, ur,
                                                           as_plane=True),
                           lambda m=imap: tuple(map(motion.to_planes, motion.chroma_pred(
                               motion.pad_halo(u0, 4), motion.pad_halo(v0, 4), m, mvx,
                               mvy, ur))),
                           (nbytes(u0, v0, imap, mvx, mvy) + chroma_out,
                            n_inter * 128 * 4)))
        if (w, h) == SD:
            # F at the sd cells' search range (vector_level 2), timed as well
            yr2 = 2 * 2
            checks.append(("P vl2", "me_fused",
                           lambda: k_me.motion_estimate_fused(y1, y0, u0, v0, False, yr2, 2,
                                                              as_plane=True),
                           lambda: tuple(motion.estimate_and_predict_planes(
                               y1, u1, v1, y0, u0, v0, False, yr2, 2)),
                           (me_in + me_out,
                            n_mb * 256 * ((2 * yr2 + 1) ** 2 + 11) // SAD_PER_OP)))
        for is_i in (False, True):
            split = k_me.motion_estimate(y1, y0, is_i, yr, as_plane=True)
            split += k_me.chroma_pred(u0, v0, *split[:3], ur, as_plane=True)
            fused = k_me.motion_estimate_fused(y1, y0, u0, v0, is_i, yr, ur, as_plane=True)
            torch.cuda.synchronize()
            if max_abs_err(fused, split) != 0:
                raise AssertionError(f"me_fused {w}x{h}: != me_luma then chroma_pred")
        print(f"3 kernel me_fused   {w}x{h} I and P: equals me_luma then chroma_pred",
              flush=True)

        mr_p = motion.estimate_and_predict_planes(y1, u1, v1, y0, u0, v0, False, yr, ur)
        mr_i = motion.estimate_and_predict_planes(y1, u1, v1, y0, u0, v0, True, yr, ur)
        for q_level in (2, 4):
            for label, mr, imap in (("intra", mr_i, mr_i.inter), ("mixed", mr_p, mixed)):
                args = (y1, u1, v1, mr.pred_y, mr.pred_u, mr.pred_v, imap)
                # 16 multiply-adds per coefficient for the forward DCT alone
                work = (nbytes(*args) + n_mb * 384 * 4 + nbytes(y1, u1, v1),
                        16 * 384 * n_mb)
                checks.append((f"q{q_level} {label}", "transform",
                               lambda a=args, q=q_level: k_tf.transform_recon(*a, q),
                               lambda a=args, q=q_level: dct.transform_recon(*a, q),
                               work if (q_level, label) == (2, "mixed") else None))
        qzig, *_ = k_tf.transform_recon(y1, u1, v1, mr_p.pred_y, mr_p.pred_u,
                                        mr_p.pred_v, mr_p.inter, cfg.q_level)
        # the symbol glue: the P-frame with its header rows, the I-frame, a
        # band of rows from first_row 5 without them (the shards' form) and
        # the header rows alone (the frame tail's); the coefficients, maps
        # and GOP state read once, zmod, small and the header rows written
        # once, a nonzero test a coefficient
        s_w = entropy.HDR_SLOTS + entropy.SLOTS_PER_MB * nbx
        qzig_i = k_tf.transform_recon(y1, u1, v1, mr_i.pred_y, mr_i.pred_u, mr_i.pred_v,
                                      mr_i.inter, cfg.q_level)[0]
        band = tuple(t[1:].contiguous() for t in (qzig, mr_p.inter, mr_p.mvx, mr_p.mvy))
        gop5 = torch.full((), 5, dtype=torch.int32, device=dev)
        for label, g_args, i_f, fno, first_row, hs in (
                ("P", (qzig, mr_p.inter, mr_p.mvx, mr_p.mvy), 1, 1, 0, s_w),
                ("I", (qzig_i, mr_i.inter, mr_i.mvx, mr_i.mvy), 0, 24 * 3600 * 64, 0, s_w),
                ("rows from 5", band, gop5, 1441, 5, None)):
            glue_io = nbytes(*g_args, *entropy.ac_inputs(*g_args, i_f, cfg.q_level)) \
                + 2 * (hs or 0) * 4 + 8
            checks.append((label, "glue",
                           lambda a=(g_args, i_f, fno, first_row, hs): tuple(
                               t for t in k_glue.symbol_glue(*a[0], a[1], a[2], cfg.q_level,
                                                             a[3], a[4]) if t is not None),
                           lambda a=(g_args, i_f, fno, first_row, hs): (
                               *entropy.ac_inputs(*a[0], a[1], cfg.q_level, a[3]),
                               *((entropy._header_rows(a[1], a[2], a[4], dev),)
                                 if a[4] else ())),
                           (glue_io, 384 * n_mb) if label == "P" else None))
        checks.append(("header rows", "glue", lambda: (k_glue.header_rows(1, 1, 16, dev),),
                       lambda: (entropy._header_rows(1, 1, 16, dev),), None))
        ac_args = entropy.ac_inputs(qzig, mr_p.inter, mr_p.mvx, mr_p.mvy, 1, cfg.q_level)
        # acsym reads zmod and only the non-AC slots of small (16 a
        # macroblock, 3 a slice header) and writes the whole grid
        small = ac_args[1]
        ac_read = nbytes(ac_args[0]) + (16 * n_mb + 3 * nby) * small.element_size()
        checks.append(("", "acsym", lambda: k_acsym.ac_slot_grid(*ac_args),
                       lambda: entropy.ac_slot_grid(*ac_args),
                       (ac_read + nbytes(small), 0)))
        slots = entropy.symbolize_frame(qzig, mr_p.inter, mr_p.mvx, mr_p.mvy, 1, 1,
                                        cfg.q_level)
        codes, lens = slots & entropy.SLOT_CODE_MASK, entropy.slot_len(slots)
        rw, rb, _ = k_pack.pack_slots(slots, CAPS["row_cap"])
        for cap, tag in ((CAPS["row_cap"], ""), (16, " overflow")):
            # the words and bits of each row, 32-bit values (carried as int64)
            out_bytes = rw.shape[0] * (cap + 1) * WORD_BYTES
            checks.append((f"cap {cap}{tag}", "pack_slots",
                           lambda c=cap: k_pack.pack_slots(slots, c),
                           lambda c=cap: bitpack.pack_slots(slots, c),
                           (nbytes(slots) + out_bytes, 0)))
            checks.append((f"cap {cap}{tag}", "pack_symbols",
                           lambda c=cap: k_pack.pack_symbols(codes, lens, c),
                           lambda c=cap: bitpack.pack_symbols(codes, lens, c),
                           (nbytes(codes, lens) + out_bytes, 0)))
        # the gop program's entry: the header rows and the slice rows as two
        # operands, each row written up to its last partial word; there, and
        # in its bits, it equals the public entry on the stacked grid
        hdr, rows = entropy.symbolize_rows(qzig, mr_p.inter, mr_p.mvx, mr_p.mvy, 1, 1,
                                           cfg.q_level)

        def under_bits(words, bits):
            cols = torch.arange(words.shape[1], device=dev)
            return torch.where(cols < (bits[:, None] + 31) // 32, words, 0), bits

        checks.append(("two operands", "pack_slots",
                       lambda: under_bits(*k_pack.pack_rows(hdr, rows, CAPS["row_cap"])),
                       lambda: under_bits(*k_pack.pack_slots(slots, CAPS["row_cap"])[:2]),
                       None))
        needed = (int(((rb + 31) // 32).sum()) + rb.numel()) * WORD_BYTES
        for cap, tag in ((CAPS["frame_cap"], ""), (64, " overflow")):
            checks.append((f"cap {cap}{tag}", "merge_rows",
                           lambda c=cap: k_pack.merge_rows(rw, rb, c),
                           lambda c=cap: bitpack.merge_rows(rw, rb, c),
                           (needed + WORD_BYTES * cap, 0)))
        # the merge kernel's append mode (merge_append, the frame loop's
        # form) at every seq_bits & 31, cut at a small cap, and with its
        # offset clamped: a buffer each for the kernel and the plain version,
        # random bits before seq_bits; repeated calls OR the same bits again
        fbits = int(rb.sum())
        rng = np.random.default_rng(w)

        def seq_pair(n_words, seq_bits):
            seq = torch.as_tensor(random_sequence(rng, n_words, seq_bits), device=dev)
            return seq, seq.clone(), torch.tensor(seq_bits, device=dev)

        fcap = CAPS["frame_cap"]
        cases = [(f"append s={k}", fcap, 2048, 32 * 1000 + k) for k in range(32)]
        cases += [("append cap 64 overflow", 64, 2048, 32 * 1000 + 9),
                  ("append clamped", fcap, 4, 32 * (fcap + 50) + 5)]
        for label, cap, spare, seq_bits in cases:
            seq_k, seq_p, sb = seq_pair(cap + 1 + spare, seq_bits)
            # the words under the frame's bits and the row bits read; the
            # sequence words under the frame's bits read and written
            touched = (min(fbits, 32 * cap) + seq_bits % 32 + 31) // 32
            checks.append((label, "merge_rows",
                           lambda a=(seq_k, sb, cap): k_pack.merge_append(
                               a[0], a[1], rw, rb, a[2]),
                           lambda a=(seq_p, sb, cap): bitpack.merge_append(
                               a[0], a[1], rw, rb, a[2]),
                           (needed + 2 * WORD_BYTES * touched, 0)
                           if label == TIMED_APPEND else None))
        # the gop program's carry kernel: the GOP wrap, a row or the frame
        # over its cap (untimed: it is bound by its launch)
        for label, i_frame, over in (("carry wrap", 23, "none"), ("carry row over", 5, "row"),
                                     ("carry frame over", 0, "frame")):
            checks.append((label, "gop_carry",
                           lambda a=(2 + nby, i_frame, over): carry_call(k_carry.gop_carry, *a),
                           lambda a=(2 + nby, i_frame, over): carry_call(k_carry.plain_carry,
                                                                         *a), None))
        for label, kname, kern, plain, work in checks:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err != 0:
                raise AssertionError(f"{kname} {w}x{h} {label}: kernel != plain "
                                     f"(max abs err {err})")
            if "overflow" in label:
                flag = (got[3] if label.startswith("append") else got[1] > 32 * 64) \
                    if kname == "merge_rows" else got[2]
                if not bool(flag):
                    raise AssertionError(f"{kname} {w}x{h} {label}: no overflow")
            times = ""
            if ((w, h) == (W, H) or label == "P vl2") and work is not None \
                    and "overflow" not in label:
                b_ms, b_by = bound(*work)
                t = dict(ms=device_ms(kern, KERNEL_SYMBOLS[kname]), plain_ms=device_ms(plain),
                         call_ms=cuda_ms(kern), plain_call_ms=cuda_ms(plain),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
                if label == "P vl2":
                    timing_sd[kname] = t
                elif kname not in timing or label in ("P", "P maps", TIMED_APPEND):
                    timing[kname] = (t, err)
                times = (f"  kernel {t['ms']:.4f} ms on device ({t['call_ms']:.4f} per call)"
                         f"  plain {t['plain_ms']:.4f} ms on device ({t['plain_call_ms']:.4f}"
                         f" per call)  bound {b_ms:.5f} ms ({b_by}: {work[0] / 1e6:.2f} MB,"
                         f" {work[1] / 1e6:.1f} M int ops)")
            print(f"3 kernel {kname:12s} {w}x{h} {label:18s} exact{times}", flush=True)

    # ---- 4. stages of one 1920x1152 P-frame -----------------------------------
    starts[4] = time.perf_counter()
    frames = make_frames(W, H, NF)
    fy, fu, fv = (torch.as_tensor(np.stack([f[i] for f in frames]), device=dev)
                  for i in range(3))
    y0, u0, v0 = colorspace.subsample_420(fy[0], fu[0], fv[0])
    kw = dict(yr=yr, ur=ur, q_level=cfg.q_level)
    st = {}
    st["subsample (plain)"] = cuda_ms(lambda: colorspace.subsample_420(fy[1], fu[1], fv[1]))
    st["subsample (kernel)"] = cuda_ms(lambda: k_cs.subsample_420(fy[1], fu[1], fv[1]))
    y, u, v = colorspace.subsample_420(fy[1], fu[1], fv[1])
    st["motion (kernel)"] = cuda_ms(lambda: k_me.estimate_and_predict_planes(
        y, u, v, y0, u0, v0, False, yr, ur))
    st["motion (plain)"] = cuda_ms(lambda: motion.estimate_and_predict_planes(
        y, u, v, y0, u0, v0, False, yr, ur))
    mr = k_me.estimate_and_predict_planes(y, u, v, y0, u0, v0, False, yr, ur)
    targs = (y, u, v, mr.pred_y, mr.pred_u, mr.pred_v, mr.inter, cfg.q_level)
    st["transform (kernel)"] = cuda_ms(lambda: k_tf.transform_recon(*targs))
    qzig = k_tf.transform_recon(*targs)[0]
    eargs = (qzig, mr.inter, mr.mvx, mr.mvy, 1, cfg.q_level)
    st["symbol glue (plain)"] = cuda_ms(lambda: entropy.ac_inputs(*eargs))
    st["symbol glue (kernel)"] = cuda_ms(lambda: k_glue.symbol_glue(*eargs[:5], 1,
                                                                    cfg.q_level))
    ac_args = entropy.ac_inputs(*eargs)
    st["acsym (kernel)"] = cuda_ms(lambda: k_acsym.ac_slot_grid(*ac_args))
    slots = entropy.symbolize_frame(*eargs[:5], 1, cfg.q_level)
    st["pack_slots (kernel)"] = cuda_ms(lambda: k_pack.pack_slots(slots, CAPS["row_cap"]))
    rw, rb, _ = k_pack.pack_slots(slots, CAPS["row_cap"])
    st["merge_rows (kernel)"] = cuda_ms(lambda: k_pack.merge_rows(rw, rb, CAPS["frame_cap"]))
    fw, fb = k_pack.merge_rows(rw, rb, CAPS["frame_cap"])
    seq = torch.zeros(SEQ_CAP + CAPS["frame_cap"] + 1, dtype=torch.int64, device=dev)
    sb = torch.zeros((), dtype=torch.int64, device=dev)
    st["append (plain)"] = cuda_ms(lambda: bitpack.append_bitstring(seq, sb, fw, fb))
    st["merge+append (kernel)"] = cuda_ms(lambda: k_pack.merge_append(
        seq, sb, rw, rb, CAPS["frame_cap"]))
    st["whole frame"] = cuda_ms(lambda: M.encode_frame_core(
        fy[1], fu[1], fv[1], y0, u0, v0, 1, 1, **kw, **CAPS))
    print("4 stages (ms per 1920x1152 P-frame): "
          + ", ".join(f"{k} {v:.4f}" for k, v in st.items()), flush=True)

    # ---- 5. end to end ---------------------------------------------------------
    starts[5] = time.perf_counter()
    zy = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    zc = torch.zeros((H // 2, W // 2), dtype=torch.uint8, device=dev)

    def run_a(nf=NF):
        return M.encode_gop_scan_core(fy[:nf], fu[:nf], fv[:nf], zy, zc, zc, 0, 0, 23,
                                      **kw, **CAPS, seq_cap=SEQ_CAP)

    def check_launches(tag, path, never=()):
        counts = dict(_build.LAUNCHES)
        low = {k: counts[k] for k in path if counts[k] < NF}
        if low:
            raise AssertionError(f"{tag}: kernels launched fewer than {NF} times: {low}")
        used = {k: counts[k] for k in never if counts[k]}
        if used:
            raise AssertionError(f"{tag}: kernels off this path were launched: {used}")
        return counts

    def check_payload(tag, sw, sbits):
        payload = M.payload_bytes(sw, sbits)
        digest = hashlib.sha256(payload).hexdigest()
        if digest != PAYLOAD_SHA256:
            raise AssertionError(f"{tag}: payload digest {digest} != {PAYLOAD_SHA256}")
        if payload[:4] != b"\x00\x00\x01\xb8" or payload[8:12] != b"\x00\x00\x01\x00":
            raise AssertionError(f"{tag}: payload does not start with GOP + picture headers")
        return payload

    def no_plain_append(*args, **kwargs):
        raise AssertionError("5a: the multi-frame path ran the plain append")

    _build.reset_launches()
    plain_append, bitpack.append_bitstring = bitpack.append_bitstring, no_plain_append
    try:
        out = run_a()
    finally:
        bitpack.append_bitstring = plain_append
    torch.cuda.synchronize()
    launches_a = check_launches("5a", MAIN_PATH, ("me_luma", "chroma_pred", "gop_carry"))
    if bool(out[7]):
        raise AssertionError("5a: payload overflow at bench caps")
    payload = check_payload("5a", out[3], int(out[4]))
    out_a = out
    print(f"5a encode_gop_scan_core: {len(payload)} payload bytes, sha256 matches "
          f"bench.py PAYLOAD_SHA256, no overflow, launches {launches_a}", flush=True)

    runs = [cuda_ms(run_a, reps=1, warmup=0) for _ in range(3)]
    ms = min(runs)
    mpix = W * H * NF / (ms / 1e3) / 1e6
    print(f"5a timed: {ms:.1f} ms for {NF} frames = {mpix:.1f} MPixels/s "
          f"({NF / (ms / 1e3):.1f} frames/s), best of "
          f"{', '.join(f'{r:.1f}' for r in runs)} ms, on {smi}", flush=True)

    _build.reset_launches()
    stream = Encoder(EncoderConfig(xl=7, yl=7), device="cuda", **CAPS).encode(
        frames, W, H, pframes_count=23, chunk_frames=48)
    torch.cuda.synchronize()
    launches_b = check_launches("5b", MAIN_PATH, ("me_luma", "chroma_pred"))
    digest = hashlib.sha256(stream).hexdigest()
    if len(stream) != SOAK_BYTES or digest != SOAK_SHA256:
        raise AssertionError(f"5b: stream {len(stream)} bytes sha256 {digest}, "
                             f"expected {SOAK_BYTES} bytes {SOAK_SHA256}")
    hl = len(sequence_start(W, H))
    body = stream.rstrip(b"\x00")
    if not (stream[:4] == b"\x00\x00\x01\xb3"
            and stream[hl:hl + 4] == b"\x00\x00\x01\xb8"
            and stream[hl + 8:hl + 12] == b"\x00\x00\x01\x00"
            and body.endswith(b"\x00\x00\x01\xb7") and len(stream) % 32 == 0):
        raise AssertionError("5b: stream structure")
    print(f"5b Encoder.encode(chunk_frames=48): {len(stream)} bytes, sha256 matches "
          f"the 1080p soak digest, structure ok, launches {launches_b}", flush=True)

    # ---- 6. profile of the main path --------------------------------------------
    starts[6] = time.perf_counter()
    npf = 16
    wall = min(cuda_ms(lambda: run_a(npf), reps=1, warmup=1) for _ in range(3)) / npf
    ev = profile_events(lambda: run_a(npf), 1)
    busy = sum(e.time_range.elapsed_us() for e in ev) / npf / 1e3
    by_name = {}
    for e in ev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    kernels6 = len(ev) / npf
    print(f"6 profile ({npf} frames of 5a): {len(ev) / npf:.1f} kernels per frame, "
          f"{busy:.4f} ms device time per frame, {wall:.4f} ms per frame without the "
          f"profiler: device idle {100 * (1 - busy / wall):.1f}%", flush=True)
    for n, (cnt, t) in top:
        print(f"  {t / npf:.4f} ms/frame  {cnt / npf:.1f} launches/frame  {n[:90]}")

    # ---- 7. multi-stream: 8 x 1080p through BatchEncoder ----------------------
    starts[7] = time.perf_counter()
    from fpga_mpeg2_encoder_tpu_torch import SequenceConfig
    from fpga_mpeg2_encoder_tpu_torch.parallel.dp import BatchEncoder, encode_gops_batched

    ns, nf7 = 8, 24
    chunks = [[frames[(k + 3 * b) % NF] for k in range(nf7)] for b in range(ns)]
    be = BatchEncoder(cfg, SequenceConfig(W, H, 23), ns, device="cuda", **CAPS)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    be.push_chunks(chunks)
    torch.cuda.synchronize()
    t_push = time.perf_counter() - t0
    launches7 = dict(_build.LAUNCHES)
    low = {k: launches7[k] for k in MAIN_PATH if launches7[k] < ns * nf7}
    if low or launches7["me_luma"] or launches7["chroma_pred"]:
        raise AssertionError(f"7: launches {launches7}: need >= {ns * nf7} of each "
                             f"main-path kernel and no split motion kernel")
    streams7 = be.finish()
    t_single = time.perf_counter()
    for b in range(ns):
        single = Encoder(cfg, device="cuda", **CAPS).encode(chunks[b], W, H, 23,
                                                           chunk_frames=nf7)
        if streams7[b] != single:
            raise AssertionError(f"7: stream {b} != Encoder.encode of its frames")
    t_single = time.perf_counter() - t_single
    # the batch's frame loop alone, its frames already on the card
    stacks = [torch.as_tensor(np.stack([np.stack([f[i] for f in c]) for c in chunks]),
                              device=dev) for i in range(3)]
    zb = torch.zeros((ns, H, W), dtype=torch.uint8, device=dev)
    zbc = torch.zeros((ns, H // 2, W // 2), dtype=torch.uint8, device=dev)

    def batch_loop(nf=nf7):
        return encode_gops_batched(*(t[:, :nf] for t in stacks), zb, zbc, zbc, [0] * ns,
                                   [0] * ns, 23, **kw,
                                   **M.chunk_caps(CAPS["row_cap"], CAPS["frame_cap"], W, H,
                                                  nf)[0])

    loop_ms = cuda_ms(batch_loop, reps=1, warmup=1)
    # the profiler's cost grows with its events: profile 4 frames a stream,
    # against the same window's time without it, after a warm-up call (4
    # frames take another sequence cap, so another program is captured)
    npf7 = 4
    window_ms = cuda_ms(lambda: batch_loop(npf7), reps=1, warmup=1)
    ev = profile_events(lambda: batch_loop(npf7), 1)
    busy7 = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    del stacks
    pix7 = ns * nf7 * W * H
    print(f"7 BatchEncoder {ns} x {W}x{H} x {nf7} frames: each stream equals Encoder.encode; "
          f"launches {launches7}; push_chunks (host stacking, upload, loop, download) "
          f"{t_push * 1e3:.1f} ms = {pix7 / t_push / 1e6:.1f} MPixels/s aggregate; the frame "
          f"loop alone (encode_gops_batched, frames on the card) {loop_ms:.1f} ms = "
          f"{pix7 / (loop_ms / 1e3) / 1e6:.1f} MPixels/s; {npf7} frames a stream under the "
          f"profiler: {len(ev) / (ns * npf7):.1f} kernels and {busy7 / (ns * npf7):.4f} ms of "
          f"device time a stream-frame, {window_ms:.1f} ms without it: device idle "
          f"{100 * (1 - busy7 / window_ms):.1f}%; the {ns} single-stream encodes took "
          f"{t_single:.1f} s; on {smi}", flush=True)

    # ---- 8. slice shards on one card ----------------------------------------------
    starts[8] = time.perf_counter()
    from fpga_mpeg2_encoder_tpu_torch.parallel.spatial import (
        band_with_halo, frame_tail, make_local_step)

    nsh, nf8 = 4, 8
    rows8 = H // 16 // nsh
    step = make_local_step(H // 16, yr=yr, ur=ur, q_level=cfg.q_level, row_cap=CAPS["row_cap"])
    bands = []
    fused = k_me.motion_estimate_fused

    def recording_fused(*args, **kwargs):
        bands.append((kwargs.get("halo", False), args[7] if len(args) > 7 else 0))
        return fused(*args, **kwargs)

    prev = (zy, zc, zc)
    sharded = []
    _build.reset_launches()
    k_me.motion_estimate_fused = recording_fused
    try:
        for fi in range(nf8):
            planes = (fy[fi], fu[fi], fv[fi])
            outs = []
            for k in range(nsh):
                a, b = 16 * rows8 * k, 16 * rows8 * (k + 1)
                outs.append(step(*(p[a:b] for p in planes),
                                 band_with_halo(prev[0], motion.LUMA_HALO, a, b),
                                 band_with_halo(prev[1], motion.CHROMA_HALO, a // 2, b // 2),
                                 band_with_halo(prev[2], motion.CHROMA_HALO, a // 2, b // 2),
                                 fi, fi, rows8 * k))
            ry, ru, rv, words, bits = (torch.cat([o[i] for o in outs]) for i in range(5))
            ovf = torch.stack([o[5] for o in outs]).any()
            sharded.append(((ry, ru, rv), *frame_tail(words, bits, ovf, fi, fi, **CAPS)))
            prev = (ry, ru, rv)
        torch.cuda.synchronize()
    finally:
        k_me.motion_estimate_fused = fused
    launches8 = dict(_build.LAUNCHES)
    want8 = {"subsample": nsh * nf8, "me_fused": nsh * nf8, "transform": nsh * nf8,
             "glue": (nsh + 1) * nf8, "acsym": nsh * nf8, "pack_slots": (nsh + 1) * nf8,
             "merge_rows": nf8}
    if any(launches8[k] != n for k, n in want8.items()):
        raise AssertionError(f"8: launches {launches8}, expected {want8}")
    firsts = sorted({r for halo, r in bands if halo})
    if len(bands) != nsh * nf8 or firsts != [rows8 * k for k in range(nsh)]:
        raise AssertionError(f"8: motion kernel calls (halo, first_mb_row) {bands}")
    prev = (zy, zc, zc)
    want_frames = []
    for fi in range(nf8):
        ry, ru, rv, fw, fb, ovf = M.encode_frame_core(fy[fi], fu[fi], fv[fi], *prev, fi, fi,
                                                      **kw, **CAPS)
        (sy, su, sv), sw, sb, sovf = sharded[fi]
        nw = (int(fb) + 31) // 32
        if bool(ovf) or bool(sovf) or int(sb) != int(fb) or not torch.equal(sw[:nw], fw[:nw]):
            raise AssertionError(f"8: frame {fi}: sharded payload != encode_frame_core's")
        if not (torch.equal(sy, ry) and torch.equal(su, ru) and torch.equal(sv, rv)):
            raise AssertionError(f"8: frame {fi}: sharded recon != encode_frame_core's")
        want_frames.append((int(fb), fw[:nw].cpu().numpy(),
                            tuple(p.cpu().numpy() for p in (ry, ru, rv))))
        prev = (ry, ru, rv)
    print(f"8 slice shards: {nsh} x {rows8} macroblock rows of {W}x{H}, {nf8} frames IPPP: "
          f"payload and recon equal encode_frame_core on every frame; motion kernel in its "
          f"band form at first_mb_row {firsts}; kernels a frame "
          f"{ {k: v / nf8 for k, v in launches8.items() if v} }", flush=True)
    n_cards = torch.cuda.device_count()

    def check_ranks(tag, res):
        """Each rank's saved frames against phase 8's encode_frame_core."""
        for fi, (fb, fw, recon) in enumerate(want_frames):
            for r, got in enumerate(res):
                a, b = got["rows"]
                if got[f"ovf{fi}"] or int(got[f"bits{fi}"]) != fb \
                        or not np.array_equal(got[f"words{fi}"], fw):
                    raise AssertionError(f"{tag}: rank {r} frame {fi}: payload differs")
                for c, plane, rows in zip("yuv", recon, (16, 8, 8)):
                    if not np.array_equal(got[f"{c}{fi}"], plane[rows * a:rows * b]):
                        raise AssertionError(f"{tag}: rank {r} frame {fi}: recon differs")

    if n_cards >= 2:
        world = min(4, n_cards)
        check_ranks("8 NCCL", run_sharded_ranks(world, "nccl", nf8))
        print(f"8 make_sharded_frame_encoder over NCCL on {world} cards: {nf8} frames equal "
              f"encode_frame_core", flush=True)
    else:
        print(f"8 make_sharded_frame_encoder over NCCL: not run, it needs two cards "
              f"and this machine has {n_cards}", flush=True)

    # ---- 9. command line -----------------------------------------------------------
    starts[9] = time.perf_counter()
    from fpga_mpeg2_encoder_tpu_torch.cli import decode as decode_cli
    from fpga_mpeg2_encoder_tpu_torch.utils import yuv

    with tempfile.TemporaryDirectory() as tmp:
        clips = [(416, 64, make_frames(416, 64, 4)), (W, H, frames[:4])]
        cmd = [sys.executable, "-m", "fpga_mpeg2_encoder_tpu_torch.cli.encode",
               "--device", "cuda", "--stats", "--quiet"]
        for i, (w, h, clip) in enumerate(clips):
            yuv.write_frames(os.path.join(tmp, f"in{i}.yuv"), clip)
            cmd += ["--input", os.path.join(tmp, f"in{i}.yuv"), "--size", f"{w}x{h}",
                    "--out", os.path.join(tmp, f"out{i}.m2v")]
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise AssertionError(f"9: cli.encode exited {r.returncode}:\n{r.stderr}")
        stats = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
        cli_cfg = EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)
        for i, (w, h, clip) in enumerate(clips):
            with open(os.path.join(tmp, f"out{i}.m2v"), "rb") as f:
                got = f.read()
            if got != Encoder(cli_cfg, device="cuda").encode(clip, w, h, 23):
                raise AssertionError(f"9: cli.encode's {w}x{h} stream != Encoder.encode")
            off = {k: stats[i]["kernel_launches"][k] for k in MAIN_PATH
                   if stats[i]["kernel_launches"][k] != len(clip)}
            if off:
                raise AssertionError(f"9: cli.encode {w}x{h}: kernels not launched exactly "
                                     f"once a frame: {off}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = decode_cli.main(["--input", os.path.join(tmp, "out0.m2v"), "--validate",
                                  "--ref", os.path.join(tmp, "in0.yuv")])
        if rc:
            raise AssertionError(f"9: cli.decode returned {rc}")
        info = json.loads(out.getvalue().strip().splitlines()[-1])
        if info["validator"] != "pass" or info["frames"] != 4:
            raise AssertionError(f"9: cli.decode --validate: {info}")
    print(f"9 cli.encode --device cuda (416x64 and {W}x{H}, 4 frames each, back to back): "
          f"streams equal Encoder.encode, each main-path kernel once a frame: "
          f"{[s['kernel_launches'] for s in stats]}; cli.decode --validate --ref on 416x64: "
          f"validator {info['validator']}, PSNR-Y {info['psnr_y_mean']} dB (min "
          f"{info['psnr_y_min']})", flush=True)

    # ---- 10. the golden matrix, entry() and the dry run -------------------------
    starts[10] = time.perf_counter()
    for line in phase_10("cuda"):
        print(line, flush=True)

    # ---- 11. the compiled programs: CUDA graphs of one frame's step ------------
    starts[11] = time.perf_counter()
    from fpga_mpeg2_encoder_tpu_torch.golden import encoder as G
    from fpga_mpeg2_encoder_tpu_torch.runtime import graphs
    from fpga_mpeg2_encoder_tpu_torch.utils.testdata import GOLDEN_MATRIX, video

    once = {**{k: 1 for k in MAIN_PATH}, "me_luma": 0, "chroma_pred": 0}

    def exact(tag, n, carried):
        """Each main-path kernel launched exactly n times, the carry kernel
        ``carried`` times (once a frame of encode_gop_scan), the split
        motion kernels never."""
        counts = dict(_build.LAUNCHES)
        if counts != {**{k: v * n for k, v in once.items()}, "gop_carry": carried}:
            raise AssertionError(f"{tag}: launches {counts}, want each main-path kernel "
                                 f"exactly {n} times, the carry kernel {carried} and the "
                                 f"split motion kernels never")
        return counts

    def run_g(nf=NF):
        return M.encode_gop_scan(fy[:nf], fu[:nf], fv[:nf], zy, zc, zc, 0, 0, 23,
                                 **kw, **CAPS, seq_cap=SEQ_CAP)

    t0 = time.perf_counter()
    run_g(1)                         # the warm-up and the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _build.reset_launches()
    out_g = run_g()
    torch.cuda.synchronize()
    launches_g = exact("11a", NF, NF)
    nbits = int(out_g[4])
    if bool(out_g[7]) or nbits != int(out_a[4]) \
            or not torch.equal(out_g[3][:(nbits + 31) // 32], out_a[3][:(nbits + 31) // 32]):
        raise AssertionError("11a: encode_gop_scan's words != 5a's")
    check_payload("11a", out_g[3], nbits)
    if out_g[9].tolist() != out_a[9] or out_g[8].tolist() != out_a[8].tolist():
        raise AssertionError("11a: per-frame bits or GOP positions != 5a's")
    runs_g = [cuda_ms(run_g, reps=1, warmup=0) for _ in range(3)]
    ms_g = min(runs_g)
    print(f"11a encode_gop_scan (graph replays): {nbits // 8} payload bytes, words equal 5a's, "
          f"sha256 matches bench.py PAYLOAD_SHA256, launches {launches_g} (once a frame); "
          f"{ms_g:.1f} ms for {NF} frames = {W * H * NF / (ms_g / 1e3) / 1e6:.1f} MPixels/s "
          f"({NF / (ms_g / 1e3):.1f} frames/s), best of {', '.join(f'{r:.1f}' for r in runs_g)}"
          f" ms, against 5a's eager {ms:.1f} ms; first call (warm-up and capture) "
          f"{capture_s:.2f} s; on {smi}", flush=True)

    wall_g = min(cuda_ms(lambda: run_g(npf), reps=1, warmup=1) for _ in range(3)) / npf
    for _ in range(3):               # a window without the replays' events is taken again
        ev_g = profile_events(lambda: run_g(npf), 1)
        if ev_g:
            break
    else:
        raise AssertionError("11b: the profiler saw no device events of the graph replays "
                             "in 3 windows")
    busy_g = sum(e.time_range.elapsed_us() for e in ev_g) / npf / 1e3
    print(f"11b profile ({npf} frames of 11a, graph replays): {len(ev_g) / npf:.1f} kernels "
          f"per frame, {busy_g:.4f} ms device time per frame, {wall_g:.4f} ms per frame "
          f"without the profiler: device idle {100 * (1 - busy_g / wall_g):.1f}%; eager (6): "
          f"{kernels6:.1f} kernels, {busy:.4f} ms device, "
          f"{wall:.4f} ms wall per frame", flush=True)

    _build.reset_launches()
    stream_g = Encoder(EncoderConfig(xl=7, yl=7), device="cuda", **CAPS).encode(
        frames, W, H, pframes_count=23, chunk_frames=48)
    torch.cuda.synchronize()
    exact("11c", NF, NF)
    if len(stream_g) != SOAK_BYTES or hashlib.sha256(stream_g).hexdigest() != SOAK_SHA256:
        raise AssertionError("11c: Encoder.encode(chunk_frames=48) through the graphs != "
                             "the soak digest")
    print(f"11c Encoder.encode(chunk_frames=48) through encode_gop_scan's graph: "
          f"{len(stream_g)} bytes, sha256 matches the 1080p soak digest, each main-path "
          f"kernel exactly once a frame", flush=True)

    cases = 0
    for w, h, q, vl, n, kind, pf, stop, groups, _ in GOLDEN_MATRIX:
        gcfg = EncoderConfig(xl=5, yl=4, vector_level=vl, q_level=q)
        clip = video(w + n, w, h, n, kind)
        want = G.encode_sequence(gcfg, SequenceConfig(w, h, pf), clip, stop_mode=stop,
                                 partial_groups=groups)
        for chunk in (1, n):
            _build.reset_launches()
            got = Encoder(gcfg, device="cuda").encode(clip, w, h, pf, stop_mode=stop,
                                                      partial_groups=groups,
                                                      chunk_frames=chunk)
            torch.cuda.synchronize()
            exact(f"11d {w}x{h} q{q} vl{vl} chunk {chunk}", n, 0 if chunk == 1 else n)
            if got != want:
                raise AssertionError(f"11d {w}x{h} q{q} vl{vl} {kind} {stop} chunk {chunk}: "
                                     f"stream != golden")
            cases += 1
    print(f"11d golden matrix through the graphs: {cases} streams ({len(GOLDEN_MATRIX)} "
          f"cases, streaming through encode_frame_device and chunked through "
          f"encode_gop_scan) byte-equal to golden.encoder.encode_sequence, each main-path "
          f"kernel exactly once a frame", flush=True)

    # phase 7's BatchEncoder streams (graph replays) against each stream
    # encoded by the eager encode_gop_scan_core
    for b in range(ns):
        st = [torch.as_tensor(np.stack([f[i] for f in chunks[b]]), device=dev) for i in range(3)]
        o = M.encode_gop_scan_core(*st, zy, zc, zc, 0, 0, 23, **kw,
                                   **M.chunk_caps(CAPS["row_cap"], CAPS["frame_cap"], W, H,
                                                  nf7)[0])
        data = sequence_start(W, H) + M.payload_bytes(o[3], int(o[4]))
        data += sequence_end(len(data))
        if bool(o[7]) or streams7[b] != data:
            raise AssertionError(f"11e: BatchEncoder stream {b} != its eager encode")
    progs = sorted({(k[0], *k[2:5 if k[0] == "gop_batch" else 4]) for k in graphs._programs
                    if k[0] in ("frame", "gop", "gop_batch") and k[1].type == "cuda"
                    and graphs._programs[k].step._graph is not None})
    print(f"11e BatchEncoder {ns} x {W}x{H} (phase 7, graph replays): each stream equals "
          f"encode_gop_scan_core of its frames; captured programs (kind, [streams,] H, W): "
          f"{progs}", flush=True)

    # streaming: one frame at a time, its payload downloaded before the next
    # (push_frame's pattern), frames on the card; eager and graph in turns
    ckw = dict(**kw, **CAPS)

    def stream_frames(fn, n=npf):
        prev, total = (zy, zc, zc), 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(n):
            ry, ru, rv, fw, fb, _ = fn(fy[k], fu[k], fv[k], *prev, 0 if k == 0 else 1, k,
                                       **ckw)
            nb = int(fb)
            total += len(M.payload_bytes(fw, nb))
            prev = (ry.clone(), ru.clone(), rv.clone())
        return (time.perf_counter() - t0) * 1e3 / n, total

    stream_frames(M.encode_frame_device, 2)
    turns = [("eager", M.encode_frame_core), ("graph", M.encode_frame_device),
             ("graph", M.encode_frame_device), ("eager", M.encode_frame_core)]
    st_ms = {"eager": [], "graph": []}
    sizes = set()
    for tag, fn in turns:
        t, nbytes_ = stream_frames(fn)
        st_ms[tag].append(t)
        sizes.add(nbytes_)
    if len(sizes) != 1:
        raise AssertionError(f"11f: streamed payload sizes differ: {sizes}")
    print(f"11f streaming, {npf} frames of {W}x{H} one at a time with the payload downloaded "
          f"(host clock, ms a frame, turns eager graph graph eager): encode_frame_core "
          f"{', '.join(f'{t:.4f}' for t in st_ms['eager'])}; encode_frame_device "
          f"{', '.join(f'{t:.4f}' for t in st_ms['graph'])}; on {smi}", flush=True)

    # ---- 12. the sharded programs: local and tail graphs, collectives between --
    starts[12] = time.perf_counter()
    import torch.distributed as dist
    from fpga_mpeg2_encoder_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
    from fpga_mpeg2_encoder_tpu_torch.parallel import spatial as S

    # (a) phase 8's 4 shards through the local and tail programs; the motion
    # wrapper is called where the local graphs are captured, not at replay
    bands = []
    _build.reset_launches()
    k_me.motion_estimate_fused = recording_fused
    try:
        shards = S.make_shards_encoder(dev, nsh, H, W, **kw, **CAPS)   # warm-ups, captures
        launches_capture = {k: v for k, v in _build.LAUNCHES.items() if v}
        prev = (zy, zc, zc)
        _build.reset_launches()
        t0 = time.perf_counter()
        sharded12 = []
        for fi in range(nf8):
            sharded12.append(tuple(t.clone() for t in shards(fy[fi], fu[fi], fv[fi], *prev,
                                                              fi, fi)))
            prev = sharded12[-1][:3]
        torch.cuda.synchronize()
        ms12a = (time.perf_counter() - t0) * 1e3 / nf8
    finally:
        k_me.motion_estimate_fused = fused
    firsts = sorted({r for halo, r in bands if halo})
    if not bands or not all(halo for halo, _ in bands) \
            or firsts != [rows8 * k for k in range(nsh)]:
        raise AssertionError(f"12a: motion kernel calls (halo, first_mb_row) {bands}")
    launches12a = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launches12a != want8:
        raise AssertionError(f"12a: launches {launches12a} under replay, expected {want8}")
    for fi in range(nf8):
        ry, ru, rv, fw, fb, ovf = sharded12[fi]
        wb, ww, recon = want_frames[fi]
        nw = (wb + 31) // 32
        if bool(ovf) or int(fb) != wb or not np.array_equal(fw[:nw].cpu().numpy(), ww):
            raise AssertionError(f"12a: frame {fi}: shard programs' payload != "
                                 f"encode_frame_core's")
        if not all(np.array_equal(a.cpu().numpy(), b) for a, b in zip((ry, ru, rv), recon)):
            raise AssertionError(f"12a: frame {fi}: shard programs' recon != "
                                 f"encode_frame_core's")
    def shard_frames(n=nf8):
        prev = (zy, zc, zc)
        for fi in range(n):
            prev = shards(fy[fi], fu[fi], fv[fi], *prev, fi, fi)[:3]

    wall12a = min(cuda_ms(shard_frames, reps=1, warmup=1) for _ in range(3)) / nf8
    for _ in range(3):               # a window without the replays' events is taken again
        ev12a = profile_events(shard_frames, 1)
        if ev12a:
            break
    else:
        raise AssertionError("12a: the profiler saw no device events of the shard programs")
    busy12a = sum(e.time_range.elapsed_us() for e in ev12a) / nf8 / 1e3
    print(f"12a shard programs: {nsh} local graphs ({W}x{H}, {rows8} macroblock rows each, "
          f"captured with the motion kernel's band form at first_mb_row {firsts}) and the "
          f"tail graph, {nf8} frames IPPP: payload and recon equal encode_frame_core on every "
          f"frame; kernels a frame under replay "
          f"{ {k: v / nf8 for k, v in launches12a.items()} } (warm-ups and captures: "
          f"{launches_capture}); {len(ev12a) / nf8:.1f} kernels, {busy12a:.4f} ms device "
          f"and {wall12a:.4f} ms wall a frame, device idle {100 * (1 - busy12a / wall12a):.1f}%"
          f" ({ms12a:.4f} ms a frame on the host clock with each frame's outputs cloned); "
          f"on {smi}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1,
                                rank=0)
        try:
            # (b) one NCCL rank: the program against the eager factory
            mesh1 = make_mesh(1, axis="slice", device="cuda")
            prog = S.make_sharded_frame_encoder(mesh1, H, W, **kw, **CAPS)
            eager = S.make_sharded_frame_encoder_core(mesh1, H, W, **kw, **CAPS)
            gop = [torch.full((), k, dtype=torch.int32, device=dev) for k in range(npf)]

            def sharded_frames(fn, n=npf):
                prev = (zy, zc, zc)
                for k in range(n):
                    out = fn(fy[k], fu[k], fv[k], *prev, gop[k], gop[k])
                    prev = out[:3]
                return out

            def per_frame(tag, streams):
                """Each kernel's launches in the program's frame: the
                subsample, F, T, A and M once a stream, the glue and P twice
                (its rows and the header rows)."""
                torch.cuda.synchronize()
                got = {k: v for k, v in _build.LAUNCHES.items() if v}
                want = {k: (2 if k in ("pack_slots", "glue") else 1) * streams
                        for k in MAIN_PATH}
                if got != want:
                    raise AssertionError(f"{tag}: launches {got} under replay, expected {want}")
                return got

            prev_p, prev_d = (zy, zc, zc), (zy, zc, zc)
            for k in range(npf):
                _build.reset_launches()
                got = prog(fy[k], fu[k], fv[k], *prev_p, gop[k], gop[k])
                launches12b = per_frame(f"12b frame {k}", 1)
                want = M.encode_frame_device(fy[k], fu[k], fv[k], *prev_d, k, k, **kw, **CAPS)
                nw = (int(want[4]) + 31) // 32
                if bool(got[5]) or bool(want[5]) or int(got[4]) != int(want[4]) \
                        or not torch.equal(got[3][:nw], want[3][:nw]) \
                        or not all(torch.equal(a, b) for a, b in zip(got[:3], want[:3])):
                    raise AssertionError(f"12b: frame {k}: the one-rank program != "
                                         f"encode_frame_device")
                prev_p, prev_d = got[:3], tuple(t.clone() for t in want[:3])
            prof12 = {}
            for tag, fn in (("program", prog), ("eager factory", eager)):
                wall_s = min(cuda_ms(lambda: sharded_frames(fn), reps=1, warmup=1)
                             for _ in range(3)) / npf
                for _ in range(3):
                    ev_s = profile_events(lambda: sharded_frames(fn), 1)
                    if ev_s:
                        break
                else:
                    raise AssertionError(f"12b: the profiler saw no device events of the "
                                         f"{tag} in 3 windows")
                busy_s = sum(e.time_range.elapsed_us() for e in ev_s) / npf / 1e3
                prof12[tag] = (len(ev_s) / npf, busy_s, wall_s)
            print(f"12b one-rank NCCL make_sharded_frame_encoder ({npf} frames of {W}x{H} "
                  f"IPPP, recon fed back): equals encode_frame_device on every frame; "
                  f"launches a frame under replay {launches12b}; "
                  + "; ".join(f"{tag}: {n:.1f} kernels, {b:.4f} ms device, {t:.4f} ms wall a "
                              f"frame, device idle {100 * (1 - b / t):.1f}%"
                              for tag, (n, b, t) in prof12.items())
                  + f"; single-device graph (11b): {busy_g:.4f} ms device, {wall_g:.4f} ms "
                    f"wall; on {smi}", flush=True)

            # (c) one rank of a 2-D mesh: 4 streams of 1080p in one block
            nb, nfc = 4, 4
            benc = S.make_sharded_batch_encoder(make_mesh2d(1, 1, device="cuda"), nb, H, W,
                                                **kw, **CAPS)
            idx = [[(k + 3 * b) % NF for b in range(nb)] for k in range(nfc)]
            prev_b = (torch.zeros((nb, H, W), dtype=torch.uint8, device=dev),
                      torch.zeros((nb, H // 2, W // 2), dtype=torch.uint8, device=dev),
                      torch.zeros((nb, H // 2, W // 2), dtype=torch.uint8, device=dev))
            prev_s = [(zy, zc, zc)] * nb
            for k in range(nfc):
                i_f = [(k + b) % 3 for b in range(nb)]
                i_t = torch.tensor(i_f, dtype=torch.int32, device=dev)
                fno = torch.full((nb,), k, dtype=torch.int32, device=dev)
                planes = (fy[idx[k]], fu[idx[k]], fv[idx[k]])
                _build.reset_launches()
                got = benc(*planes, *prev_b, i_t, fno)
                launches12c = per_frame(f"12c frame {k}", nb)
                for b in range(nb):
                    j = idx[k][b]
                    want = M.encode_frame_core(fy[j], fu[j], fv[j], *prev_s[b], i_f[b], k,
                                               **kw, **CAPS)
                    nw = (int(want[4]) + 31) // 32
                    mine = [o[b] for o in got]
                    if bool(mine[5]) or bool(want[5]) or int(mine[4]) != int(want[4]) \
                            or not torch.equal(mine[3][:nw], want[3][:nw]) \
                            or not all(torch.equal(a, c) for a, c in zip(mine[:3], want[:3])):
                        raise AssertionError(f"12c: stream {b} frame {k} != its single "
                                             f"encode")
                    prev_s[b] = want[:3]
                prev_b = got[:3]
            torch.cuda.synchronize()
            print(f"12c one-rank 2-D mesh make_sharded_batch_encoder: {nb} streams of {W}x{H} "
                  f"in one block, {nfc} frames, GOP phases differing: each stream equals "
                  f"encode_frame_core of its frames; launches a frame under replay "
                  f"{launches12c}", flush=True)
        finally:
            dist.destroy_process_group()

    # (d) the programs over NCCL across cards
    if n_cards >= 2:
        world = min(4, n_cards)
        check_ranks("12d NCCL", run_sharded_ranks(world, "nccl", nf8, program=True))
        print(f"12d make_sharded_frame_encoder (the programs) over NCCL on {world} cards: "
              f"{nf8} frames equal encode_frame_core", flush=True)
    else:
        print(f"12d the sharded programs over NCCL across cards: not run, it needs two "
              f"cards and this machine has {n_cards}", flush=True)

    starts[13] = time.perf_counter()
    print("phase seconds: " + ", ".join(f"{k} {starts[k + 1] - starts[k]:.1f}"
                                        for k in range(1, 13)), flush=True)

    kernels = []
    for kname in MAIN_PATH + OFF_PATH:
        t, err = timing[kname]
        # 5b's counts; pack_symbols has none, and the main path never calls it
        row = {"name": kname, "route": "cuda", "source": SOURCES[kname],
               "replaces": REPLACES[kname], "launches": launches_b.get(kname, 0),
               "max_abs_err": err, **t}
        if kname in timing_sd:
            row["720x576 vl2"] = timing_sd[kname]
        if kname in REDESIGNED:
            row["redesigned"] = REDESIGNED[kname]
        if kname in XLA_STAGES:
            row["note"] = (f"replaces XLA code of the JAX package's jitted frame step "
                           f"({XLA_STAGES[kname]}), not a Pallas kernel")
        if kname == "pack_symbols":
            row["note"] = ("wrapper over pack_slots: forms the slots and launches the "
                           "pack_slots kernel, no kernel of its own")
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
