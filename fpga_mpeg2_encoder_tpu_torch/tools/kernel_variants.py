"""Time design variants of the acsym and pack_slots kernels on a CUDA card.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/kernel_variants.py [--reps 20]

Each variant is the kernel source with one or two lines changed (the
blocking: macroblocks per block, threads per tile; or pack_slots' fences).  Every variant is built
with nvcc into its own library under the package's git-ignored build/, run on
the operands of one 1920x1152 P-frame of bench.py content (the main path's
shapes), held to the plain version (exact), and timed by torch.profiler's
device time of its kernel.  The variants run in turns, the first twice, so
the spread between its two readings shows the noise.  Prints one line per
reading and the card's nvidia-smi name and power limit.
"""
import argparse
import ctypes
import os
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
WORK = os.path.join(PKG, "build", "variants")


def _pack(threads, spt, min_blocks=None):
    """pack.cu with `threads` threads a block and `spt` slots a thread, and
    registers capped so that `min_blocks` blocks fit on an SM."""
    name = f"tile {threads * spt}: {threads} threads x {spt} slots"
    subs = [("constexpr int PACK_THREADS = 512;", f"constexpr int PACK_THREADS = {threads};"),
            ("constexpr int SPT = 8;", f"constexpr int SPT = {spt};")]
    if min_blocks:
        name += f", {min_blocks} blocks/SM"
        subs.append(("__launch_bounds__(PACK_THREADS) pack_slots_kernel",
                     f"__launch_bounds__(PACK_THREADS, {min_blocks}) pack_slots_kernel"))
    return name, subs


def _fenced(name, fence):
    """pack.cu with ``fence`` before each block's count of blocks done and
    before the last block's clear, in place of its wait on each word."""
    return f"tile 4096, {name}", [
        ("      s_last = atomicAdd(lb.ctl", f"      {fence}\n      s_last = atomicAdd(lb.ctl"),
        ("      while ((st[i] & 3) != ST_INCL) {}\n", f"      {fence}\n")]


# source -> [(name, [(text, replacement)])]; the first is the source as it is
VARIANTS = {
    "acsym.cu": [
        ("4 MB/block (384 threads)", []),
        ("2 MB/block (192 threads)", [("constexpr int MBB = 4;", "constexpr int MBB = 2;")]),
        ("8 MB/block (768 threads)", [("constexpr int MBB = 4;", "constexpr int MBB = 8;")]),
    ],
    "pack.cu": [("tile 4096: 512 threads x 8 slots", [])]
    + [_fenced("fence.sc (__threadfence)", "__threadfence();"),
       _fenced("fence.acq_rel", 'asm volatile("fence.acq_rel.gpu;" ::: "memory");')]
    + [_pack(*v) for v in ((256, 16), (256, 16, 8), (256, 12), (192, 16), (128, 16),
                           (1024, 4))],
}
SYMBOL = {"acsym.cu": "acsym_kernel", "pack.cu": "pack_slots_kernel"}


def build(source, k, name, subs):
    """Compile the variant into its own library; returns (path, ptxas lines)."""
    sys.path.insert(0, ROOT)
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
    from fpga_mpeg2_encoder_tpu_torch.tools.mutants import substituted
    src = substituted(source, subs, name)
    tag = f"{source.split('.')[0]}-{k}"
    os.makedirs(WORK, exist_ok=True)
    cu, lib = os.path.join(WORK, tag + ".cu"), os.path.join(WORK, tag + ".so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", lib, cu],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{res.stderr}")
    info = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "bytes smem" in ln]
    return lib, info


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20, help="launches per profiled window")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    sys.path.insert(0, ROOT)
    from bench import make_frames
    from chip_smoke import device_ms
    from fpga_mpeg2_encoder_tpu_torch.ops import bitpack, colorspace, entropy
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import me as k_me
    from fpga_mpeg2_encoder_tpu_torch.ops.kernels import transform as k_tf

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    f0, f1 = make_frames(1920, 1152, 2)
    y0, u0, v0 = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f0))
    y, u, v = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f1))
    mr = k_me.estimate_and_predict_planes(y, u, v, y0, u0, v0, False, 6, 3)
    qzig = k_tf.transform_recon(y, u, v, mr.pred_y, mr.pred_u, mr.pred_v, mr.inter, 2)[0]
    zmod, small = entropy.ac_inputs(qzig, mr.inter, mr.mvx, mr.mvy, 1, 2)
    slots = entropy.symbolize_frame(qzig, mr.inter, mr.mvx, mr.mvy, 1, 1, 2)
    nby, nbx = mr.inter.shape
    r, s = slots.shape
    cap = 4096
    want_grid = entropy.ac_slot_grid(zmod, small)
    want_pack = bitpack.pack_slots(slots, cap)
    lookback = torch.zeros(2 + 2 * 65536, dtype=torch.int64, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    print(f"card: {smi}; 1920x1152 P-frame: zmod {tuple(zmod.shape)}, slots {tuple(slots.shape)}",
          flush=True)

    runs = []
    for source, variants in VARIANTS.items():
        built = [(name, *build(source, k, name, subs))
                 for k, (name, subs) in enumerate(variants)]
        runs += [(source, *b) for b in built] + [(source, *built[0])]
    for source, name, lib_path, info in runs:
        lib = ctypes.CDLL(lib_path)
        stream = lambda: torch.cuda.current_stream(dev).cuda_stream
        if source == "acsym.cu":
            fn = lib.mpeg2_acsym
            fn.argtypes, fn.restype = [P, P, P, I, I, P], I
            out = torch.empty_like(small)
            call = lambda: fn(zmod.data_ptr(), small.data_ptr(), out.data_ptr(), nby, nbx,
                              stream())
            check = lambda: torch.equal(out, want_grid)
        else:
            fn = lib.mpeg2_pack_slots
            fn.argtypes, fn.restype = [P] * 5 + [I] * 6 + [P], I
            words = torch.empty((r, cap), dtype=torch.int64, device=dev)
            bits = torch.empty((r,), dtype=torch.int64, device=dev)
            # the public pack_slots' form: one operand, rows zero up to cap
            call = lambda: fn(slots.data_ptr(), slots.data_ptr(), words.data_ptr(),
                              bits.data_ptr(), lookback.data_ptr(), 0, r, s, cap, 1, 65536,
                              stream())
            check = lambda: torch.equal(words, want_pack[0]) and torch.equal(bits, want_pack[1])
        if call() != 0:
            raise SystemExit(f"{source} {name}: launch failed")
        torch.cuda.synchronize()
        if not check():
            raise SystemExit(f"{source} {name}: differs from the plain version")
        ms = device_ms(call, SYMBOL[source], reps=args.reps)
        print(f"{source:9s} {name:38s} exact  {ms:.4f} ms device  | {'; '.join(info)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
