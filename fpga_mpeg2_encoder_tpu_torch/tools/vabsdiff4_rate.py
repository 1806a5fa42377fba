#!/usr/bin/env python3
"""Measure the rate of VABSDIFF4, the motion search's byte-SIMD
absolute-difference instruction, on a CUDA card.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/vabsdiff4_rate.py

Builds vabsdiff4_rate.cu with nvcc into the package's git-ignored build/,
checks in its SASS that the loop is VABSDIFF4, and runs one block of 1024
threads per SM, each thread 8 independent chains of the instruction.
Prints, per SM and per clock, the lanes' instructions that each block's own
clock (clock64) saw, and the same from CUDA events at the card's maximum SM
clock, beside the 64 INT32 lanes per clock that the Hopper SM has.  Each
instruction does four absolute-difference adds.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build  # noqa: E402

THREADS, ITERS = 1024, 1 << 14


def main():
    if not torch.cuda.is_available():
        raise SystemExit("vabsdiff4_rate: no CUDA device")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, "libvabsdiff4_rate.so")
    subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(HERE, "vabsdiff4_rate.cu")], check=True,
                   capture_output=True)
    ops = _build.sass(lib, "vabsdiff4_loop")
    n_vabs = sum(op.split()[0].startswith("VABSDIFF4") for op in ops)
    if n_vabs == 0:
        raise AssertionError("the loop holds no VABSDIFF4")
    fn = ctypes.CDLL(lib).vabsdiff4_rate
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    clock_mhz = float(smi.split(",")[-1].split()[0])
    out = torch.empty(sms * THREADS, dtype=torch.int32, device=dev)
    cycles = torch.empty(sms, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if fn(out.data_ptr(), cycles.data_ptr(), sms, THREADS, ITERS, stream):
            raise RuntimeError("vabsdiff4_rate: launch failed")

    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    lane_ops = THREADS * ITERS * 8                      # per block
    per_clock = sorted((lane_ops / cycles.cpu().double()).tolist())
    res = {"card": smi, "sms": sms, "vabsdiff4_in_loop_sass": n_vabs,
           "sass_instructions": len(ops),
           "per_sm_per_clock_clock64": {"min": per_clock[0],
                                        "median": per_clock[len(per_clock) // 2],
                                        "max": per_clock[-1]},
           "per_sm_per_clock_events_at_max_clock":
               lane_ops * sms / (ms * 1e-3) / sms / (clock_mhz * 1e6),
           "ms": ms, "int32_lanes_per_sm_per_clock": 64}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
