#!/usr/bin/env python3
"""Device time of each stage of one P-frame, on a CUDA card.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/profile_stages.py [--size 1920x1152] [--reps 8]

The stages of the frame loop's step (models/encoder.encode_gop_scan_core's
body: encode_frame_core with the merge in its append form), each run alone
under torch.profiler on inputs that the previous stages computed beforehand:
subsample (the subsample kernel, D); motion (the fused motion kernel, F);
transform (T); the symbol glue (the glue kernel, G, with the header rows,
and their concatenation with the slot grid); acsym (A); pack_slots (P);
merge+append (M).  Then the whole step
under the profiler.  Each rep is another frame of bench.py's content (a
P-frame against the recon of the frame before it, encoded as an I-frame),
so no two reps see the same input.  For each stage: the device time of its
kernels and their count a call (all kernels; "ours" counts the port's own
from ops/kernels/_build.LAUNCHES), the three kernels that take the most of
it, and the host wall time a call without the profiler (synchronised).
Prints one JSON line a stage and a last line with the sum of the stages
against the whole step; exits 1 if they differ by more than 10%.

``--device cpu`` runs the same stages on the CPU (the plain versions): there
is no device time, only the host's.
"""
import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):      # run as a script from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

from fpga_mpeg2_encoder_tpu_torch import EncoderConfig  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import acsym as k_acsym  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import colorspace as k_cs  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import glue as k_glue  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import me as k_me  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import pack as k_pack  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import transform as k_tf  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.tools import common  # noqa: E402

STAGES = ("subsample", "motion", "transform", "symbol glue", "acsym", "pack_slots",
          "merge+append")
WHOLE = "whole step"
CAPS = dict(row_cap=4096, frame_cap=262144)


def parse_size(s: str):
    w, h = (int(x) for x in s.lower().split("x"))
    return w, h


def stage_calls(dev, w, h, streams=1, reps=8, cfg=EncoderConfig(xl=7, yl=7)):
    """{stage: [call, ...]}: ``streams * reps`` calls of each stage (and of
    the whole step), each on another P-frame of bench.py's content, its
    inputs computed here by the stages before it."""
    yr, ur, q = cfg.yr, cfg.ur, cfg.q_level
    pool = common.bench_content().make_frames(w, h, streams + reps + 1)
    seq_w = torch.zeros(CAPS["frame_cap"] * 2 + 1, dtype=torch.int64, device=dev)
    seq_b = torch.zeros((), dtype=torch.int64, device=dev)
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    calls = {s: [] for s in STAGES + (WHOLE,)}
    for b in range(streams):
        for r in range(reps):
            k = b + r + 1                  # stream b's frame r: pool[k] after pool[k - 1]
            cur = tuple(torch.as_tensor(p, device=dev) for p in pool[k])
            before = tuple(torch.as_tensor(p, device=dev) for p in pool[k - 1])
            prev = M.encode_frame_core(*before, zy, zc, zc, 0, k - 1, yr=yr, ur=ur,
                                       q_level=q, **CAPS)[:3]
            y, u, v = k_cs.subsample_420(*cur)
            mr = k_me.estimate_and_predict_planes(y, u, v, *prev, False, yr, ur)
            targs = (y, u, v, mr.pred_y, mr.pred_u, mr.pred_v, mr.inter, q)
            qzig = k_tf.transform_recon(*targs)[0]
            eargs = (qzig, mr.inter, mr.mvx, mr.mvy, 1, q)
            ac = k_glue.symbol_glue(*eargs[:5], k, q)[:2]
            grid = k_acsym.ac_slot_grid(*ac)
            slots = torch.cat([k_glue.header_rows(1, k, grid.shape[1], dev), grid])
            rw, rb, _ = k_pack.pack_slots(slots, CAPS["row_cap"])

            def glue(e=eargs, g=grid, fno=k):
                z, small, hdr = k_glue.symbol_glue(*e[:5], fno, q, 0, g.shape[1])
                return z, small, torch.cat([hdr, g])

            def whole(c=cur, p=prev, fno=k):
                ry, ru, rv, s = M.symbolize_frame_core(*c, *p, 1, fno, yr=yr, ur=ur,
                                                       q_level=q)
                words, bits, ovf = k_pack.pack_slots(s, CAPS["row_cap"])
                return (ry, ru, rv, ovf,
                        *k_pack.merge_append(seq_w, seq_b, words, bits, CAPS["frame_cap"]))

            calls["subsample"].append(lambda c=cur: k_cs.subsample_420(*c))
            calls["motion"].append(lambda a=(y, u, v, *prev): k_me.estimate_and_predict_planes(
                *a, False, yr, ur))
            calls["transform"].append(lambda a=targs: k_tf.transform_recon(*a))
            calls["symbol glue"].append(glue)
            calls["acsym"].append(lambda a=ac: k_acsym.ac_slot_grid(*a))
            calls["pack_slots"].append(lambda s=slots: k_pack.pack_slots(s, CAPS["row_cap"]))
            calls["merge+append"].append(lambda a=(rw, rb): k_pack.merge_append(
                seq_w, seq_b, *a, CAPS["frame_cap"]))
            calls[WHOLE].append(whole)
    common.sync(dev)
    return calls


def profile(dev, calls, tries=3) -> dict:
    """Device time and kernels a call of ``calls`` (each called once, in a
    row, under torch.profiler), the port's own launches a call, the top
    three kernels, and the host wall time a call without the profiler."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    n = len(calls)
    calls[0]()                                       # warm-up
    common.sync(dev)
    t0 = time.perf_counter()
    for c in calls:
        c()
    common.sync(dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    if dev.type != "cuda":
        return {"device_ms": None, "kernels": None, "ours": None, "top": None,
                "host_ms": host_ms}
    for _ in range(tries):
        _build.reset_launches()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for c in calls:
                c()
            common.sync(dev)
        ours = {k: v / n for k, v in _build.LAUNCHES.items() if v}
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            break
    else:
        raise AssertionError(f"the profiler saw no device time in {tries} windows")
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"device_ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3 / n,
            "kernels": len(ev) / n, "ours": ours,
            "top": [[name[:80], ms / n] for name, ms in top], "host_ms": host_ms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--size", default="1920x1152")
    p.add_argument("--reps", type=int, default=8)
    args = p.parse_args(argv)
    dev = M.resolve_device(args.device)
    w, h = parse_size(args.size)
    card = common.card(dev)
    calls = stage_calls(dev, w, h, reps=args.reps)
    rows = {}
    for stage in STAGES + (WHOLE,):
        rows[stage] = profile(dev, calls[stage])
        print(json.dumps({"stage": stage, "size": f"{w}x{h}", "reps": args.reps,
                          **rows[stage], "device": card}), flush=True)
    if dev.type != "cuda":
        print(json.dumps({"stages_device_ms": None, "whole_device_ms": None,
                          "device": card}))
        return 0
    total = sum(rows[s]["device_ms"] for s in STAGES)
    whole = rows[WHOLE]["device_ms"]
    ratio = total / whole
    print(json.dumps({"stages_device_ms": total, "whole_device_ms": whole,
                      "stages_over_whole": ratio,
                      "stages_kernels": sum(rows[s]["kernels"] for s in STAGES),
                      "whole_kernels": rows[WHOLE]["kernels"], "device": card}))
    return 0 if abs(ratio - 1) <= 0.10 else 1


if __name__ == "__main__":
    raise SystemExit(main())
