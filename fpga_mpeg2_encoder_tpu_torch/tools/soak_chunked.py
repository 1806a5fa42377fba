#!/usr/bin/env python3
"""GOP-scale soak of the chunked path, on a CUDA card (or ``--device cpu``).

    SOAK_NF=96 SOAK_CHUNKS=48,32 python3 fpga_mpeg2_encoder_tpu_torch/tools/soak_chunked.py

Encodes a long sequence of bench.py's content through the public chunked
API (``Encoder.encode(chunk_frames=...)``) once per chunking, chunk
boundaries landing both on and off GOP edges; the streams must be
byte-identical.  Then a structural census of the stream (sequence header,
one picture start code a frame, one GOP header a GOP, the end code, zero pad
to 32 bytes) and, with SOAK_VALIDATE=1, the ISO validator (golden/validator,
host NumPy).  Prints each chunking's bytes, SHA-256 and host-wall MPixels/s
(upload and download included), then the digest.  The JAX package's soak of
96 frames at 1920x1152 gives 16110848 bytes, sha256 d0f0b0ec...ddfa1d8.

Environment: SOAK_W/H (1920x1152), SOAK_NF (384), SOAK_CHUNKS ("96,64"),
SOAK_PFRAMES (23), SOAK_VALIDATE ("" or "1").
"""
import argparse
import hashlib
import os
import sys
import time

if __package__ in (None, ""):      # run as a script from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.golden.validator import validate_sequence  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.models.encoder import resolve_device  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build  # noqa: E402
from fpga_mpeg2_encoder_tpu_torch.tools import common  # noqa: E402


def census(stream: bytes, nf: int, pframes: int) -> None:
    """The container invariants the soak is for; raises on a breach."""
    if stream[:4] != bytes.fromhex("000001B3"):
        raise AssertionError("no sequence header at the start")
    npics = stream.count(bytes.fromhex("00000100"))
    if npics != nf:
        raise AssertionError(f"picture start codes {npics} != {nf}")
    end = stream.rfind(bytes.fromhex("000001B7"))
    if end < 0 or set(stream[end + 4:]) - {0} or len(stream) % 32:
        raise AssertionError("no sequence end code, or not zero-padded to 32 bytes")
    ngop = stream.count(bytes.fromhex("000001B8"))
    if ngop != (nf + pframes) // (pframes + 1):
        raise AssertionError(f"GOP headers {ngop} != {(nf + pframes) // (pframes + 1)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    env = os.environ
    w, h = int(env.get("SOAK_W", "1920")), int(env.get("SOAK_H", "1152"))
    nf = int(env.get("SOAK_NF", "384"))
    chunks = tuple(int(c) for c in env.get("SOAK_CHUNKS", "96,64").split(","))
    pframes = int(env.get("SOAK_PFRAMES", "23"))
    dev = resolve_device(args.device)
    print(f"device: {common.card(dev)}  {w}x{h} NF={nf} chunks={chunks} "
          f"pframes={pframes}", flush=True)
    frames = common.bench_content().make_frames(w, h, nf)
    xl = max(4, (w - 1).bit_length() - 4)     # 16 << xl >= w
    yl = max(4, (h - 1).bit_length() - 4)

    streams = []
    for ch in chunks:
        enc = Encoder(EncoderConfig(xl=xl, yl=yl), row_cap=4096, frame_cap=262144,
                      device=dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        b = enc.encode(frames, w, h, pframes_count=pframes, chunk_frames=ch)
        dt = time.perf_counter() - t0
        dig = hashlib.sha256(b).hexdigest()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        print(f"chunk={ch:4d}: {len(b)} bytes  sha256={dig}  "
              f"{w * h * nf / dt / 1e6:.1f} MPixels/s host wall (upload and download "
              f"included)  launches {launches}", flush=True)
        streams.append((ch, b, dig))

    ch0, b0, d0 = streams[0]
    for ch, b, _ in streams[1:]:
        if b != b0:
            raise AssertionError(f"chunk={ch} diverges from chunk={ch0}")
    print(f"byte identity across chunkings: OK ({len(streams)} encodings)")
    census(b0, nf, pframes)
    print("structure: OK")
    if env.get("SOAK_VALIDATE", "") == "1":
        v = validate_sequence(b0, expected_frames=nf)
        print(f"ISO validation: {len(v.pictures)} pictures OK")
    print(f"SOAK OK  bytes={len(b0)}  digest={d0}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
