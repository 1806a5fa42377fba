"""CLI: decode an .m2v elementary stream (the port's copy of the conformance decoder).

The reference verifies its streams with external players (README.md:350-353);
this tool is the in-repo equivalent - it parses the stream, reconstructs every
frame, and optionally writes the 4:2:0 planes and/or compares PSNR against a
source YUV 4:4:4 file.

    python -m fpga_mpeg2_encoder_tpu_torch.cli.decode --input out.m2v \\
        [--ref src.yuv] [--out-yuv recon.yuv420] [--validate]

``--validate`` additionally runs the INDEPENDENT ISO 13818-2 validator
(golden/validator.py: full field-by-field syntax checks + spec-formula
decode sharing no reconstruction code with the encoder) and reports its
agreement with the conformance decode.  Decoding is NumPy on the host, so
this command takes no device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..golden import decoder as D
from ..golden.encoder import subsample_420
from ..utils import yuv
from ..utils.logging import psnr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fpga_mpeg2_encoder_tpu_torch.cli.decode")
    p.add_argument("--input", required=True, help=".m2v elementary stream")
    p.add_argument("--ref", help="source YUV 4:4:4 file for PSNR")
    p.add_argument("--out-yuv", help="write decoded 4:2:0 planes (Y,U,V per frame)")
    p.add_argument("--validate", action="store_true",
                   help="run the independent ISO 13818-2 validator as well")
    args = p.parse_args(argv)

    data = open(args.input, "rb").read()
    seq = D.decode_sequence(data)
    info = {"width": seq.width, "height": seq.height,
            "frames": len(seq.pictures),
            "types": "".join("IPB"[p.coding_type - 1] for p in seq.pictures)}

    if args.validate:
        from ..golden.validator import ValidationError, validate_sequence
        try:
            val = validate_sequence(data, expected_frames=len(seq.pictures))
            recon = [(pic.y, pic.u, pic.v) for pic in seq.pictures]
            info["validator"] = "pass"
            info["validator_psnr_y_vs_recon"] = round(val.psnr_vs(recon, 0), 2)
            info["gops"] = len(val.gop_timecodes)
        except ValidationError as e:
            info["validator"] = f"FAIL: {e}"

    if args.ref:
        refs = yuv.read_all(args.ref, seq.width, seq.height)
        ps = []
        for pic, ref in zip(seq.pictures, refs):
            y420, _, _ = subsample_420(*ref)
            ps.append(psnr(pic.y, y420))
        info["psnr_y_mean"] = round(float(np.mean(ps)), 2)
        info["psnr_y_min"] = round(float(np.min(ps)), 2)

    if args.out_yuv:
        with open(args.out_yuv, "wb") as f:
            for pic in seq.pictures:
                f.write(pic.y.tobytes())
                f.write(pic.u.tobytes())
                f.write(pic.v.tobytes())

    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    sys.exit(main())
