#!/usr/bin/env python3
"""Mutation check of csrc/me.cu on a CUDA card.

    python3 fpga_mpeg2_encoder_tpu_torch/tools/me_mutants.py [--jobs 4]

Each mutant breaks one exactness trap of the motion-estimation kernels with
a one-line change of me.cu.  It runs in its own copy of the port package and
of tests/test_torch_cuda.py under the package's git-ignored
build/mutants/, which builds its own kernels, and there the card's
motion-estimation tests (``pytest --noconftest -x -k me_``) must fail.  The
unchanged copy runs first and must pass.  Prints one line per mutant; exits
1 if the baseline fails or a mutant is missed.
"""
import argparse
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
WORK = os.path.join(PKG, "build", "mutants")

# (name, text of me.cu, its mutant); each text occurs once in me.cu
MUTANTS = [
    ("overflow_mask", "const bool invalid = s > 4095 ||", "const bool invalid = s > 8191 ||"),
    ("fullpel_edge_top", "(edge_t && dy < 0) ||", "false ||"),
    ("edge_top_global", "const bool edge_t = first_mb_row + by == 0;",
     "const bool edge_t = by == 0;"),
    ("edge_bottom_global", "const bool edge_b = first_mb_row + by == total_mb_rows - 1;",
     "const bool edge_b = by == nby - 1;"),
    ("tie_break", "(255u - (unsigned)tid)", "(unsigned)tid"),
    ("all_invalid_centre", "kmin >= BIG ? yr * n + yr :", "kmin >= BIG ? 0 :"),
    ("rounding_line", "else if (hy == 0) v = (1 + a + b) >> 1;",
     "else if (hy == 0) v = (a + b) >> 1;"),
    ("rounding_diagonal", "else v = (1 + a + b + cc + d) >> 2;", "else v = (a + b + cc + d) >> 2;"),
    ("halfpel_edge_left", "bad = bad || edge_l || mvx_full == -yr;", "bad = bad || mvx_full == -yr;"),
    ("halfpel_edge_bottom", "bad = bad || edge_b || mvy_full == yr;", "bad = bad || mvy_full == yr;"),
    ("halfpel_range_left", "bad = bad || edge_l || mvx_full == -yr;", "bad = bad || edge_l;"),
    ("halfpel_range_right", "bad = bad || edge_r || mvx_full == yr;", "bad = bad || edge_r;"),
    ("halfpel_range_top", "bad = bad || edge_t || mvy_full == -yr;", "bad = bad || edge_t;"),
    ("halfpel_range_bottom", "bad = bad || edge_b || mvy_full == yr;", "bad = bad || edge_b;"),
    # Dropping the half-pel `s > 4095` has no effect, so it has no mutant:
    # the intra value, at most 0xFFF, beats every value above 4095.
    ("substitute", "(bad || s > 4095) ? 0x1000 : s", "(bad || s > 4095) ? 0xFFF : s"),
    ("intra_wrap", "(pixsum + sh.hsum[9]) & 0xFFFF", "(pixsum + sh.hsum[9]) & 0x1FFFF"),
    ("intra_clip", "vals[9] = acc < 4096 ? acc : 0xFFF;", "vals[9] = acc < 4096 ? acc : 0x1000;"),
    ("tournament_89", "(w89 <= x0123 && w89 <= x4567)", "(w89 < x0123 && w89 <= x4567)"),
    ("tournament_pair", "if (vals[1] < w01)", "if (vals[1] <= w01)"),
    ("mv_when_intra", "return {inter, mvx_full * 2 + hx_sel,",
     "return {inter, inter ? mvx_full * 2 + hx_sel : 0,"),
    ("chroma_shift", "bx * 8 + (mvx >> 2) + c", "bx * 8 + (mvx / 4) + c"),
    ("chroma_half_flag", "hx = (mvx >> 1) & 1;", "hx = (mvx / 2) & 1;"),
    ("chroma_rounding", "if (hy && hx) v = (1 + a + b + cc + d) >> 2;",
     "if (hy && hx) v = (a + b + cc + d) >> 2;"),
]


def run(name, old=None, new=None):
    """Copy the package and the card tests, apply the mutant, run the tests:
    (pytest's exit code, its last line)."""
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(d, "fpga_mpeg2_encoder_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    os.makedirs(os.path.join(d, "tests"))
    shutil.copy(os.path.join(ROOT, "tests", "test_torch_cuda.py"), os.path.join(d, "tests"))
    if old is not None:
        path = os.path.join(d, "fpga_mpeg2_encoder_tpu_torch", "csrc", "me.cu")
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} occurs {src.count(old)} times in me.cu")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         "-x", "-k", "me_", "tests/test_torch_cuda.py"],
        cwd=d, env={**os.environ, "PYTHONPATH": d}, capture_output=True, text=True,
        timeout=900)
    lines = res.stdout.strip().splitlines()
    return res.returncode, lines[-1] if lines else res.stderr.strip()[-200:]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=4, help="mutants run at once")
    args = ap.parse_args()
    rc, last = run("baseline")
    print(f"baseline: pytest rc={rc} {last}", flush=True)
    if rc != 0:
        return 1
    missed = []
    with ThreadPoolExecutor(args.jobs) as pool:
        futs = [(m[0], pool.submit(run, *m)) for m in MUTANTS]
        for name, fut in futs:
            rc, last = fut.result()
            caught = rc == 1 and "failed" in last
            if not caught:
                missed.append(name)
            print(f"mutant {name}: pytest rc={rc} {'caught' if caught else 'MISSED'} | {last}",
                  flush=True)
    print(f"{len(MUTANTS) - len(missed)} of {len(MUTANTS)} mutants caught"
          + (f"; missed: {', '.join(missed)}" if missed else ""))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
