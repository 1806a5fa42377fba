"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  It makes
the cell's content from the seed, builds and warms the program (set-up),
drives the cell's traffic for ``--seconds`` seconds, checks a seeded sample
of what the window produced against the plain reference, and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from the
profiler), ``device`` and, last, ``checks`` (each compared number with its
limit, which also end standard error).  A traffic mix that names
``host_threads`` runs torch's CPU work on that many threads.  With no card
it exits with 2 and prints no result; where the process holds JAX or the
JAX package once the window has closed, it names them and exits with 3,
with no result.

``--program control`` puts the reference at the next coarser quantiser in
the port's place, and ``--program fault:<name>`` plants one fault in the
port (programs.py): the check has to find both not correct.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))
# the reference package beside the port, and what it runs on: none of it may
# load in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "fpga_mpeg2_encoder_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among the module names ``names``
    (``sys.modules`` where none are given), compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--program", default="port",
                   help="port, control, or fault:<stale_state|altered_answer>")
    args = p.parse_args(argv)

    import torch

    import harness
    import programs

    w = harness.workload(harness.benchmark(), args.workload)
    chips = w["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.program == "port":
        program = programs.port()
    elif args.program == "control":
        program = programs.control()
    elif args.program.startswith("fault:"):
        program = programs.fault(args.program.split(":", 1)[1])
    else:
        p.error(f"unknown --program {args.program!r}")
    threads = harness.load_json("traffic", w["traffic"]).get("host_threads")
    if threads:
        torch.set_num_threads(threads)
    print(f"run.py: imports and the card's look {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", program, T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
