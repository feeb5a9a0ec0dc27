"""Run one cell of the benchmark of gdpt_tpu_torch on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the compared numbers as the last
lines of standard error and one JSON object as the last line of standard
output: correct, attempted (frames), failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer ones with --trace 1),
device, with --trace 1 breakdown, and last compared (each compared
number with its limit). Exits 2 without a result where there is no CUDA
card or fewer than the cell asks for, and 3 where the run loaded JAX or
the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import session, spec

    cell = spec.Cell(spec.load_spec(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); found {n}",
              file=sys.stderr)
        return 2
    session.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
