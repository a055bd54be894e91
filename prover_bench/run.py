"""Run one cell of the benchmark on the card this process is started on.

    python3 prover_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output and each number the check compared beside its limit as the
last lines of standard error.  Exits 2, printing no result, when torch
sees fewer CUDA devices than the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this script's directory
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from prover_bench import harness

    return harness.main(args, T0, ROOT)


if __name__ == "__main__":
    sys.exit(main())
