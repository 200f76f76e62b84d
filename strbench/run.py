"""The benchmark's command: one run of one cell.

    python3 -m strbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (hipstr_tpu_torch) and
one card.  It prints the numbers compared beside their limits as the last
lines of standard error and one JSON object as the last line of standard
output, and exits 0; without the program, without a card, or with JAX
loaded once the window has closed, it prints no result and exits non-zero.
Importing this module does nothing: the pool's spawned workers import it
as their main module.
"""

from __future__ import annotations

import argparse
import sys


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m strbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from strbench import harness
    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
