"""Host-side cProfile of the port's end-to-end run (the bench's shallow
workload).

    python -m hipstr_tpu_torch.tools.profile_host [--loci 100] [--reads 20]
        [--sort tottime] [--device cuda|cpu] [--out PATH]

Counterpart of tools/profile_host.py.  Writes the bench's dataset, runs it
once in-process to warm up (kernels built, CUDA context up), waits for the
warm-up's helper threads to end, then runs once more under cProfile
(`hipstr_tpu_torch.bench.run_e2e`, --host-workers 1),
and prints the run's loci/s, its timers and the top entries by `--sort`.
The waits for the card show up under the executor's fetch frames
(`executor._fetch`, the tensors' `.cpu()`); the rest is host Python.
`--out` also writes the profile (pstats format).
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import tempfile
import threading

from ..bench import run_e2e, write_dataset
from ..device import resolve

TOP = 35      # entries printed


def main(argv=None) -> pstats.Stats:
    ap = argparse.ArgumentParser(
        prog="python -m hipstr_tpu_torch.tools.profile_host",
        description="cProfile of the port's in-process batched run.")
    ap.add_argument("--loci", type=int, default=100)
    ap.add_argument("--reads", type=int, default=20)
    ap.add_argument("--sort", default="tottime")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="also write the profile here")
    args = ap.parse_args(argv)
    device, _ = resolve(args.device)
    with tempfile.TemporaryDirectory(prefix="hipstr_torch_prof_") as tmp:
        write_dataset(tmp, args.loci, args.reads)
        before = set(threading.enumerate())
        run_e2e(tmp, device)                           # warm-up
        # cProfile keeps one call stack for every thread (Python 3.12
        # profiles them all): a helper thread of the warm-up (run_batched
        # shuts its pools down without waiting) that returns from frames it
        # entered before enable() pops the profiled run's frames, whose own
        # returns then find the stack empty and go uncounted, so
        # run_batched and its callers drop out of the stats
        for thread in set(threading.enumerate()) - before:
            thread.join()
        prof = cProfile.Profile()
        prof.enable()
        try:
            dt, counters, times = run_e2e(tmp, device)
        finally:
            prof.disable()
    times.pop("_run_stats", None)
    print(f"e2e: {args.loci / dt:.2f} loci/s ({1000 * dt / args.loci:.2f} "
          f"ms/locus) on {device}, success={counters.genotype_success} "
          f"fail={counters.genotype_fail}, timers: {times}")
    if args.out:
        prof.dump_stats(args.out)
    stats = pstats.Stats(prof)
    stats.sort_stats(args.sort).print_stats(TOP)
    return stats


if __name__ == "__main__":
    main()
