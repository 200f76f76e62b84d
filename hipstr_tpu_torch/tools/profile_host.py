"""Host-side cProfile of the port's end-to-end run (the bench's shallow
workload).

    python -m hipstr_tpu_torch.tools.profile_host [--loci 100] [--reads 20]
        [--sort tottime] [--device cuda|cpu] [--out PATH]

Counterpart of tools/profile_host.py.  Writes the bench's dataset, runs it
once in-process to warm up (kernels built, CUDA context up), then once
more under cProfile (`hipstr_tpu_torch.bench.run_e2e`, --host-workers 1),
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
        run_e2e(tmp, device)                           # warm-up
        prof = cProfile.Profile()
        prof.enable()
        dt, counters, times = run_e2e(tmp, device)
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
