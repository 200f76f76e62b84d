"""Chromosome-scale soak of the port: BASELINE config 4 (10,000 loci x 20
samples x 30 reads, phased SNPs on every locus, one process).

    python -m hipstr_tpu_torch.tools.soak [n_loci] [n_samples] [reads]
        [outdir] [--device cuda|cpu] [--em] [--host-workers N]
        [--window-s 20] [--band 1000]

Counterpart of tools/soak.py.  `generate` writes sim.bam, sim.fa,
regions.bed and snps.vcf, byte for byte those of the JAX soak, one locus
of reads in memory at a time; an existing dataset of the same size in
`outdir` (default build/soak under the repository) is reused.  `run`
genotypes it with the production batched executor on an explicit device
(each dispatch sharded over every visible card of it), the uncompressed
snps.vcf passed as PipelineOptions.snp_vcf, the default stutter model and
float32, as the JAX soak does; `--em` drops the model (each locus's model
is learned), `--host-workers N` (N > 1) runs the host worker pool; `run`
also takes the dtype, a locus cap and `batch_size` 0 (the sequential
path).  A sampler thread reads the loci settled in BED order
(`pipeline.loci_done`): every `window_s` seconds it closes a throughput
window, and every `band` loci a band (loci/s, its slowest and fastest
window, the process's RSS and max RSS, the allocated and peak memory of
the fullest card).  Prints the band table, then one JSON line: loci,
success, fail, wall, loci/s, the bands, max RSS, peak device MiB, the
dispatches and card-shards, the K1/K2 launches and their shape histogram,
the device (card name and power limit, `cards`, host CPU).  A pooled run
spawns its workers: call `run` from under a `__main__` guard.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import multiprocessing as mp
import os
import resource
import threading
import time

import torch

from .. import kernels
from ..bench import (DEFAULT_MODEL, device_info, max_rss_mb,
                     peak_device_mib, reset_peak_device, synchronize)
from ..device import local_devices, resolve
from ..io.bam import BamWriter
from ..io.fasta import write_fasta
from ..models.stutter import StutterModel
from ..pipeline.processor import GenotyperPipeline, Logger, PipelineOptions
from ..utils.simdata import SOAK_FLANK, soak_locus, soak_params

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
POLL_S = 0.1          # the sampler's poll of the progress count
GEN_LOCI = 100        # loci per generating process, at least
TOP_SHAPES = 10       # launch shapes kept per kernel in the JSON line


def generate(outdir: str, n_loci: int, n_samples: int, reads: int,
             log=print, workers: int = 1) -> None:
    """The JAX soak's dataset (tools/soak.py:generate), byte for byte.
    With `workers` > 1 the loci are simulated and their records encoded in
    that many spawned processes, and written here in order."""
    chroms = [f"chrS{i}" for i in range(n_loci)]
    lens = [2 * SOAK_FLANK + p * u
            for p, u in (soak_params(i) for i in range(n_loci))]
    sample_names = [f"S{k}" for k in range(n_samples)]
    hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
           + "".join(f"@SQ\tSN:{c}\tLN:{l}\n" for c, l in zip(chroms, lens))
           + "".join(f"@RG\tID:rg{n}\tSM:{n}\tLB:lib{n}\n"
                     for n in sample_names))
    job = functools.partial(soak_locus, n_samples=n_samples, reads=reads)
    fasta_contigs = []
    snp_lines = ["##fileformat=VCFv4.1"]
    snp_recs = []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if workers > 1:
            pool = stack.enter_context(
                mp.get_context("spawn").Pool(workers))
            loci = pool.imap(job, range(n_loci), chunksize=4)
        else:
            loci = map(job, range(n_loci))
        bam = BamWriter(f"{outdir}/sim.bam", chroms, lens, hdr)
        bed = stack.enter_context(open(f"{outdir}/regions.bed", "w"))
        for i, (chrom, seq, bed_line, contig, snp, recs) in enumerate(loci):
            fasta_contigs.append((chrom, seq))
            bed.write(bed_line)
            snp_lines.append(contig)
            snp_recs.append(snp)
            for rec, encoded in recs:
                bam.write(rec, encoded)
            if (i + 1) % 1000 == 0:
                log(f"  generated {i + 1}/{n_loci} loci "
                    f"({(i + 1) / (time.perf_counter() - t0):.1f} loci/s)")
        bam.close()
    write_fasta(f"{outdir}/sim.fa", fasta_contigs)
    snp_lines.append(
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    snp_lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                     "FORMAT\t" + "\t".join(sample_names))
    with open(f"{outdir}/snps.vcf", "w") as fh:
        fh.write("\n".join(snp_lines + snp_recs) + "\n")
    log(f"dataset ready in {time.perf_counter() - t0:.1f} s")


def ensure_dataset(outdir: str, n_loci: int, n_samples: int, reads: int,
                   log=print) -> float:
    """Generate the dataset into `outdir` unless one of this size is there
    (dataset.json, written last), in one process per GEN_LOCI loci, at
    most one per core and 8; returns the seconds spent generating."""
    os.makedirs(outdir, exist_ok=True)
    marker = f"{outdir}/dataset.json"
    want = dict(n_loci=n_loci, n_samples=n_samples, reads=reads)
    try:
        with open(marker) as fh:
            if json.load(fh) == want:
                log("reusing the existing dataset")
                return 0.0
    except (OSError, ValueError):
        pass
    workers = min(8, len(os.sched_getaffinity(0)), -(-n_loci // GEN_LOCI))
    t0 = time.perf_counter()
    generate(outdir, n_loci, n_samples, reads, log, workers)
    with open(marker, "w") as fh:
        json.dump(want, fh)
    return time.perf_counter() - t0


def soak_options(outdir: str, dtype: str = "float32", em: bool = False,
                 max_regions: int = PipelineOptions.max_regions):
    """The JAX soak's options (tools/soak.py:run)."""
    return PipelineOptions(
        min_reads=15, use_unpaired=True, dtype=dtype,
        snp_vcf=f"{outdir}/snps.vcf", max_regions=max_regions,
        def_stutter_model=None if em else StutterModel(*DEFAULT_MODEL))


def current_rss_mb() -> float:
    with open("/proc/self/statm") as fh:
        pages = int(fh.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 20


class Sampler:
    """Polls `pipeline.loci_done` from a thread: throughput windows every
    `window_s` seconds, and a band every `band` loci with its rate, its
    slowest and fastest window and the memory at its close."""

    def __init__(self, pipeline, device, window_s: float, band: int,
                 n_loci: int, log=print):
        self.pipeline, self.device = pipeline, device
        self.cards = local_devices(device)
        self.window_s, self.band, self.n_loci = window_s, band, n_loci
        self.log = log
        self.windows = []      # (loci done at the close, loci/s)
        self.bands = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def __enter__(self):
        self.t0 = time.perf_counter()
        self._band_start = (0, self.t0, 0)   # (first locus, time, windows)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        if exc[0] is None:
            t = time.perf_counter()
            self._close_full_bands(getattr(self.pipeline, "loci_done", 0), t)
            self._close_band(self.n_loci, t)

    def _memory(self) -> dict:
        mem = dict(rss_mb=current_rss_mb(), max_rss_mb=max_rss_mb(),
                   device_mib=None, peak_device_mib=None)
        if self.device.type == "cuda":
            mem["device_mib"] = max(torch.cuda.memory_allocated(card)
                                    for card in self.cards) / 2 ** 20
            mem["peak_device_mib"] = peak_device_mib(self.device)
        return mem

    def _close_band(self, done: int, t: float) -> None:
        first, t_open, w_open = self._band_start
        if done <= first:
            return
        rates = [r for _, r in self.windows[w_open:]]
        self.bands.append(dict(
            band=f"{first}-{done}", loci=done - first,
            loci_per_s=(done - first) / (t - t_open) if t > t_open else None,
            min_window=min(rates) if rates else None,
            max_window=max(rates) if rates else None, **self._memory()))
        self._band_start = (done, t, len(self.windows))

    def _loop(self) -> None:
        last_n, last_t = 0, self.t0
        while not self._stop.wait(POLL_S):
            n = getattr(self.pipeline, "loci_done", 0)
            t = time.perf_counter()
            if t - last_t >= self.window_s:
                rate = (n - last_n) / (t - last_t)
                self.windows.append((n, rate))
                self.log(f"  [{t - self.t0:7.1f}s] {n:6d} loci done "
                         f"({rate:.2f} loci/s)")
                last_n, last_t = n, t
            self._close_full_bands(n, t)

    def _close_full_bands(self, n: int, t: float) -> None:
        while n >= self._band_start[0] + self.band:
            self._close_band(self._band_start[0] + self.band, t)


def count_regions(bed: str, max_regions: int) -> int:
    with open(bed) as fh:
        return min(max_regions, sum(1 for line in fh if line.strip()))


def run(outdir: str, device: torch.device, *, dtype: str = "float32",
        em: bool = False, host_workers: int = 1, batch_size: int = 32,
        window_s: float = 20.0, band: int = 1000,
        max_regions: int = PipelineOptions.max_regions, out=None,
        log=print) -> dict:
    """Genotype the soak dataset in `outdir` on `device`; returns the
    result (the closing JSON line's object)."""
    bam, fasta = f"{outdir}/sim.bam", f"{outdir}/sim.fa"
    bed = f"{outdir}/regions.bed"
    out = out or f"{outdir}/out.vcf"
    n_loci = count_regions(bed, max_regions)
    p = GenotyperPipeline([bam], fasta,
                          soak_options(outdir, dtype, em, max_regions),
                          Logger(quiet=True))
    launches0 = dict(kernels.LAUNCHES)
    shapes0 = {k: kernels.SHAPES[k].copy() for k in ("emission", "segment")}
    synchronize(device)
    reset_peak_device(device)
    with Sampler(p, device, window_s, band, n_loci, log) as sampler:
        if batch_size == 0:
            from ..pipeline.sequential import run_sequential
            counters = run_sequential(p, bed, out, device)
        elif host_workers > 1:
            from ..parallel.workers import run_pooled
            spec = dict(bam_paths=[bam], fasta_path=fasta,
                        opts=soak_options(outdir, dtype, em, max_regions),
                        bam_samps=None, bam_libs=None, lib_field="LB")
            counters = run_pooled(p, bed, out, device, spec,
                                  n_workers=host_workers,
                                  batch_size=batch_size)
        else:
            from ..parallel.executor import run_batched
            counters = run_batched(p, bed, out, device, batch_size=batch_size)
        synchronize(device)
    wall = time.perf_counter() - sampler.t0
    stats = getattr(p, "last_run_stats", None) or {}
    shapes = {k: kernels.SHAPES[k] - shapes0[k] for k in shapes0}
    peak = peak_device_mib(device)
    return dict(
        loci=n_loci, success=counters.genotype_success,
        fail=counters.genotype_fail, em_fail=counters.em_fail,
        wall_s=wall, loci_per_s=counters.genotype_success / wall,
        bands=sampler.bands, windows=sampler.windows,
        max_rss_mb=max_rss_mb(),
        workers_max_rss_mb=resource.getrusage(
            resource.RUSAGE_CHILDREN).ru_maxrss / 1024,
        peak_device_mib=peak,
        device_wait_s=p.timer.totals.get("Device fetch", 0.0),
        worker_start_s=p.timer.totals.get("Worker start", 0.0),
        dispatches=stats.get("dispatches"),
        card_shards=stats.get("card_shards"),
        launches={k: kernels.LAUNCHES[k] - launches0[k] for k in launches0},
        launch_shapes={k: [[list(s), c] for s, c in
                           h.most_common(TOP_SHAPES)]
                       for k, h in shapes.items()},
        timers=dict(p.timer.totals), dtype=dtype, em=em,
        host_workers=host_workers, batch_loci=batch_size,
        device=device_info(device))


def band_table(bands) -> str:
    """The band table of BASELINE.md's soak section, with memory."""
    def fmt(x, spec=".2f"):
        return "-" if x is None else format(x, spec)
    lines = ["| Locus band | mean loci/s | min window | max window | RSS MB "
             "| max RSS MB | device MiB | peak device MiB |",
             "|---|---|---|---|---|---|---|---|"]
    for b in bands:
        lines.append(
            f"| {b['band']} | {fmt(b['loci_per_s'])} | "
            f"{fmt(b['min_window'])} | {fmt(b['max_window'])} | "
            f"{fmt(b['rss_mb'], '.0f')} | {fmt(b['max_rss_mb'], '.0f')} | "
            f"{fmt(b['device_mib'], '.0f')} | "
            f"{fmt(b['peak_device_mib'], '.0f')} |")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m hipstr_tpu_torch.tools.soak",
        description="Chromosome-scale soak of the port (BASELINE config 4).")
    ap.add_argument("n_loci", nargs="?", type=int, default=10000)
    ap.add_argument("n_samples", nargs="?", type=int, default=20)
    ap.add_argument("reads", nargs="?", type=int, default=30)
    ap.add_argument("outdir", nargs="?",
                    default=os.path.join(ROOT, "build", "soak"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--em", action="store_true",
                    help="no stutter model: each locus's model is learned")
    ap.add_argument("--host-workers", type=int, default=1,
                    help="host worker processes (> 1: the pool)")
    ap.add_argument("--window-s", type=float, default=20.0,
                    help="seconds per throughput window")
    ap.add_argument("--band", type=int, default=1000,
                    help="loci per band of the table")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device, _ = resolve(args.device)
    gen_s = ensure_dataset(args.outdir, args.n_loci, args.n_samples,
                           args.reads)
    res = run(args.outdir, device, em=args.em,
              host_workers=args.host_workers, window_s=args.window_s,
              band=args.band)
    res.update(generate_s=gen_s, n_samples=args.n_samples, reads=args.reads)
    print(f"\nsoak: {res['loci']} loci in {res['wall_s']:.1f} s = "
          f"{res['loci_per_s']:.3f} loci/s, max RSS {res['max_rss_mb']:.0f} "
          f"MB, success={res['success']} fail={res['fail']}")
    print(band_table(res["bands"]))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
