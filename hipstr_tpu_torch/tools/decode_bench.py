"""Single-thread BAM (or CRAM) decode + filter throughput of the port's
native batch path, in MB/s.

    python -m hipstr_tpu_torch.tools.decode_bench [dataset_dir] [--cram]

Counterpart of tools/decode_bench.py, on the port's own build of the
native host library (hipstr_tpu_torch/native.py).  The measured path is
what the genotyper runs per locus: the BGZF chunk-span bulk read
(io/bam.py fetch_raw) and ONE native bam_filter_batch call that decodes
every record and runs the whole filter cascade columnar.  With `--cram`
the records come from the native CRAM container decoder
(native/cram_decode.cpp) instead, then go through the same cascade.
Host only: no device is involved.

The dataset directory holds sim.bam (or, with `--cram`, sim.cram), sim.fa
and regions.bed.  Without one: BAM, a freshly simulated 40-locus x
20-sample x 30-read set (seeds 61000 + i, as the JAX tool); CRAM, the
committed CRAM fixture (tests/data/cram_fix.*, 20 records: a check that
the path runs, not a rate).
"""

from __future__ import annotations

import argparse
import tempfile
import time

from .. import native
from ..io.bam import BamReader
from ..io.regions import read_regions
from ..pipeline.adapter_trimmer import MAX_ERROR_RATE, MIN_OVERLAP
from ..pipeline.fast_filter import _ADAPTERS
from ..utils.simdata import write_cram_inputs, write_sim
from ..utils.simulate import simulate_locus

REPS = 5


def simulated_dataset(d: str) -> None:
    write_sim(d, [simulate_locus(seed=61000 + i, n_samples=20,
                                 reads_per_sample=30, period=1 + (i % 4),
                                 ref_units=8 + (i % 3), chrom=f"chrD{i}")
                  for i in range(40)])


def read_fasta(path: str) -> dict:
    seqs = {}
    with open(path) as fh:
        for part in fh.read().split(">")[1:]:
            name, _, seq = part.partition("\n")
            seqs[name.split()[0]] = seq.replace("\n", "").encode()
    return seqs


def filter_locus(r, raw, chrom_b: bytes):
    blob, offs, lens, rid = raw
    return native.bam_filter_batch_native(
        blob, offs, lens, max(0, r.start - 1000), r.stop + 1000, r.start,
        r.stop, rid, 0, max(1, r.start - 40), r.stop + 40, chrom_b, 5, 15,
        10, 7, True, _ADAPTERS, MIN_OVERLAP, MAX_ERROR_RATE)


def measure(d: str, cram: bool, names=("sim.bam", "sim.cram", "sim.fa")):
    """(records, record bytes, best seconds) of decoding and filtering
    every region of `d` single-threaded, best of REPS after a warm pass."""
    bam_name, cram_name, fasta_name = names
    if native._load() is None or not hasattr(native._load(),
                                             "bam_filter_batch"):
        raise RuntimeError("the native host library (bam_filter_batch) is "
                           "not available")
    fasta = f"{d}/{fasta_name}"
    if cram:
        from ..io.cram import CramReader
        rdr = CramReader(f"{d}/{cram_name}", fasta)
    else:
        rdr = BamReader(f"{d}/{bam_name}")
    regions = read_regions(f"{d}/regions.bed", 10 ** 9, "", None)
    chrom_seqs = read_fasta(fasta)

    def fetch(r):
        raw = rdr.fetch_raw(r.chrom, max(0, r.start - 1000), r.stop + 1000)
        if raw is None:
            raise RuntimeError(f"{r}: no native raw fetch")
        return raw

    # BAM: pre-fetch the raw blobs so the timed loop isolates decode +
    # cascade; CRAM: the container decode is part of what is timed
    work = [(r, None if cram else fetch(r), chrom_seqs[r.chrom])
            for r in regions]
    first = [fetch(r) for r in regions] if cram else [w[1] for w in work]
    total_bytes = sum(sum(raw[2]) for raw in first)
    n_recs = sum(len(raw[1]) for raw in first)

    def run_all():
        n = 0
        for r, raw, chrom_b in work:
            out = filter_locus(r, raw if raw is not None else fetch(r),
                               chrom_b)
            n += len(out["status"]) if out else 0
        return n

    run_all()                                 # warm
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        got = run_all()
        best = min(best, time.perf_counter() - t0)
    if got != n_recs:
        raise RuntimeError(f"filtered {got} records of {n_recs}")
    return n_recs, total_bytes, best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m hipstr_tpu_torch.tools.decode_bench",
        description="Native decode + filter cascade throughput (host).")
    ap.add_argument("dataset_dir", nargs="?")
    ap.add_argument("--cram", action="store_true",
                    help="decode CRAM containers instead of BAM records")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="hipstr_torch_decode_") as tmp:
        names = ("sim.bam", "sim.cram", "sim.fa")
        d = args.dataset_dir
        if d is None and args.cram:
            d = tmp
            write_cram_inputs(d)
            names = ("cram_fix.bam", "cram_fix.cram", "cram_fix.fa")
        elif d is None:
            d = tmp
            simulated_dataset(d)
        n_recs, nbytes, best = measure(d, args.cram, names)
    mb = nbytes / 1e6
    res = dict(format="cram" if args.cram else "bam", records=n_recs,
               record_mb=mb, best_s=best, mb_per_s=mb / best,
               mrec_per_s=n_recs / best / 1e6)
    print(f"decoded+filtered {n_recs} records ({mb:.1f} MB of BAM record "
          f"bytes{', from CRAM' if args.cram else ''}) in {best * 1000:.1f} "
          f"ms single-thread = {mb / best:.0f} MB/s, "
          f"{n_recs / best / 1e6:.2f} Mrec/s")
    return res


if __name__ == "__main__":
    main()
