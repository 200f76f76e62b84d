"""The benchmark's one dataset generator: a configuration's sizes and a
traffic mix's parameters in, BAM + BAI, FASTA + FAI, BED and SNP VCF out.

A traffic file (`strbench/traffic/<name>.json`) names its `generator`, a
module of this package with a `locus(i, base_seed, n_samples,
reads_per_sample, read_len, chrom_prefix, params)` function, and gives
its `params`; a new mix that uses an existing generator is a data file
alone.  Loci are simulated in one spawned process per core (at most 8)
and written here in order.  The dataset of a (configuration, traffic,
seed) lives under `build/strbench/data/`, keyed by a hash of the
generator's sources and every size and parameter, and is reused when its
marker (`dataset.json`, written last) is there.
"""

from __future__ import annotations

import functools
import hashlib
import importlib
import json
import multiprocessing as mp
import os
import shutil
import time
from pathlib import Path

from .writers import BamWriter, write_bgzipped_vcf, write_fasta

HERE = Path(__file__).resolve().parent
# seeds may go past 2**31: each seed owns 2**20 consecutive
# locus streams
SEED_STRIDE = 1 << 20


def family(traffic: dict):
    return importlib.import_module(f"strbench.traffic.{traffic['generator']}")


def source_hash(traffic: dict) -> str:
    h = hashlib.sha256()
    for mod in ("writers", "generate", traffic["generator"]):
        h.update((HERE / f"{mod}.py").read_bytes())
    return h.hexdigest()[:12]


def write_dataset(out: str, fam, loci) -> dict:
    """Write the loci (an iterator of fam.locus dicts, in order) into
    `out`; returns {chrom: {sample: {net length change: reads}}}."""
    loci = list(loci)
    names = list(loci[0]["truth"])
    chroms = [l["chrom"] for l in loci]
    lens = [len(l["seq"]) for l in loci]
    hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
           + "".join(f"@SQ\tSN:{c}\tLN:{n}\n" for c, n in zip(chroms, lens))
           + "".join(f"@RG\tID:rg{n}\tSM:{n}\tLB:lib{n}\n" for n in names))
    bam = BamWriter(f"{out}/sim.bam", chroms, lens, hdr)
    truth = {}
    for ref_id, l in enumerate(loci):
        for pos, end, enc in l["reads"]:
            bam.write(ref_id, pos, end, enc)
        truth[l["chrom"]] = {s: _counts(d) for s, d in l["truth"].items()}
    bam.close()
    write_fasta(f"{out}/sim.fa", [(l["chrom"], l["seq"]) for l in loci])
    with open(f"{out}/regions.bed", "w") as fh:
        fh.write("".join(l["bed"] for l in loci))
    head = (["##fileformat=VCFv4.1"]
            + [f"##contig=<ID={c},length={n}>" for c, n in zip(chroms, lens)]
            + ['##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
               "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
               + "\t".join(names)])
    write_bgzipped_vcf(f"{out}/{fam.SNP_VCF}", head,
                       [l["snp"] for l in loci])
    return truth


def _counts(diffs):
    out = {}
    for d in diffs:
        out[d] = out.get(d, 0) + 1
    return out


def dataset(root: str, cfg: dict, traffic: dict, seed: int,
            workers: int = 8, log=None) -> tuple:
    """(directory, info) of the cell's dataset at `seed`, generated unless
    cached; info holds the seconds spent, whether it was cached, the bytes
    on disk and the SNP VCF's file name."""
    fam = family(traffic)
    sizes = dict(n_samples=cfg["samples"],
                 reads_per_sample=cfg["reads_per_sample"],
                 read_len=cfg["read_len"], chrom_prefix="chrB",
                 params=traffic.get("params", {}))
    key = dict(sizes, loci=cfg["loci"], seed=seed,
               generator=traffic["generator"], source=source_hash(traffic))
    digest = hashlib.sha256(json.dumps(key, sort_keys=True).encode()
                            ).hexdigest()[:16]
    out = Path(root) / f"{cfg['name']}.{traffic['name']}.{seed}.{digest}"
    marker = out / "dataset.json"
    info = dict(snp_vcf=fam.SNP_VCF, dir=str(out))
    if marker.exists():
        info.update(json.loads(marker.read_text()), cached=True, seconds=0.0)
        return str(out), info
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    job = functools.partial(fam.locus, base_seed=seed * SEED_STRIDE,
                            **sizes)
    n = cfg["loci"]
    n_proc = max(1, min(workers, n // 4))
    if n_proc > 1:
        ctx = mp.get_context("spawn")
        pool = ctx.Pool(n_proc)
        try:
            truth = write_dataset(str(out), fam, pool.imap(
                job, range(n), chunksize=max(1, n // (8 * n_proc))))
            pool.close()
        finally:
            pool.terminate()
            pool.join()
    else:
        truth = write_dataset(str(out), fam, map(job, range(n)))
    (out / "truth.json").write_text(json.dumps(truth))
    nbytes = sum(f.stat().st_size for f in out.iterdir())
    made = dict(key, bytes=nbytes,
                generate_s=round(time.perf_counter() - t0, 3))
    marker.write_text(json.dumps(made))
    info.update(made, cached=False, seconds=made["generate_s"])
    if log:
        log(f"dataset {out.name}: {n} loci in {made['generate_s']} s, "
            f"{nbytes} bytes")
    return str(out), info
