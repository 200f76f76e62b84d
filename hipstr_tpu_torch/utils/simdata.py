"""Simulated BAM/FASTA/BED datasets for the port's checks.

`write_sim` is the dataset writer of the JAX package's tests
(tests/test_workers.py::_write_sim), here without any JAX import so the
card's smoke run can use it.  The loci come from
hipstr_tpu.utils.simulate, seeded, so the same dataset is made anew on any
machine.
"""

from __future__ import annotations

from ..io.bam import BamRecord, BamWriter
from ..io.fasta import write_fasta
from .simulate import simulate_locus


def write_sim(tmp: str, locs) -> None:
    """Write sim.fa, regions.bed and sim.bam for simulated loci into tmp."""
    write_fasta(f"{tmp}/sim.fa", [(l.chrom, l.chrom_seq) for l in locs])
    with open(f"{tmp}/regions.bed", "w") as fh:
        for l in locs:
            r = l.region
            fh.write(f"{r.chrom}\t{r.start + 1}\t{r.stop}\t{r.period}"
                     "\t8.0\tX\n")
    hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
           + "".join(f"@SQ\tSN:{l.chrom}\tLN:{len(l.chrom_seq)}\n"
                     for l in locs)
           + "".join(f"@RG\tID:rg{n}\tSM:{n}\tLB:lib{n}\n"
                     for n in locs[0].sample_names))
    w = BamWriter(f"{tmp}/sim.bam", [l.chrom for l in locs],
                  [len(l.chrom_seq) for l in locs], hdr)
    ref_ids = {l.chrom: i for i, l in enumerate(locs)}
    recs = []
    for l in locs:
        for rd in l.raw_reads:
            recs.append(BamRecord(
                name=f"{l.chrom}_{rd['name']}", flag=0x10 if rd["rev"] else 0,
                ref_id=ref_ids[l.chrom], pos=rd["start"], mapq=60,
                cigar=[(len(rd["seq"]), "M")], mate_ref_id=-1, mate_pos=-1,
                tlen=0, seq=rd["seq"], qual=rd["quals"],
                tags={"RG": ("Z", f"rg{rd['sample']}")}))
    recs.sort(key=lambda r: (r.ref_id, r.pos))
    for r in recs:
        w.write(r)
    w.close()


def trio_loci(n_loci: int, reads_per_sample: int = 170, base_seed: int = 31000,
              chrom_prefix: str = "chrB"):
    """The benchmark workload of bench.py: a simulated trio (3 samples),
    repeat periods 1-4, 8-10 reference units; 170 reads per sample is
    ~30x."""
    return [simulate_locus(seed=base_seed + i, n_samples=3,
                           reads_per_sample=reads_per_sample,
                           period=1 + (i % 4), ref_units=8 + (i % 3),
                           chrom=f"{chrom_prefix}{i}")
            for i in range(n_loci)]


# the dataset behind tests/data/torch_port_ref_f64.vcf: the JAX package's
# float64 CPU run on it is the port's cross-machine anchor
REFERENCE_DATASET = dict(n_loci=8, reads_per_sample=20, base_seed=4200,
                         chrom_prefix="chrR")


def reference_loci():
    return trio_loci(**REFERENCE_DATASET)


# options of the reference run (bench.py's, with min_reads scaled to the
# 20-reads-per-sample depth)
REFERENCE_ARGS = ["--min-reads", "15", "--use-unpaired",
                  "--def-stutter-model", "--batch-loci", "32"]
