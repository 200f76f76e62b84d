"""Simulated BAM/FASTA/BED datasets for the port's checks.

`write_sim` is the dataset writer of the JAX package's tests
(tests/test_workers.py::_write_sim), and `write_golden` the writer of
tools/make_golden_data.py, here without any JAX import so the card's smoke
run can use them.  `GOLDEN_CONFIGS` are the golden suites' datasets and
flags.  `write_trio_denovo` and `write_phased_snps` make the de novo golden
suite's trio (tests/test_golden_denovo.py), and `write_denovo_cohort` a
synthetic STR VCF of many families for the de novo scanners.
`MODE_CONFIGS` are the CLI modes of the JAX package's tests
(tests/test_cli_modes.py, tests/test_phasing.py, tests/test_cram.py): each
test's dataset, seeds and flags, with `mode_runs`, `mode_vcf_body` and
`mode_products` for their outputs.  The loci
come from the port's copy of the simulator (utils/simulate.py), seeded, so
the same dataset is made anew on any machine.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import random
import shutil
from typing import Callable, NamedTuple, Tuple

import numpy as np

from ..io.bam import BamRecord, BamWriter
from ..io.bgzf import BgzfWriter
from ..io.fasta import write_fasta
from ..io.tabix import TabixBuilder
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


# the chromosome-scale soak's loci (tools/soak.py:generate, BASELINE config
# 4): contigs of 2 * SOAK_FLANK bp around the repeat, a phased SNP 20 bp
# from it in every sample
SOAK_FLANK = 300


def soak_params(i: int):
    """(period, reference units) of soak locus i."""
    return 1 + (i % 4), 8 + (i % 3)


def soak_locus(i: int, n_samples: int, reads: int):
    """Soak locus i: (contig, its sequence, BED line, SNP VCF contig line,
    SNP VCF record, [(BamRecord, its encoding)] in coordinate order)."""
    from ..io.bam import encode_record
    period, ref_units = soak_params(i)
    sample_names = [f"S{k}" for k in range(n_samples)]
    chrom = f"chrS{i}"
    loc = simulate_locus(seed=70000 + i, n_samples=n_samples,
                         reads_per_sample=reads, period=period,
                         ref_units=ref_units, chrom=chrom,
                         phased_snp_offset=20, sample_names=sample_names)
    if len(loc.chrom_seq) != 2 * SOAK_FLANK + period * ref_units:
        raise RuntimeError(f"soak locus {i}: contig of "
                           f"{len(loc.chrom_seq)} bp")
    r = loc.region
    bed = f"{r.chrom}\t{r.start + 1}\t{r.stop}\t{r.period}\t8.0\tX\n"
    contig = f"##contig=<ID={chrom},length={len(loc.chrom_seq)}>"
    gt = "\t".join("0|1" for _ in sample_names)
    snp = (f"{chrom}\t{loc.snp['pos'] + 1}\t.\t{loc.snp['ref']}\t"
           f"{loc.snp['alt']}\t.\t.\t.\tGT\t{gt}")
    recs = []
    for rd in sorted(loc.raw_reads, key=lambda rd: rd["start"]):
        rec = BamRecord(
            name=f"{chrom}_{rd['name']}", flag=0x10 if rd["rev"] else 0,
            ref_id=i, pos=rd["start"], mapq=60,
            cigar=[(len(rd["seq"]), "M")], mate_ref_id=-1, mate_pos=-1,
            tlen=0, seq=rd["seq"], qual=rd["quals"],
            tags={"RG": ("Z", f"rg{rd['sample']}")})
        recs.append((rec, encode_record(rec)))
    return chrom, loc.chrom_seq, bed, contig, snp, recs


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
# the same run learning each locus's stutter model (the EM anchor,
# tests/data/torch_port_ref_em_f64.vcf)
REFERENCE_EM_ARGS = [a for a in REFERENCE_ARGS if a != "--def-stutter-model"]


def write_golden(outdir: str, *, loci: int, samples: int, reads: int,
                 seed: int = 1234, period: int = 3, ref_units: int = 8,
                 snp_offset: int = 0, paired: bool = False,
                 hp_tags: bool = False, realistic: bool = False) -> None:
    """The dataset tools/make_golden_data.py writes with these options (its
    flags by the same names): sim.fa, regions.bed, sim.bam and, with
    `snp_offset`, a phased het SNP that many bp left of each STR in
    snps.vcf.gz (+ .tbi)."""
    os.makedirs(outdir, exist_ok=True)
    contigs, bed_lines, all_reads, snp_lines = [], [], [], []
    sample_names = None
    for g in range(loci):
        locus = simulate_locus(seed=seed + g, n_samples=samples,
                               reads_per_sample=reads, period=period,
                               ref_units=ref_units, chrom=f"chrS{g}",
                               paired=paired,
                               phased_snp_offset=snp_offset or None,
                               realism=realistic)
        sample_names = locus.sample_names
        if snp_offset:
            snp = locus.snp
            gt = "\t".join("0|1" for _ in locus.sample_names)
            snp_lines.append(f"{locus.chrom}\t{snp['pos'] + 1}\t.\t"
                             f"{snp['ref']}\t{snp['alt']}\t.\t.\t.\tGT\t{gt}")
        contigs.append((locus.chrom, locus.chrom_seq))
        r = locus.region
        bed_lines.append(
            f"{r.chrom}\t{r.start + 1}\t{r.stop}\t{r.period}\t"
            f"{(r.stop - r.start) / r.period:.1f}\t{r.name}")
        for rd in locus.raw_reads:
            all_reads.append((g, locus.chrom, rd))

    write_fasta(os.path.join(outdir, "sim.fa"), contigs)
    with open(os.path.join(outdir, "regions.bed"), "w") as fh:
        fh.write("\n".join(bed_lines) + "\n")

    header = ("@HD\tVN:1.6\tSO:coordinate\n"
              + "".join(f"@SQ\tSN:{c}\tLN:{len(s)}\n" for c, s in contigs)
              + "".join(f"@RG\tID:rg{name}\tSM:{name}\tLB:lib{name}\n"
                        for name in sample_names))
    writer = BamWriter(os.path.join(outdir, "sim.bam"),
                       [c for c, _ in contigs], [len(s) for _, s in contigs],
                       header)
    all_reads.sort(key=lambda t: (t[0], t[2]["start"]))
    for g, _, rd in all_reads:
        tags = {"RG": ("Z", f"rg{rd['sample']}")}
        tags.update(rd.get("tags", {}))
        if hp_tags:
            tags["HP"] = ("i", rd["hap"])
        writer.write(BamRecord(
            name=rd["name"], flag=rd.get("flag", 0x10 if rd["rev"] else 0),
            ref_id=g, pos=rd["start"], mapq=rd.get("mapq", 60),
            cigar=rd.get("cigar", [(len(rd["seq"]), "M")]),
            mate_ref_id=g if "mate_pos" in rd else -1,
            mate_pos=rd.get("mate_pos", -1), tlen=rd.get("tlen", 0),
            seq=rd["seq"], qual=rd["quals"], tags=tags))
    writer.close()
    if snp_offset:
        header_lines = (["##fileformat=VCFv4.1"]
                        + [f"##contig=<ID={c},length={len(s)}>"
                           for c, s in contigs]
                        + ['##FORMAT=<ID=GT,Number=1,Type=String,'
                           'Description="Genotype">',
                           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                           "\tFORMAT\t" + "\t".join(sample_names)])
        write_bgzipped_vcf(os.path.join(outdir, "snps.vcf.gz"),
                           header_lines, snp_lines)


def write_bgzipped_vcf(path: str, header_lines, records) -> None:
    """A bgzipped VCF at `path` and its tabix index `path`.tbi, each record
    indexed over its REF allele (the writers of tools/make_golden_data.py
    and tests/test_golden_denovo.py)."""
    w = BgzfWriter(path)
    tbi = TabixBuilder()
    w.write(("\n".join(header_lines) + "\n").encode())
    for line in records:
        cols = line.split("\t", 4)
        beg = int(cols[1]) - 1
        v0 = w.virtual_offset
        w.write((line + "\n").encode())
        tbi.add(cols[0], beg, beg + len(cols[3]), v0, w.virtual_offset)
    w.close()
    tbi.write(path + ".tbi")


# The golden suites' configurations (tests/test_golden_vs_reference.py,
# tests/test_golden_realistic.py): name -> (write_golden options, genotyper
# flags; "{d}" stands for the dataset's directory).  `outputs_em` is the EM
# run with SNP phasing and every --output-* flag, the VCF de novo runs read.
_COMMON = ("--use-unpaired", "--min-reads", "20", "--def-stutter-model")
GOLDEN_CONFIGS = {
    "default": (dict(loci=3, samples=3, reads=40), _COMMON),
    "snp": (dict(loci=2, samples=3, reads=40, snp_offset=25),
            _COMMON + ("--snp-vcf", "{d}/snps.vcf.gz")),
    "em8": (dict(loci=2, samples=8, reads=40),
            ("--use-unpaired", "--min-reads", "20")),
    "hp10x": (dict(loci=2, samples=3, reads=40, hp_tags=True),
              _COMMON + ("--10x-bams",)),
    "p1": (dict(loci=2, samples=3, reads=40, period=1, ref_units=10),
           _COMMON),
    "p4": (dict(loci=2, samples=3, reads=40, period=4, ref_units=10),
           _COMMON),
    "paired": (dict(loci=2, samples=3, reads=40, paired=True),
               ("--min-reads", "15", "--def-stutter-model")),
    "realistic": (dict(loci=6, samples=3, reads=45, realistic=True,
                       seed=4242),
                  ("--use-unpaired", "--min-reads", "15",
                   "--def-stutter-model")),
    "deep": (dict(loci=2, samples=3, reads=250, seed=777), _COMMON),
    "realistic_paired": (dict(loci=4, samples=3, reads=45, paired=True,
                              realistic=True, seed=9191),
                         ("--min-reads", "15", "--def-stutter-model")),
    "outputs_em": (dict(loci=2, samples=3, reads=40, snp_offset=25),
                   ("--use-unpaired", "--min-reads", "20", "--snp-vcf",
                    "{d}/snps.vcf.gz", "--output-gls", "--output-pls",
                    "--output-phased-gls", "--output-filters",
                    "--output-hap-fields")),
}


def golden_args(name: str, d: str, out: str):
    """The genotyper's command line for configuration `name` on the dataset
    in `d`, writing `out` (no --device, --dtype or mode flags)."""
    return (["--bams", f"{d}/sim.bam", "--fasta", f"{d}/sim.fa",
             "--regions", f"{d}/regions.bed", "--str-vcf", out, "--silent"]
            + [f.format(d=d) for f in GOLDEN_CONFIGS[name][1]])


def golden_tool_args(name: str):
    """tools/make_golden_data.py's flags for configuration `name`."""
    out = []
    for key, value in GOLDEN_CONFIGS[name][0].items():
        flag = "--" + key.replace("_", "-")
        if value is True:
            out.append(flag)
        elif value is not False:
            out += [flag, str(value)]
    return out


# ------------------------------------------------------------- CLI modes
def write_cli_inputs(out: str, locus, hp_tags: bool = False,
                     bam: str = "sim.bam", read_groups: bool = True,
                     bed_name: str = "SIM1") -> None:
    """One simulated locus as sim.fa, regions.bed and a BAM: the writer of
    tests/test_cli_modes.py::_write_inputs (also tests/test_phasing.py's
    --ref-vcf test), or with `read_groups=False` the RG-less BAM of its
    --bam-samps test."""
    write_fasta(f"{out}/sim.fa", [(locus.chrom, locus.chrom_seq)])
    r = locus.region
    with open(f"{out}/regions.bed", "w") as fh:
        fh.write(f"{r.chrom}\t{r.start + 1}\t{r.stop}\t{r.period}\t8.0\t"
                 f"{bed_name}\n")
    header = ("@HD\tVN:1.6\tSO:coordinate\n"
              f"@SQ\tSN:{locus.chrom}\tLN:{len(locus.chrom_seq)}\n")
    if read_groups:
        header += "".join(f"@RG\tID:rg{n}\tSM:{n}\tLB:lib{n}\n"
                          for n in locus.sample_names)
    writer = BamWriter(f"{out}/{bam}", [locus.chrom], [len(locus.chrom_seq)],
                       header)
    for rd in sorted(locus.raw_reads, key=lambda d: d["start"]):
        tags = {"RG": ("Z", f"rg{rd['sample']}")} if read_groups else {}
        if hp_tags:
            tags["HP"] = ("i", rd["hap"])
        writer.write(BamRecord(
            name=rd["name"], flag=0x10 if rd["rev"] else 0, ref_id=0,
            pos=rd["start"], mapq=60, cigar=[(len(rd["seq"]), "M")],
            mate_ref_id=-1, mate_pos=-1, tlen=0, seq=rd["seq"],
            qual=rd["quals"], tags=tags))
    writer.close()


# the committed CRAM fixture of tests/test_cram.py: contig chrT (264 bp),
# 20 reads x 70 bp over 2 samples, a TTG x 8 repeat at 0-based 120-144
CRAM_FIXTURE = ("cram_fix.cram", "cram_fix.cram.crai", "cram_fix.bam",
                "cram_fix.bam.bai", "cram_fix.fa", "cram_fix.fa.fai")


def write_cram_inputs(out: str) -> None:
    """The CRAM fixture (tests/data/cram_fix.*) and a BED over its repeat."""
    data = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "data")
    for name in CRAM_FIXTURE:
        shutil.copyfile(os.path.join(data, name), os.path.join(out, name))
    with open(f"{out}/regions.bed", "w") as fh:
        fh.write("chrT\t121\t144\t3\t8.0\tCRAM1\n")


def _locus_writer(**kw):
    extra = {k: kw.pop(k) for k in ("bam", "read_groups", "bed_name")
             if k in kw}
    return lambda out: write_cli_inputs(out, simulate_locus(**kw), **extra)


def _inputs(bam: str = "sim.bam", fasta: str = "sim.fa"):
    return ("--bams", "{d}/" + bam, "--fasta", "{d}/" + fasta, "--regions",
            "{d}/regions.bed")


class Mode(NamedTuple):
    """A CLI mode of the JAX tests: its dataset writer (into a directory)
    and its runs, in order, each (label, flags) with "{d}" for the dataset
    directory and "{o}" for the output directory.  A run writes
    {o}/<label>.vcf unless it passes --skip-genotyping."""
    write: Callable[[str], None]
    runs: Tuple[Tuple[str, Tuple[str, ...]], ...]


_SIM1 = dict(n_samples=3, reads_per_sample=30, period=3, ref_units=8)
# tests/test_cli_modes.py::_run_cli's flags (and tests/test_phasing.py's)
_CLI = _inputs() + ("--use-unpaired", "--min-reads", "20")
_DEF = _CLI + ("--def-stutter-model",)
MODE_CONFIGS = {
    # tests/test_cli_modes.py:57
    "haploid": Mode(_locus_writer(seed=123, haploid=True, **_SIM1), (
        ("out", _DEF + ("--haploid-chrs", "chrSim")),)),
    # :83, the second run reads the first run's models
    "stutter_roundtrip": Mode(_locus_writer(seed=207, **dict(
        _SIM1, n_samples=4)), (
        ("pass1", _CLI + ("--stutter-out", "{o}/models.txt")),
        ("pass2", _CLI + ("--stutter-in", "{o}/models.txt")))),
    # :124
    "skip_genotyping": Mode(_locus_writer(seed=5, **_SIM1), (
        ("skip", _CLI + ("--skip-genotyping", "--stutter-out",
                         "{o}/models.txt", "--pass-bam", "{o}/pass.bam",
                         "--filt-bam", "{o}/filt.bam")),)),
    # :148
    "sample_list": Mode(_locus_writer(seed=19, **dict(_SIM1, n_samples=4)), (
        ("out", _DEF + ("--min-reads", "10", "--sample-list",
                        "SAMPLE000,SAMPLE001", "--hide-allreads",
                        "--hide-mallreads")),)),
    # :320 (the extraction as tests/test_phasing.py:177 makes it)
    "viz": Mode(_locus_writer(seed=311, **_SIM1), (
        ("out", _DEF + ("--batch-loci", "4", "--viz-out", "{o}/viz.gz")),)),
    # :383, a repeat longer than the reads: no record
    "unspannable": Mode(_locus_writer(
        seed=5011, n_samples=3, reads_per_sample=25, period=6, ref_units=12,
        read_len=70), (
        ("out", _DEF + ("--min-reads", "15")),)),
    # :398, no read groups
    "bam_samps": Mode(_locus_writer(
        seed=99, n_samples=1, reads_per_sample=30, period=3, ref_units=8,
        bam="norg.bam", read_groups=False, bed_name="X"), (
        ("out", _inputs("norg.bam") + (
            "--bam-samps", "SAMPLEX", "--bam-libs", "LIBX", "--use-unpaired",
            "--min-reads", "15", "--def-stutter-model")),)),
    # tests/test_phasing.py:127, the second run takes the first's VCF as
    # its reference panel
    "ref_vcf": Mode(_locus_writer(seed=91, **_SIM1), (
        ("pass1", _DEF),
        ("pass2", _DEF + ("--ref-vcf", "{o}/pass1.vcf")))),
    # tests/test_phasing.py:218 (tools/make_golden_data.py --loci 4
    # --samples 2 --reads 30)
    "locus_shard": Mode(
        lambda out: write_golden(out, loci=4, samples=2, reads=30), tuple(
            (label, _CLI + ("--min-reads", "10", "--def-stutter-model")
             + shard) for label, shard in (
                ("all", ()), ("shard0", ("--locus-shard", "0/2")),
                ("shard1", ("--locus-shard", "1/2"))))),
    # tests/test_cram.py:51, on the committed fixture
    "cram": Mode(write_cram_inputs, tuple(
        (label, _inputs(f"cram_fix.{label}", "cram_fix.fa") + (
            "--use-unpaired", "--min-reads", "5", "--def-stutter-model"))
        for label in ("bam", "cram"))),
}


def mode_runs(name: str, d: str, o: str):
    """[(label, the genotyper's command line)] of mode `name` on the
    dataset in `d`, writing into `o` (no --device, --dtype or run-mode
    flags)."""
    runs = []
    for label, flags in MODE_CONFIGS[name].runs:
        args = [f.format(d=d, o=o) for f in flags] + ["--silent"]
        if "--skip-genotyping" not in flags:
            args += ["--str-vcf", f"{o}/{label}.vcf"]
        runs.append((label, args))
    return runs


def mode_vcf_body(name: str, o: str):
    """The VCF bodies of mode `name`'s runs in `o`, in run order."""
    body = []
    for label, flags in MODE_CONFIGS[name].runs:
        if "--skip-genotyping" not in flags:
            body += [l for l in open(f"{o}/{label}.vcf")
                     if not l.startswith("#")]
    return body


def mode_products(name: str, d: str, o: str) -> dict:
    """Mode `name`'s outputs other than VCFs, by file name: stutter-model
    files and the pass/filt BAMs and viz files (BGZF, decompressed), and for
    --viz-out the page the vizaln entry point extracts for the first
    locus (viz.html)."""
    from ..pipeline.viz import extract_locus_html
    out = {}
    for _, flags in MODE_CONFIGS[name].runs:
        for opt in ("--stutter-out", "--pass-bam", "--filt-bam", "--viz-out"):
            if opt in flags:
                path = flags[flags.index(opt) + 1].format(d=d, o=o)
                data = open(path, "rb").read()
                if data[:2] == b"\x1f\x8b":
                    data = gzip.decompress(data)
                out[os.path.basename(path)] = data
                if opt == "--viz-out":
                    chrom, start = open(f"{d}/regions.bed").readline().split(
                        "\t")[:2]
                    page = extract_locus_html(path, chrom, int(start))
                    out["viz.html"] = (page or "").encode()
    return out


def product_digest(name: str, data: bytes) -> dict:
    """sha256 and size of product `name`, and the text of a stutter-model
    file (.txt), whose parameters are compared by value where a printed
    digit differs."""
    out = dict(sha256=hashlib.sha256(data).hexdigest(), size=len(data))
    if name.endswith(".txt"):
        out["text"] = data.decode()
    return out


# ---------------------------------------------------------------- de novo
TRIO_SAMPLES = ["MOM", "DAD", "KID"]
# the genotyper flags of the de novo golden suite's STR VCF
# (tests/test_golden_denovo.py::_genotype)
DENOVO_GENOTYPE_ARGS = ["--min-reads", "20", "--use-unpaired",
                        "--def-stutter-model", "--output-gls",
                        "--output-phased-gls"]


def write_trio_denovo(out: str, n_loci: int = 6):
    """The de novo golden suite's trio dataset
    (tests/test_golden_denovo.py::_write_trio_dataset): MOM, DAD and KID
    at 30 reads each over n_loci loci, and trio.fam.  Returns the loci."""
    locs = [simulate_locus(seed=7100 + i, n_samples=3, reads_per_sample=30,
                           period=2 + (i % 3), ref_units=8,
                           chrom=f"chr{i + 1}", sample_names=TRIO_SAMPLES)
            for i in range(n_loci)]
    write_sim(out, locs)
    with open(f"{out}/trio.fam", "w") as fh:
        fh.write("FAM1\tKID\tDAD\tMOM\t1\t0\n")
    return locs


def write_phased_snps(out: str, chroms, seed: int = 5) -> str:
    """300 phased SNPs per chromosome for the trio, the child carrying the
    mother's first and the father's first haplotype, as snps.vcf.gz (+ .tbi)
    (tests/test_golden_denovo.py::_write_phased_snps)."""
    rng = random.Random(seed)
    header = (["##fileformat=VCFv4.1"]
              + [f"##contig=<ID={c},length=100000000>" for c in chroms]
              + ['##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                 "\t" + "\t".join(TRIO_SAMPLES)])
    records = []
    for c in chroms:
        pos = 50
        for _ in range(300):
            pos += rng.randint(50, 1500)
            mom = (rng.randint(0, 1), rng.randint(0, 1))
            dad = (rng.randint(0, 1), rng.randint(0, 1))
            kid = (mom[0], dad[0])
            gts = "\t".join(f"{a}|{b}" for a, b in (mom, dad, kid))
            records.append(f"{c}\t{pos}\t.\tA\tC\t.\t.\t.\tGT\t{gts}")
    write_bgzipped_vcf(f"{out}/snps.vcf.gz", header, records)
    return f"{out}/snps.vcf.gz"


def write_denovo_cohort(out: str, *, records: int = 1000,
                        families: int = 100, chroms: int = 10,
                        seed: int = 2024):
    """A synthetic cohort for the de novo scanners, modelled on
    tests/test_denovo.py's random-GL VCF and tests/test_golden_denovo.py's
    phased SNPs.  `families` nuclear families, trios and quads by turns
    (cohort.fam); `records` STR records over `chroms` chromosomes, 1 kb
    apart (str.vcf), with 2-12 alleles (the first 11 records take each
    count once, the rest are drawn with weight 1/(A-1)^2, so most records
    have few alleles, as in a real call set) and per sample a phased GT,
    random GL and PHASEDGL; 300 phased SNPs per chromosome around them
    (snps.vcf.gz + .tbi), each child carrying one haplotype of each parent,
    drawn per family and chromosome, so every family's inheritance is
    inferred.  Returns (fam, str_vcf, snp_vcf) paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    fams = []
    with open(f"{out}/cohort.fam", "w") as fh:
        for f in range(families):
            kids = [f"K{f}a"] + ([f"K{f}b"] if f % 2 else [])
            for k in kids:
                fh.write(f"FAM{f}\t{k}\tF{f}\tM{f}\t1\t0\n")
            fams.append((f"M{f}", f"F{f}", kids))
    samples = [s for m, d, kids in fams for s in (m, d, *kids)]
    chrom_names = [f"chr{c + 1}" for c in range(chroms)]
    per_chrom = -(-records // chroms)

    weights = 1.0 / np.arange(1, 12) ** 2
    counts = np.concatenate([np.arange(2, 13), rng.choice(
        np.arange(2, 13), size=max(0, records - 11),
        p=weights / weights.sum())])[:records]
    lines = ["##fileformat=VCFv4.1",
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
             '##FORMAT=<ID=GL,Number=G,Type=Float,Description="G">',
             '##FORMAT=<ID=PHASEDGL,Number=.,Type=Float,Description="G">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(samples)]
    for i, A in enumerate(counts.tolist()):
        chrom = chrom_names[i // per_chrom]
        pos = 10000 + 1000 * (i % per_chrom)
        units = [8] + [8 + d for d in (1, -1, 2, -2, 3, -3, 4, -4, 5, -5, 6)]
        alleles = ["AC" * u for u in units[:A]]
        n_gl = A * (A + 1) // 2
        gt = rng.integers(0, A, (len(samples), 2))
        gl = rng.integers(-900, 1, (len(samples), n_gl + A * A)) / 100
        cols = [f"{a}|{b}:" + ",".join(f"{v:.2f}" for v in row[:n_gl]) + ":"
                + ",".join(f"{v:.2f}" for v in row[n_gl:])
                for (a, b), row in zip(gt.tolist(), gl.tolist())]
        bpdiffs = ",".join(str(2 * (u - 8)) for u in units[1:A])
        lines.append(f"{chrom}\t{pos}\t.\t{alleles[0]}\t"
                     f"{','.join(alleles[1:])}\t.\t.\tBPDIFFS={bpdiffs};"
                     f"START={pos};END={pos + 15};PERIOD=2\tGT:GL:PHASEDGL\t"
                     + "\t".join(cols))
    with open(f"{out}/str.vcf", "w") as fh:
        fh.write("\n".join(lines) + "\n")

    header = (["##fileformat=VCFv4.1"]
              + [f"##contig=<ID={c},length=100000000>" for c in chrom_names]
              + ['##FORMAT=<ID=GT,Number=1,Type=String,Description="G">',
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(samples)])
    snps = []
    for chrom in chrom_names:
        # per family and child: the mother's and the father's haplotype
        inherit = [rng.integers(0, 2, (len(kids), 2)) for _, _, kids in fams]
        par = rng.integers(0, 2, (300, len(fams), 2, 2))  # [snp, fam, m/f, hap]
        pos = np.cumsum(rng.integers(50, 1501, 300)) + 50
        for p, gt in zip(pos.tolist(), par.tolist()):
            cols = []
            for (mom, dad), hs in zip(gt, inherit):
                cols += [f"{mom[0]}|{mom[1]}", f"{dad[0]}|{dad[1]}"]
                cols += [f"{mom[hm]}|{dad[hd]}" for hm, hd in hs.tolist()]
            snps.append(f"{chrom}\t{p}\t.\tA\tC\t.\t.\t.\tGT\t"
                        + "\t".join(cols))
    write_bgzipped_vcf(f"{out}/snps.vcf.gz", header, snps)
    return f"{out}/cohort.fam", f"{out}/str.vcf", f"{out}/snps.vcf.gz"
