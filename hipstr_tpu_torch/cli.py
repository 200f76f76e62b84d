"""hipstr-tpu-torch command line: `python -m hipstr_tpu_torch.cli`.

`build_parser` is a copy of the JAX package's flag table
(hipstr_tpu/cli.py::build_parser), every flag as it is there, plus
`--device cuda|cpu` (default cuda; `cuda` without a visible card is an
error).  The batched in-process run (`--batch-loci N`, N > 0, with a
stutter model) and the sequential run (`--batch-loci 0`, with a model or
the host stutter EM) are ported; the options whose paths are not ported
yet stop with a "not yet ported" error and a non-zero exit rather than
fall back.
"""

from __future__ import annotations

import argparse
import sys

from .device import resolve
from .models.stutter import StutterModel
from .pipeline.processor import GenotyperPipeline, Logger, PipelineOptions
from .pipeline.vcf_record import OutputConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hipstr-tpu-torch",
        description="STR genotyper (HipSTR-compatible), PyTorch/CUDA port")
    ap.add_argument("--bams", help="Comma separated list of BAM files")
    ap.add_argument("--bam-files", help="File listing BAM files, one per line")
    ap.add_argument("--fasta", required=True)
    ap.add_argument("--regions", required=True, help="BED file of STR regions")
    ap.add_argument("--str-vcf",
                    help="Output VCF (bgzipped when path ends in .gz); "
                         "required unless --skip-genotyping")
    ap.add_argument("--bam-samps", help="Comma separated sample per BAM")
    ap.add_argument("--bam-libs", help="Comma separated library per BAM")
    ap.add_argument("--chrom", default="")
    ap.add_argument("--haploid-chrs", default="")
    ap.add_argument("--hap-chr-file", default="",
                    help="File of haploid chromosome names, one per line")
    ap.add_argument("--max-mate-dist", type=int, default=1000,
                    help="Maximum distance between a read and its mate pair")
    ap.add_argument("--read-qual-trim", default="5",
                    help="Trim read ends whose base quality is <= this "
                         "character (Phred+33)")
    ap.add_argument("--lib-field", default="LB",
                    help="Read group field naming each read's library")
    ap.add_argument("--sample-list", default="",
                    help="Comma separated samples to restrict the analysis to")
    ap.add_argument("--pass-bam", help="Output BAM of reads used for "
                    "genotyping (PF tag marks haplotype-generation passes)")
    ap.add_argument("--filt-bam", help="Output BAM of filtered reads "
                    "(FT tag records the filter reason)")
    ap.add_argument("--skip-genotyping", action="store_true",
                    help="Learn stutter models / filter reads only; no VCF")
    ap.add_argument("--min-reads", type=int, default=100)
    ap.add_argument("--max-reads", type=int, default=1000000)
    ap.add_argument("--max-str-len", type=int, default=100)
    ap.add_argument("--max-haps", type=int, default=1000)
    ap.add_argument("--max-hap-flanks", type=int, default=4)
    ap.add_argument("--min-flank-freq", type=float, default=0.01)
    ap.add_argument("--use-unpaired", action="store_true")
    ap.add_argument("--no-rmdup", action="store_true")
    ap.add_argument("--def-stutter-model", action="store_true",
                    help="Use PGEOM=0.9, UP=DOWN=0.05 (in) / 0.01 (out)")
    ap.add_argument("--ref-vcf", help="Reference panel VCF: use its alleles "
                    "as candidates instead of mining reads")
    ap.add_argument("--snp-vcf", help="Bgzipped VCF of phased SNP genotypes")
    ap.add_argument("--fam", help="FAM pedigree for phasing quality control")
    ap.add_argument("--10x-bams", dest="bams_from_10x", action="store_true",
                    help="BAM files were generated by 10X Genomics (HP tags)")
    ap.add_argument("--viz-out", help="Bgzipped output file of alignment "
                    "visualizations (see the vizaln entry point)")
    ap.add_argument("--locus-shard", default="",
                    help="'i/N': process every Nth locus starting at i "
                         "(data-parallel sharding across hosts/processes; "
                         "merge shard VCFs afterwards)")
    ap.add_argument("--batch-loci", type=int, default=32,
                    help="Genotype up to N same-shape loci per device "
                         "dispatch (default 32; 0 = strict sequential loop, "
                         "byte-identical output either way)")
    ap.add_argument("--stutter-in")
    ap.add_argument("--stutter-out")
    ap.add_argument("--output-gls", action="store_true")
    ap.add_argument("--output-pls", action="store_true")
    ap.add_argument("--output-phased-gls", action="store_true")
    ap.add_argument("--output-filters", action="store_true")
    ap.add_argument("--output-hap-fields", action="store_true",
                    help="Write additional fields about the full haplotypes "
                         "(LFLANKS/RFLANKS, HQ/PHQ/LFGT/RFGT)")
    ap.add_argument("--hide-allreads", action="store_true",
                    help="Don't output the ALLREADS FORMAT field")
    ap.add_argument("--hide-mallreads", action="store_true",
                    help="Don't output the MALLREADS FORMAT field")
    ap.add_argument("--viz-left-alns", action="store_true",
                    help="Visualize left-aligned alignments instead of the "
                         "maximum-likelihood traced ones")
    ap.add_argument("--version", action="version", version="hipstr-tpu 0.1")
    ap.add_argument("--max-flank-indel", type=float, default=0.15)
    ap.add_argument("--max-regions", type=int, default=1000000000)
    ap.add_argument("--workers", type=int, default=1,
                    help="Run N worker processes over locus shards and merge "
                         "their outputs (host-parallel scale-out; workers "
                         "default to the CPU backend unless --platform is "
                         "given). Incompatible with --pass-bam/--filt-bam.")
    ap.add_argument("--host-workers", type=int, default=-1,
                    help="Run per-locus host phases (decode, filters, EM, "
                         "adaptive loop, VCF assembly) in N worker processes "
                         "while this process owns the device and services "
                         "all batched alignments. Unlike --workers, the "
                         "single accelerator is shared. Incompatible with "
                         "--pass-bam/--filt-bam (falls back to in-process). "
                         "Default -1 = auto: engage the pool on accelerator "
                         "backends when spare cores exist (outputs are "
                         "byte-identical either way); 1 = in-process.")
    ap.add_argument("--distributed", action="store_true",
                    help="Multi-host data parallelism via jax.distributed: "
                         "every process genotypes its share of loci "
                         "(BED/FASTA replicated, loci sharded by process "
                         "index), counters are reduced across hosts, and "
                         "process 0 merges the shard VCFs. On TPU pods the "
                         "coordinator is autodetected; elsewhere pass "
                         "--coordinator/--num-processes/--process-id.")
    ap.add_argument("--coordinator", default="",
                    help="host:port of the jax.distributed coordinator "
                         "(process 0); empty = autodetect (TPU pods)")
    ap.add_argument("--num-processes", type=int, default=0,
                    help="Total process count for --distributed when the "
                         "coordinator is given explicitly")
    ap.add_argument("--process-id", type=int, default=-1,
                    help="This process's index for --distributed when the "
                         "coordinator is given explicitly")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--profile", metavar="DIR",
                    help="Capture a jax.profiler device/host trace of the "
                         "run into DIR (view with TensorBoard or Perfetto); "
                         "the per-phase host timing table always prints at "
                         "exit (reference's per-locus timers: "
                         "src/genotyper_bam_processor.cpp:254-276)")
    ap.add_argument("--silent", action="store_true")
    ap.add_argument("--log")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--platform", default="",
                    help="Force a JAX platform (e.g. cpu); float64 requires cpu")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Torch device for the alignment kernels "
                         "(default cuda; never falls back to the CPU)")
    return ap


def not_ported(args) -> str:
    """The first requested option whose path is not ported, or ''."""
    batched = args.batch_loci > 0
    if args.workers > 1:
        return "--workers"
    if args.host_workers > 1 and batched:
        # the JAX CLI pools host workers only for batched runs
        return "--host-workers > 1"
    if args.distributed:
        return "--distributed"
    if args.profile:
        return "--profile"
    if args.platform:
        return "--platform (use --device)"
    if batched and not args.def_stutter_model and not args.stutter_in:
        return ("the batched stutter EM (pass --def-stutter-model or "
                "--stutter-in, or run sequentially with --batch-loci 0)")
    return ""


class UsageError(Exception):
    """A command line the port refuses; main() prints it and exits 1."""


def run(argv=None):
    """Parse `argv` and run the batched or (`--batch-loci 0`) sequential
    pipeline; returns (pipeline, counters).  Raises UsageError for a refused command line; device and
    kernel errors propagate."""
    args = build_parser().parse_args(argv)
    missing = not_ported(args)
    if missing:
        raise UsageError(f"{missing} is not yet ported to hipstr_tpu_torch")
    device, _ = resolve(args.device, args.dtype)

    if args.bams:
        bam_paths = args.bams.split(",")
    elif args.bam_files:
        with open(args.bam_files) as fh:
            bam_paths = [l.strip() for l in fh if l.strip()]
    else:
        raise UsageError("--bams or --bam-files is required")
    if not args.str_vcf and not args.skip_genotyping:
        raise UsageError("--str-vcf option required (or use "
                         "--skip-genotyping)")

    cfg = OutputConfig(
        output_gls=args.output_gls, output_pls=args.output_pls,
        output_phased_gls=args.output_phased_gls,
        output_filters=args.output_filters,
        output_haplotype_data=args.output_hap_fields,
        output_allreads=not args.hide_allreads,
        output_mallreads=not args.hide_mallreads,
        viz_left_alns=args.viz_left_alns,
        max_flank_indel_frac=args.max_flank_indel)

    def_model = None
    if args.def_stutter_model:
        def_model = StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2)

    haploid_chroms = [c for c in args.haploid_chrs.split(",") if c]
    if args.hap_chr_file:
        with open(args.hap_chr_file) as fh:
            haploid_chroms.extend(l.strip() for l in fh if l.strip())

    opts = PipelineOptions(
        min_reads=args.min_reads, max_reads=args.max_reads,
        max_str_len=args.max_str_len, use_unpaired=args.use_unpaired,
        remove_pcr_dups=not args.no_rmdup, def_stutter_model=def_model,
        stutter_in=args.stutter_in, stutter_out=args.stutter_out,
        haploid_chroms=tuple(haploid_chroms),
        max_haps=args.max_haps, max_hap_flanks=args.max_hap_flanks,
        min_flank_freq=args.min_flank_freq, chrom=args.chrom,
        max_regions=args.max_regions, dtype=args.dtype,
        snp_vcf=args.snp_vcf, ref_vcf=args.ref_vcf, fam_file=args.fam,
        viz_out=args.viz_out,
        locus_shard=(tuple(int(x) for x in args.locus_shard.split("/"))
                     if args.locus_shard else None),
        max_mate_dist=args.max_mate_dist,
        base_qual_trim=args.read_qual_trim,
        sample_set=(tuple(args.sample_list.split(","))
                    if args.sample_list else None),
        pass_bam=args.pass_bam, filt_bam=args.filt_bam,
        skip_genotyping=args.skip_genotyping,
        bams_from_10x=args.bams_from_10x, output=cfg)

    log_stream = open(args.log, "w") if args.log else sys.stderr
    logger = Logger(log_stream, quiet=args.quiet or args.silent)
    bam_samps = args.bam_samps.split(",") if args.bam_samps else None
    bam_libs = args.bam_libs.split(",") if args.bam_libs else None

    pipeline = GenotyperPipeline(bam_paths, args.fasta, opts, logger,
                                 bam_samps, bam_libs,
                                 lib_field=args.lib_field)
    if args.batch_loci > 0:
        from .parallel.executor import run_batched
        counters = run_batched(pipeline, args.regions, args.str_vcf, device,
                               batch_size=args.batch_loci,
                               full_command=" ".join(sys.argv))
    else:
        from .pipeline.sequential import run_sequential
        counters = run_sequential(pipeline, args.regions, args.str_vcf,
                                  device, full_command=" ".join(sys.argv))
    logger.quiet = args.silent
    logger.log(pipeline.timer.summary())
    logger.log(
        f"Summary: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} "
        f"too_few_reads={counters.too_few_reads} "
        f"too_many_reads={counters.too_many_reads} "
        f"too_long={counters.too_long} em_fail={counters.em_fail} "
        f"missing_model={counters.missing_model}")
    if args.log:
        log_stream.close()
    return pipeline, counters


def main(argv=None) -> int:
    try:
        run(argv)
    except UsageError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
