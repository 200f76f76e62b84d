"""hipstr-tpu-torch command line: `python -m hipstr_tpu_torch.cli`.

`build_parser` is a copy of the JAX package's flag table
(hipstr_tpu/cli.py::build_parser), every flag as it is there (the help of
the options that named JAX says what the port does), plus
`--device cuda|cpu` (default cuda; `cuda` without a visible card is an
error).  Every path of the JAX CLI runs here: the batched run
(`--batch-loci N`, N > 0) in-process or with the host worker pool
(`--host-workers`), the sequential run (`--batch-loci 0`), each with a
stutter model or learning one (on the card the batched runs learn each
wave's models together, the device EM; elsewhere each locus runs the host
EM), each batched dispatch sharded over every visible card (the JAX
CLI's locus mesh; parallel/executor.py); `--workers N` (child processes
over locus shards, merged), with `--distributed` (ranks of a
torch.distributed gloo group, see parallel/distributed.py) and `--profile
DIR` (torch.profiler).  Only
`--platform` is refused, in favour of `--device`.  Nothing falls back: a
failed kernel, child, rank or trace ends the run with a non-zero exit.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import subprocess
import sys

from .device import resolve, resolve_device
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
                         "their outputs (each on this run's --device and "
                         "in-process unless --host-workers is given; with "
                         "n > 1 visible cards worker i takes card i mod n). "
                         "Incompatible with --pass-bam/--filt-bam.")
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
                    help="Data parallelism over processes via "
                         "torch.distributed (gloo): every rank genotypes its "
                         "share of loci (BED/FASTA replicated, loci sharded "
                         "by rank) on card local_rank mod n, counters are "
                         "summed over the ranks, and rank 0 merges the shard "
                         "outputs. Pass --coordinator/--num-processes/"
                         "--process-id, or run under torchrun (env://).")
    ap.add_argument("--coordinator", default="",
                    help="host:port of the process group's rendezvous "
                         "(rank 0 listens there); empty = the env:// "
                         "variables torchrun sets")
    ap.add_argument("--num-processes", type=int, default=0,
                    help="Total process count for --distributed when the "
                         "coordinator is given explicitly")
    ap.add_argument("--process-id", type=int, default=-1,
                    help="This process's index for --distributed when the "
                         "coordinator is given explicitly")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--profile", metavar="DIR",
                    help="Capture a torch.profiler host (and, on cuda, "
                         "device) trace of the run into DIR, one file per "
                         "process (view with Perfetto or TensorBoard); "
                         "the host's timed phases, and the states of the "
                         "pooled parent's loop (Pool route, Pool send, "
                         "Pool dispatch, Stutter estimation (device), Pool "
                         "wait fill/fetch/idle), appear as ranges on the "
                         "device's timeline; the per-phase host timing "
                         "table always prints at exit (reference's "
                         "per-locus timers: "
                         "src/genotyper_bam_processor.cpp:254-276)")
    ap.add_argument("--silent", action="store_true")
    ap.add_argument("--log")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--platform", default="",
                    help="Force a JAX platform (e.g. cpu); float64 requires cpu")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Torch device for the alignment kernels "
                         "(default cuda: every visible card takes a shard "
                         "of each batched dispatch; never falls back to "
                         "the CPU)")
    return ap


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class UsageError(Exception):
    """A command line the port refuses; main() prints it and exits 1."""


def refuse_unported(args) -> None:
    """--platform, the JAX CLI's backend switch, is the one option the
    port refuses."""
    if args.platform:
        raise UsageError("--platform (use --device) is not yet ported to "
                         "hipstr_tpu_torch")


def resolve_host_workers(n: int, device, n_cores: int) -> int:
    """--host-workers as the JAX CLI resolves it: a given count stays; the
    default -1 pools min(4, n_cores - 2) workers on the card when at least
    6 cores are free to this process, and runs in-process (1) otherwise."""
    if n >= 0:
        return n
    if device.type == "cuda" and n_cores >= 6:
        return min(4, n_cores - 2)
    return 1


# ------------------------------------------------------------- --workers N
def strip_shard_options(argv):
    """`argv` without --workers and the per-shard outputs (--str-vcf,
    --stutter-out, --viz-out, --locus-shard), with their values."""
    out, i = [], 0
    while i < len(argv):
        tok = argv[i]
        if tok.split("=", 1)[0] in ("--workers", "--str-vcf", "--stutter-out",
                                    "--viz-out", "--locus-shard"):
            i += 1 if "=" in tok else 2
            continue
        out.append(tok)
        i += 1
    return out


def visible_cards(device_name: str):
    """The card ids children take in turn, or [] when they share what the
    parent sees (the CPU, or one card).  Counting the cards creates no CUDA
    context in this process."""
    if device_name != "cuda":
        return []
    resolve_device(device_name)          # raises without a card
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        return []
    env = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    ids = [x.strip() for x in env.split(",") if x.strip()] if env else []
    return (ids or [str(k) for k in range(n)])[:n]


def worker_commands(args, argv):
    """[(command, environment, (vcf, models, viz) shard paths)] of the
    `--workers` children: `python -m hipstr_tpu_torch.cli` on locus shard
    i/N with this run's --device and --host-workers 1 (a --host-workers on
    the command line comes later and wins), card i mod n of n > 1."""
    n = args.workers
    base = strip_shard_options(list(argv if argv is not None
                                     else sys.argv[1:]))
    cards = visible_cards(args.device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = []
    for i in range(n):
        cmd = [sys.executable, "-m", "hipstr_tpu_torch.cli", "--device",
               args.device, "--host-workers", "1", *base, "--locus-shard",
               f"{i}/{n}"]
        paths = tuple(f"{p}.shard{i}" if p else None for p in (
            args.str_vcf, args.stutter_out, args.viz_out))
        for opt, p in zip(("--str-vcf", "--stutter-out", "--viz-out"),
                          paths):
            if p:
                cmd += [opt, p]
        child_env = dict(env)
        if cards:
            child_env["CUDA_VISIBLE_DEVICES"] = cards[i % len(cards)]
        out.append((cmd, child_env, paths))
    return out


def run_workers(args, argv) -> int:
    """--workers N: N children of this CLI over locus shards, their outputs
    merged (hipstr_tpu/cli.py::_run_workers).  A child that fails fails the
    run: nothing is merged and the exit code is 1."""
    refuse_unported(args)
    if args.pass_bam or args.filt_bam:
        raise UsageError("--workers is incompatible with "
                         "--pass-bam/--filt-bam")
    children = worker_commands(args, argv)
    procs = [subprocess.Popen(cmd, env=env) for cmd, env, _ in children]
    codes = [p.wait() for p in procs]
    failed = [(i, rc) for i, rc in enumerate(codes) if rc]
    if failed:
        print(f"ERROR: --workers children failed (child, exit code): "
              f"{failed}; no outputs merged", file=sys.stderr)
        return 1
    merge_shard_outputs(args.str_vcf, args.stutter_out, args.viz_out,
                        [paths for _, _, paths in children])
    return 0


def merge_shard_outputs(str_vcf, stutter_out, viz_out, shard_paths) -> None:
    """Merge per-shard outputs (VCF re-sorted with header from shard 0,
    stutter-model files unioned, viz rows re-sorted); shards deleted
    (hipstr_tpu/cli.py::merge_shard_outputs)."""
    from .io.bgzf import BgzfReader, BgzfWriter
    if str_vcf:
        from .io.vcf_write import VCFWriter

        def read_shard(path):
            if path.endswith(".gz"):
                text = BgzfReader(path).read_all().decode()
            else:
                text = open(path).read()
            lines = text.splitlines()
            return ([l for l in lines if l.startswith("#")],
                    [l for l in lines if l and not l.startswith("#")])

        header0, all_recs = read_shard(shard_paths[0][0])
        for sv, _, _ in shard_paths[1:]:
            all_recs.extend(read_shard(sv)[1])
        writer = VCFWriter(str_vcf, "\n".join(header0) + "\n")
        for line in sorted(all_recs,
                           key=lambda l: (l.split("\t", 2)[0],
                                          int(l.split("\t", 2)[1]))):
            cols = line.split("\t", 2)
            writer.add_vcf_record(cols[0], int(cols[1]), line)
        writer.close()
    if stutter_out:
        from .models.stutter import read_stutter_models, write_stutter_models
        merged = {}
        for _, so, _ in shard_paths:
            with open(so) as fh:
                merged.update(read_stutter_models(fh))
        with open(stutter_out, "w") as fh:
            write_stutter_models(merged, fh)
    if viz_out:
        lines = []
        for _, _, vz in shard_paths:
            lines.extend(BgzfReader(vz).read_all().decode().splitlines())
        lines.sort(key=lambda l: (l.split("\t", 2)[0],
                                  int(l.split("\t", 2)[1])))
        w = BgzfWriter(viz_out)
        for line in lines:
            w.write((line + "\n").encode())
        w.close()
    for group in shard_paths:
        for pth in group:
            for f in (pth, pth and pth + ".tbi"):
                if f and os.path.exists(f):
                    os.remove(f)


# --------------------------------------------------------------- --profile
@contextlib.contextmanager
def profiling(trace_dir, device, logger):
    """torch.profiler over the block (CPU, and CUDA on the card), its trace
    written into `trace_dir` by tensorboard_trace_handler (a file named by
    host and pid, so processes sharing the directory keep their own).  A
    trace that cannot be written raises."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
    logger.log(f"torch profiler trace written to {trace_dir}")


# ----------------------------------------------------------- --distributed
@contextlib.contextmanager
def process_group(args):
    """(rank, world size) of this process in the --distributed gloo group
    (parallel/distributed.py) for the block, left on every exit; None
    without --distributed.  A command line that names no group to join, or
    that also gives --locus-shard, raises UsageError."""
    if not args.distributed:
        yield None
        return
    if args.locus_shard:
        raise UsageError("--distributed assigns locus shards itself; drop "
                         "--locus-shard")
    from .parallel import distributed
    try:
        rank = distributed.init(args.coordinator, args.num_processes,
                                args.process_id)
    except distributed.RendezvousError as exc:
        raise UsageError(str(exc)) from None
    try:
        yield rank
    finally:
        distributed.shutdown()


# ------------------------------------------------------------------- run
def run(argv=None, devices=None):
    """run_args() on the parsed `argv`."""
    return run_args(build_parser().parse_args(argv), devices)


def run_args(args, devices=None):
    """Run the pooled, batched or (`--batch-loci 0`) sequential pipeline,
    as one rank of a process group with `--distributed`; returns
    (pipeline, this process's counters).  The batched runs shard each
    dispatch over `devices` (torch devices, repeats allowed: several shards
    may share one card or the CPU), by default every visible card of
    `--device cuda` (a `--distributed` rank's own card); the sequential
    run and the device EM use the first.  Raises UsageError for a refused
    command line; device and kernel errors propagate."""
    refuse_unported(args)
    final_outputs = (args.str_vcf, args.stutter_out, args.viz_out)
    with process_group(args) as rank:
        device, _ = resolve(args.device, args.dtype)
        if rank is not None:
            from .parallel import distributed
            device = distributed.place(device, rank[0])
            args.locus_shard = f"{rank[0]}/{rank[1]}"
            # every rank writes shard files; rank 0 merges after a barrier
            args.str_vcf, args.stutter_out, args.viz_out = (
                f"{p}.dshard{rank[0]}" if p else None for p in final_outputs)

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
        host_workers = resolve_host_workers(
            args.host_workers, device, len(os.sched_getaffinity(0)))
        command = " ".join(sys.argv)
        with profiling(args.profile, device, logger):
            if host_workers > 1 and args.batch_loci > 0 and not (
                    args.pass_bam or args.filt_bam):
                # host worker pool: per-locus host phases in N processes, this
                # one owns the device (parallel/workers.py)
                from .parallel.workers import run_pooled
                worker_spec = dict(bam_paths=bam_paths,
                                   fasta_path=args.fasta,
                                   opts=copy.deepcopy(opts),
                                   bam_samps=bam_samps, bam_libs=bam_libs,
                                   lib_field=args.lib_field)
                counters = run_pooled(pipeline, args.regions, args.str_vcf,
                                      device, worker_spec,
                                      n_workers=host_workers,
                                      batch_size=args.batch_loci,
                                      full_command=command, devices=devices)
            elif args.batch_loci > 0:
                from .parallel.executor import run_batched
                counters = run_batched(pipeline, args.regions, args.str_vcf,
                                       device, batch_size=args.batch_loci,
                                       full_command=command, devices=devices)
            else:
                from .pipeline.sequential import run_sequential
                counters = run_sequential(
                    pipeline, args.regions, args.str_vcf,
                    devices[0] if devices else device, full_command=command)
        logger.quiet = args.silent
        logger.log(pipeline.timer.summary())
        vals = [counters.genotype_success, counters.genotype_fail,
                counters.too_few_reads, counters.too_many_reads,
                counters.too_long, counters.em_fail, counters.missing_model]
        tag = ""
        if rank is not None:
            vals = distributed.sum_counters(vals)
            tag = f"[{rank[0]}/{rank[1]}] global "
        logger.log(
            f"{tag}Summary: success={vals[0]} fail={vals[1]} "
            f"too_few_reads={vals[2]} too_many_reads={vals[3]} "
            f"too_long={vals[4]} em_fail={vals[5]} missing_model={vals[6]}")
        if rank is not None:
            distributed.barrier()
            if rank[0] == 0:
                merge_shard_outputs(*final_outputs, [
                    tuple(f"{p}.dshard{r}" if p else None
                          for p in final_outputs)
                    for r in range(rank[1])])
        if args.log:
            log_stream.close()
        return pipeline, counters


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.workers > 1:
            return run_workers(args, argv)
        run_args(args)
    except UsageError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
