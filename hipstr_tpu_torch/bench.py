"""Benchmark of the port: end-to-end and kernel throughput on the cards.

    python -m hipstr_tpu_torch.bench [--device cuda|cpu] [--runs N]
        [--host-workers N] [--em] [--dtype float32|float64]
        [--loci 100] [--reads 20] [--deep-loci 60] [--deep-reads 170]
        [--batch-loci 32]

Counterpart of the JAX package's bench.py.  Prints ONE JSON line.  Its
headline is end-to-end pipeline throughput (BAM decode -> filters ->
device HMM and posteriors -> adaptive rounds -> VCF write) through the
production batched executor (or the host worker pool), each dispatch
sharded over every visible card, on simulated trio
loci, the configuration of tools/reference_baseline.json (3 samples x 20
reads x 70 bp, the default stutter model, --use-unpaired).  Two
workloads: shallow (`--loci` x 3 samples x `--reads`) and deep, the
headline (`--deep-loci` x 3 x `--deep-reads`, ~30x trio).  Each gets a
warm pass over its first loci, in-process, and then `--runs` timed
passes: each pass's loci/s, their median and their spread ([min, max]).

Keys beside the headline:
  * kernel_ms_per_locus / kernel_deep_ms_per_locus: one production
    dispatch (K1 emission + K2 segment per orientation, the seed
    combination, the fused posteriors) of `--batch-loci` copies of one
    locus at the shallow and deep shapes, on the first card alone: the
    card's timeline over back-to-back dispatches (CUDA events, after a
    warm-up, host-to-device copies included) per locus.  Not measured
    (null) on the CPU;
  * device_wait_s / host_s: the executor's "Device fetch" timer and the
    rest of the wall; worker_start_s: the pool's spawn to first reply;
  * fetch_ms: a small host -> device -> host round trip (null on the CPU);
  * max_rss_mb, peak_device_mib (torch.cuda.max_memory_allocated, the
    largest of the cards');
  * dispatches, card_shards and launches: every batched dispatch of the
    bench (warm and timed passes and the kernel timing), the card-shards
    they were cut into, and every kernel launch, so each card-shard's two
    K1 and two K2 launches can be checked;
  * device: the card's name and power limit (nvidia-smi), `cards` (the
    number of cards the dispatches were sharded over) and the host's CPU
    model.

The card is the default; without one the run raises.  `--device cpu`
runs the plain PyTorch versions on the host.  A pooled run
(`--host-workers` > 1, or the default -1 on a card host with >= 6 cores)
spawns its workers: call `main` from under a `__main__` guard.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import tempfile
import time

import torch

from . import kernels
from .cli import resolve_host_workers
from .device import local_devices, resolve
from .io.regions import read_regions
from .models.stutter import StutterModel
from .pipeline.processor import GenotyperPipeline, Logger, PipelineOptions
from .utils.simdata import trio_loci, write_sim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_BASELINE = os.path.join(ROOT, "tools", "reference_baseline.json")
DEFAULT_MODEL = (0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2)
KERNEL_REPS = 10     # back-to-back dispatches per kernel timing
WARM_LOCI = 4        # loci of a workload's warm pass


def reference_rates():
    """(ref_loci_per_sec, ref_deep_loci_per_sec) of the reference binary,
    from tools/reference_baseline.json; (None, None) without it."""
    try:
        with open(REFERENCE_BASELINE) as fh:
            ref = json.load(fh)
    except (OSError, ValueError):
        return None, None
    return ref.get("ref_loci_per_sec"), ref.get("ref_deep_loci_per_sec")


def write_dataset(tmp: str, n_loci: int, reads_per_sample: int) -> None:
    """bench.py's dataset: trio loci with seeds 31000 + i."""
    write_sim(tmp, trio_loci(n_loci, reads_per_sample))


def bench_options(dtype: str = "float32", em: bool = False,
                  max_regions: int = PipelineOptions.max_regions):
    """bench.py's options; `em` drops the stutter model (learned per
    locus, as the CLI does without --def-stutter-model)."""
    return PipelineOptions(
        min_reads=15, use_unpaired=True, dtype=dtype, max_regions=max_regions,
        def_stutter_model=None if em else StutterModel(*DEFAULT_MODEL))


def synchronize(device: torch.device) -> None:
    """Wait for every card of `device` (those the dispatches use)."""
    if device.type == "cuda":
        for card in local_devices(device):
            torch.cuda.synchronize(card)


def run_e2e(tmp: str, device: torch.device, *, workers: int = 1,
            batch_size: int = 32, dtype: str = "float32", em: bool = False,
            max_regions: int = PipelineOptions.max_regions, out=None):
    """One full pipeline run over `tmp`'s dataset on `device`: in-process
    batched (`workers` 1) or the host worker pool.  Returns (wall s,
    counters, timer totals with the run's stats under "_run_stats")."""
    bam, fasta, bed = f"{tmp}/sim.bam", f"{tmp}/sim.fa", f"{tmp}/regions.bed"
    out = out or f"{tmp}/out.vcf"
    p = GenotyperPipeline([bam], fasta, bench_options(dtype, em, max_regions),
                          Logger(quiet=True))
    synchronize(device)
    t0 = time.perf_counter()
    if workers > 1:
        from .parallel.workers import run_pooled
        spec = dict(bam_paths=[bam], fasta_path=fasta,
                    opts=bench_options(dtype, em, max_regions),
                    bam_samps=None, bam_libs=None, lib_field="LB")
        counters = run_pooled(p, bed, out, device, spec, n_workers=workers,
                              batch_size=batch_size)
    else:
        from .parallel.executor import run_batched
        counters = run_batched(p, bed, out, device, batch_size=batch_size)
    synchronize(device)
    dt = time.perf_counter() - t0
    return dt, counters, dict(p.timer.totals, _run_stats=p.last_run_stats)


def bench_kernel(device: torch.device, dtype: str, reads_per_sample: int,
                 batch: int):
    """One production dispatch of `batch` copies of one locus (K1, K2, the
    seed combination, the fused posteriors).  Returns (ms per locus or
    None on the CPU, kernel shapes, dispatches made)."""
    from .parallel.executor import BatchedAligner, LocusWorkItem
    from .pipeline.hap_aligner import prepare_locus
    with tempfile.TemporaryDirectory(prefix="hipstr_torch_kbench_") as tmp:
        write_dataset(tmp, 1, reads_per_sample)
        p = GenotyperPipeline([f"{tmp}/sim.bam"], f"{tmp}/sim.fa",
                              bench_options(dtype), Logger(quiet=True))
        region = read_regions(f"{tmp}/regions.bed", 10, "", None)[0]
        g = p.prepare_locus_genotyper(region,
                                      p.fasta.get_sequence(region.chrom))
        seqs, quals, seeds = g.pool_inputs()
        arrays, statics = prepare_locus(g.align_haplotype(), seqs, quals,
                                        seeds, dtype,
                                        post_meta=g.posterior_meta())
    card = local_devices(device)[0]
    aligner = BatchedAligner([card], dtype, batch)
    chunk = [LocusWorkItem(arrays, statics) for _ in range(batch)]
    aligner._dispatch_chunk(chunk)           # warm-up
    synchronize(device)
    ms = None
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(card)
        start.record(stream)
        for _ in range(KERNEL_REPS):
            aligner._dispatch_chunk(chunk)
        end.record(stream)
        torch.cuda.synchronize(card)
        ms = start.elapsed_time(end) / KERNEL_REPS / batch
    seg, meta = arrays[0], arrays[2]
    shapes = dict(P=seg.codes.shape[0], L=seg.codes.shape[1],
                  R=statics[0] + statics[1], H=meta.row_char.shape[0],
                  O=meta.rep_len.shape[0], B=meta.rep_rev_codes.shape[1])
    return ms, shapes, aligner.dispatches


def spec_keys(stats) -> dict:
    """Speculation and rounds telemetry: the hit rate of allele-addition
    rounds served by the speculative column gather, and the histogram of
    device rounds per locus."""
    if not stats:
        return {"spec_hit_rate": None, "rounds_hist": None}
    hits, misses = stats.get("spec_hits", 0), stats.get("spec_misses", 0)
    total = hits + misses
    return {
        "spec_hit_rate": round(hits / total, 3) if total else None,
        "rounds_hist": {str(k): v for k, v in
                        sorted(stats.get("round_hist", {}).items())},
    }


def fetch_ms(device: torch.device):
    """Best of 5 small host -> device -> host round trips, in ms; None on
    the CPU."""
    if device.type != "cuda":
        return None
    x = torch.ones((8, 128))
    (x.to(device) * 1.000001).cpu()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        (x.to(device) * 1.000001).cpu()
        best = min(best, time.perf_counter() - t0)
    return 1000 * best


def host_cpu() -> str:
    """The host CPU: /proc/cpuinfo's model name or, where the kernel
    reports it as "unknown" (a gVisor guest does), its vendor, family,
    model and clock."""
    import platform
    fields = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, sep, value = line.partition(":")
                if not sep:
                    break                    # the first processor only
                if value.strip() not in ("", "unknown"):
                    fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    if "model name" in fields:
        return fields["model name"]
    ident = ", ".join(f"{k} {fields[k]}" for k in (
        "vendor_id", "cpu family", "model", "cpu MHz") if k in fields)
    return ident or platform.machine() or "unknown"


def device_info(device: torch.device) -> dict:
    """The device a run measured: on the card its name and the name and
    power limit nvidia-smi reports; always the host's CPU model."""
    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "cards": len(local_devices(device)),
            "host_cpu": host_cpu(), "cores": len(os.sched_getaffinity(0))}
    if device.type == "cuda":
        info["name"] = torch.cuda.get_device_name(local_devices(device)[0])
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True)
        info["nvidia_smi"] = out.stdout.strip().splitlines()[0]
    return info


def max_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def reset_peak_device(device: torch.device) -> None:
    """Reset the peak memory of every card of `device`.  CUDA is
    initialised first: a reset on a card named by index does not do it,
    and fails in a fresh process."""
    if device.type == "cuda":
        torch.cuda.init()
        for card in local_devices(device):
            torch.cuda.reset_peak_memory_stats(card)


def peak_device_mib(device: torch.device):
    """The largest peak of device memory over the cards, in MiB; None on
    the CPU."""
    if device.type != "cuda":
        return None
    return max(torch.cuda.max_memory_allocated(card)
               for card in local_devices(device)) / 2 ** 20


def measure(tmp: str, n_loci: int, device: torch.device, args,
            workers: int) -> dict:
    """One warm pass (in-process, on the first WARM_LOCI loci: the
    kernels, the CUDA context and the allocator; a pool's workers never
    touch the card), then `args.runs` timed passes of one workload."""
    kw = dict(batch_size=args.batch_loci, dtype=args.dtype, em=args.em)
    _, _, times = run_e2e(tmp, device, max_regions=WARM_LOCI, **kw)
    kw["workers"] = workers
    dispatches = times["_run_stats"]["dispatches"]
    shards = times["_run_stats"]["card_shards"]
    rates, waits, hosts, starts, counts = [], [], [], [], []
    for _ in range(args.runs):
        dt, counters, times = run_e2e(tmp, device, **kw)
        dispatches += times["_run_stats"]["dispatches"]
        shards += times["_run_stats"]["card_shards"]
        # with concurrent fetcher threads the summed fetch time can exceed
        # the wall; host_s is clamped accordingly
        wait = times.get("Device fetch", 0.0)
        rates.append(n_loci / dt)
        waits.append(wait)
        hosts.append(max(0.0, dt - wait))
        starts.append(times.get("Worker start", 0.0))
        counts.append(counters)
    return dict(
        n_loci=n_loci, runs=rates,
        median=statistics.median(rates), spread=[min(rates), max(rates)],
        device_wait_s=statistics.median(waits),
        host_s=statistics.median(hosts),
        worker_start_s=statistics.median(starts),
        success=min(c.genotype_success for c in counts),
        fail=max(c.genotype_fail for c in counts),
        em_fail=max(c.em_fail for c in counts),
        dispatches=dispatches, card_shards=shards,
        spec=spec_keys(times.get("_run_stats")))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m hipstr_tpu_torch.bench",
        description="End-to-end and kernel throughput of the port; prints "
                    "one JSON line.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--runs", type=int, default=1,
                    help="timed passes per workload, after one warm pass")
    ap.add_argument("--host-workers", type=int, default=-1,
                    help="host worker processes (the CLI's default -1: a "
                         "pool of min(4, cores - 2) on a card host with >= 6 "
                         "cores, else in-process)")
    ap.add_argument("--em", action="store_true",
                    help="no stutter model: each locus's model is learned")
    ap.add_argument("--loci", type=int, default=100)
    ap.add_argument("--reads", type=int, default=20)
    ap.add_argument("--deep-loci", type=int, default=60,
                    help="0 skips the deep workload")
    ap.add_argument("--deep-reads", type=int, default=170)
    ap.add_argument("--batch-loci", type=int, default=32)
    return ap


def main(argv=None) -> dict:
    """Run the bench; prints its JSON line and returns it as a dict."""
    args = build_parser().parse_args(argv)
    if args.runs < 1 or args.loci < 1 or args.batch_loci < 1:
        raise ValueError("--runs, --loci and --batch-loci must be >= 1")
    device, _ = resolve(args.device, args.dtype)
    workers = resolve_host_workers(args.host_workers, device,
                                   len(os.sched_getaffinity(0)))
    reset_peak_device(device)
    launches0 = dict(kernels.LAUNCHES)
    ref, ref_deep = reference_rates()

    with tempfile.TemporaryDirectory(prefix="hipstr_torch_bench_") as tmp:
        write_dataset(tmp, args.loci, args.reads)
        shallow = measure(tmp, args.loci, device, args, workers)
    deep = None
    if args.deep_loci:
        with tempfile.TemporaryDirectory(prefix="hipstr_torch_deep_") as tmp:
            write_dataset(tmp, args.deep_loci, args.deep_reads)
            deep = measure(tmp, args.deep_loci, device, args, workers)

    kernel_ms, shapes, n_kd = bench_kernel(device, args.dtype, args.reads,
                                           args.batch_loci)
    deep_ms = deep_shapes = None
    if args.deep_loci:
        deep_ms, deep_shapes, n = bench_kernel(device, args.dtype,
                                               args.deep_reads,
                                               args.batch_loci)
        n_kd += n
    launches = {k: kernels.LAUNCHES[k] - launches0[k] for k in launches0}

    head = deep or shallow
    vs_shallow = shallow["median"] / ref if ref else None
    vs_deep = deep["median"] / ref_deep if deep and ref_deep else None
    hdl_reads = args.deep_reads if deep else args.reads
    info = device_info(device)
    result = {
        "metric": "end_to_end_loci_per_sec",
        "value": head["median"],
        "unit": "loci/s (full pipeline: BAM->filters->device->VCF; "
                "3 samples x %d reads%s, %s, %s, %d device(s); median of "
                "%d runs)" % (hdl_reads,
                              " [30x-trio headline]" if deep else "",
                              "EM" if args.em else "def-stutter", args.dtype,
                              info["cards"], args.runs),
        "vs_baseline": vs_deep if deep else vs_shallow,
        "n_loci": head["n_loci"],
        "success": head["success"],
        "fail": head["fail"],
        "em_fail": head["em_fail"],
        "device_wait_s": head["device_wait_s"],
        "host_s": head["host_s"],
        "worker_start_s": head["worker_start_s"],
        "loci_per_sec_runs": head["runs"],
        "loci_per_sec_spread": head["spread"],
        "shallow_loci_per_sec": shallow["median"],
        "shallow_loci_per_sec_runs": shallow["runs"],
        "shallow_loci_per_sec_spread": shallow["spread"],
        "vs_baseline_shallow": vs_shallow,
        "shallow_host_s": shallow["host_s"],
        "shallow_device_wait_s": shallow["device_wait_s"],
        "shallow_worker_start_s": shallow["worker_start_s"],
        "shallow_n_loci": shallow["n_loci"],
        "shallow_success": shallow["success"],
        "shallow_fail": shallow["fail"],
        "kernel_ms_per_locus": kernel_ms,
        "kernel_deep_ms_per_locus": deep_ms,
        "kernel_shapes": shapes,
        "kernel_deep_shapes": deep_shapes,
        "fetch_ms": fetch_ms(device),
        **head["spec"],
        "host_workers": workers,
        "runs": args.runs,
        "dtype": args.dtype,
        "em": args.em,
        "batch_loci": args.batch_loci,
        "max_rss_mb": max_rss_mb(),
        "peak_device_mib": peak_device_mib(device),
        "dispatches": shallow["dispatches"] + (deep["dispatches"] if deep
                                               else 0) + n_kd,
        "card_shards": shallow["card_shards"] + (deep["card_shards"] if deep
                                                 else 0) + n_kd,
        "launches": launches,
        "platform": info["platform"],
        "device": info,
        "ref_loci_per_sec": ref,
        "ref_deep_loci_per_sec": ref_deep,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
