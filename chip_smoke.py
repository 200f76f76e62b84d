#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hipstr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. environment: torch/CUDA/nvcc versions, triton, the card's name and
     power limit, whether the native host library loaded;
  2. build: the four CUDA kernels (K1 emission, K2 segment, K4 flank scan,
     K3 fused segment) from hipstr_tpu_torch/csrc, one nvcc each, all at
     once; ptxas's registers, stack frame and spills of every kernel
     instance;
  3. each kernel against its plain PyTorch version on the card, float32
     and float64, at the main-path shape and a deep shape, with times (K4
     and K3 by `event_ms`: their one-locus launches are shorter than the
     wrapper's host time); K1 and K2 at L = 384 and 512; K4 and K3 at
     every L bucket (64 .. 512);
  4. the batched slice: `hipstr_tpu_torch.cli` in-process on 60 simulated
     30x trio loci (float32, --batch-loci 32); 60/60 genotyped, K1 and K2
     launched at least twice per dispatch, K3 and K4 never, JAX never
     imported;
  5. the sequential slice: the same run with --batch-loci 0; 60/60
     genotyped, per aligner call two K1 and two K3 launches (fused mode,
     the sequential path's), no K2 or K4;
  6. the two per-locus modes, flank (K1 + K4, the stutter and
     forced-match rows in plain torch) against fused (K1 + K3): (a) the
     first-round alignment of each of the 60 real loci in float32 and
     float64, LL within 1e-8 (float64) or K3's float32 tolerance, ms per
     aligner call of each mode and type, and each mode's device kernels
     and copies per call under torch.profiler; (b) the sequential slice
     through the CLI in float32, 3 runs of each mode in turn (flank mode
     by a wrapper around the genotyper's aligner call, `flank_mode`):
     loci/s and wall of each run, launches per aligner call, the fused
     VCF equal to phase 5's and held to the flank VCF (genotype and
     integer fields equal, floats within the drift bands);
  7. the stutter EM: the sequential run without a stutter model (host EM)
     on 8 loci; then (a) the batched slice of phase 4 without a stutter
     model, in-process: the models learned on the card (the device EM),
     60/60 loci settled (success + em_fail), K1 and K2 launched at least
     twice per dispatch, K3 and K4 never, and a second run under
     torch.profiler for the device-idle share; (b) the same run with the
     host worker pool (--host-workers 3): the same records, genotype and
     integer fields equal and floats within the drift bands, every worker
     with CUDA uninitialised and no JAX loaded; (c) on the slice's EM
     problems, the card's em_train_batch in float64 against the host EM on
     the CPU (equal converged flags and iterations, parameters within
     rtol 1e-8, atol 1e-10), float32's largest parameter difference, EM
     seconds per wave, and torch ops and kernel launches per iteration;
     (d) the float64 EM anchor: the reference dataset without a stutter
     model, in-process and pooled, against
     tests/data/torch_port_ref_em_f64.vcf;
  8. float64 cross-check: the port's VCF on the dataset behind
     tests/data/torch_port_ref_f64.vcf, batched (K1 + K2) and sequential
     (K1 + K3), against that file;
  9. real shapes: each kernel at the two launch shapes its path used most
     (K1 and K2 from phase 4's histogram, K3 from phase 5's, K4 from the
     flank mode over the slice's loci), on the arguments that path really
     passed (captured in a second run), float32 and float64: against its
     plain version, CUDA-event times over 20 launches with L2 warm and with
     L2 flushed (64 MiB written before each launch), and the bound the
     card allows for that work (`bound`);
 10. golden: every configuration of utils.simdata.GOLDEN_CONFIGS (the
     datasets and flags of the golden suites) through the CLI in float64
     batched and sequential and in float32 batched, each held to its
     float64 anchor tests/data/torch_port_golden_<name>_f64.vcf (records
     that differ logged, every record within the drift bands), fail 0,
     K1 + K2 (batched) or K1 + K3 (sequential) launched and no other;
 11. de novo: (a) the de novo golden suite's trio genotyped in float64
     against tests/data/torch_port_denovo_str_f64.vcf, then the
     DenovoFinder's trio and family scans with --device-batch 256
     byte-identical to tests/data/torch_port_denovo_{trio,family}_f64.vcf;
     (b) a synthetic 1000-record, 100-family cohort, both scans on the
     card (records/s, jobs, dispatches, every dispatch within
     denovo.likelihoods.DISPATCH_BYTES), its first 100 records also on the
     host path (`--device cpu --device-batch 0`, in two processes beside
     the card's runs) and equal;
 12. the rest of the CLI: (a) every CLI mode of the JAX tests
     (utils.simdata.MODE_CONFIGS: haploid, the stutter-model round trip,
     --skip-genotyping with pass/filt BAMs, --sample-list, --viz-out, an
     unspannable locus, --bam-samps, --ref-vcf, --locus-shard, CRAM) in
     float64 batched and sequential and float32 batched: float64 VCF bodies
     byte-identical to tests/data/torch_port_mode_<name>_f64.vcf and every
     other output to tests/data/torch_port_modes_f64.json (a models file
     learned by the device EM may differ in a printed digit only within
     rtol 1e-8 of the JAX host EM's), float32 within the drift bands, each
     mode's launches counted from 0; (b) on the reference dataset, one
     process without and with `--profile`, and `--workers 2` (both
     children on the card, each profiled): the bgzipped merge equal to
     tests/data/torch_port_ref_f64.vcf, its .tbi answering a query, no
     shard file left, every process's trace holding K1 and K2 events;
     (c) `--distributed` with two gloo ranks on the one card: the same
     body, the summed summary on both ranks, no shard file left; (d)
     `--profile` on the slice, batched and sequential: the VCF equal to
     phases 4 and 5's, the trace holding K1 + K2 or K1 + K3 events;
 13. the measuring entry points: (a) `hipstr_tpu_torch.bench --runs 3`
     (default model, shallow and deep) in-process and with the default
     --host-workers: every locus genotyped, two K1 and two K2 launches per
     dispatch, its JSON line printed; then a 4-locus bench in a fresh
     process (CUDA initialised by the bench itself); (b) the chromosome-scale soak
     (`hipstr_tpu_torch.tools.soak`) reduced to 1,000 loci x 20 samples x
     30 reads with phased SNPs, float32 in-process: every locus
     genotyped, max RSS and peak device memory flat from locus 500 (no
     100-locus band over 1.2x the first), two K1 and two K2 launches per
     dispatch; its 2-locus prefix in float64, batched (K1 + K2) and
     sequential (K1 + K3), byte-identical to
     tests/data/torch_port_soak_f64.vcf, and the float32
     run's first 2 records equal to it in genotypes and integer fields;
     (c) K1 and K2 on the soak's arguments at their most frequent launch
     shape (captured during (b)), float32 and float64, against the plain
     versions, timed beside the bound;
 14. the batched dispatch sharded over several devices (the JAX CLI's
     locus mesh): with `cli.run(..., devices=[card 0] * 2)` the slice in
     float32 (its VCF equal to phase 4's one-shard run) and the `default`
     golden configuration in float64 (byte-identical to its anchor), K1
     and K2 launched exactly twice per card-shard, a dispatch split.  With
     two or more visible cards the same runs over every card, each kernel
     against its plain version on the last card at phase 9's shapes
     (float32 and float64, at TOL: the per-device shared-memory
     attribute), and `graft_entry.dryrun_multichip` over every card; with
     one card a line says that this leg was not run.  Phases 4, 7 and 13
     count K1 and K2 per card-shard (a dispatch on one card is one).

The in-process runs of phases 4, 7(a), 8 and 9 pass --host-workers 1, so
their numbers stay comparable whatever the machine's core count.  After
every phase no module of JAX or of the JAX package may be loaded.
Prints the kernel summary as one JSON line (per kernel its real-shape
time, bound and share of the bound), then as the last line {"ok": true,
"device": {...}}.  Needs one visible CUDA card.

    python3 chip_smoke.py --cross-card

runs phase 14 alone (with phases 1, 2, 4, 5, 6 and 9's captures, which
it reads) on a host of two or more cards, so its cross-card leg runs.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_f64.vcf")
REF_EM_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_em_f64.vcf")
DENOVO_STR_VCF = os.path.join(ROOT, "tests", "data",
                              "torch_port_denovo_str_f64.vcf")
# phase 10's runs of each golden configuration: (label, dtype, mode flags)
GOLDEN_RUNS = (("f64 batched", "float64", ["--host-workers", "1"]),
               ("f64 sequential", "float64", ["--batch-loci", "0"]),
               ("f32 batched", "float32", ["--host-workers", "1"]))
COHORT_HOST_RECORDS = 100   # phase 11(b): records also run on the host path
HOST_WATCHDOG_S = 600       # phase 11(b)'s host processes take well under
SLICE_LOCI = 60
SLICE_READS = 170
# (rtol, atol) of kernel vs plain version.  float64: the kernels replay the
# plain arithmetic in another order (serial sums and an online log-sum-exp
# where the plain version uses prefix sums and a two-pass max), so only
# rounding differs.  float32: the same reassociation over sums of up to
# Bmax (K1) or ~R rows x L lanes (K2) terms of magnitude up to ~1e3
# accumulates ~n * 2^-24 relative error, ~1e-4 at these depths.
# K4 and K3 follow the rows of the plain version in the same order (f64
# 1e-9 and 1e-8, the tolerances of tests/test_pallas_hmm.py), and share
# K2's float32 bound.
TOL = {("emission", "float64"): (1e-10, 1e-10),
       ("segment", "float64"): (1e-8, 1e-8),
       ("flank_scan", "float64"): (1e-9, 1e-9),
       ("segment_scan", "float64"): (1e-8, 1e-8),
       ("emission", "float32"): (1e-4, 1e-3),
       ("segment", "float32"): (1e-4, 1e-3),
       ("flank_scan", "float32"): (1e-4, 1e-3),
       ("segment_scan", "float32"): (1e-4, 1e-3)}
MAIN = dict(G=32, O=8, P=64, L=128, Bmax=64, H=8)
DEEP = dict(MAIN, P=256)
# K1/K2 past 8 lanes a thread: other kernel instances (K2 keeps float64
# lane constants in shared memory, K1 one thread per lane in float64)
WIDE = (dict(MAIN, G=8, P=16, L=384), dict(MAIN, G=8, P=16, L=512))
SCAN_DEEP_P = 1024   # K3/K4 deep shape: the largest pool bucket
MODES_TOL = 1e-8     # flank vs fused LL, float64 (rtol and atol)
SEQ_MODE_RUNS = 3    # phase 6: sequential slice runs of each mode, in turn
EM_LOCI = 8
EM_POOL_WORKERS = 3
EM_BATCH = 32        # the slice's --batch-loci: the EM's wave size
EM_TOL = (1e-8, 1e-10)   # card f64 EM vs host EM (tests/test_em_batched.py)
POOL_WATCHDOG_S = 300    # a pooled run of the slice takes well under this
SCALE_WATCHDOG_S = 300   # phase 12's --workers and --distributed commands
# phase 13: the bench (each of its two calls: warm + 3 timed passes of both
# workloads), and the reduced soak with its memory bound
BENCH_ARGS = ["--runs", "3"]
BENCH_WATCHDOG_S = 400
SOAK_LOCI, SOAK_SAMPLES, SOAK_READS = 1000, 20, 30
SOAK_BAND = 100          # loci per band of the soak's table
SOAK_WINDOW_S = 5.0      # seconds per throughput window
SOAK_FLAT_FROM = 500     # memory is held flat from this locus on
SOAK_FLAT = 1.2          # ... within this factor of the first full band
SOAK_VCF = os.path.join(ROOT, "tests", "data", "torch_port_soak_f64.vcf")
MODES_JSON = os.path.join(ROOT, "tests", "data", "torch_port_modes_f64.json")
# kernel -> (source, the TPU kernel it replaces); each is checked in phase 3
# and timed at its path's real launch shapes, beside its bound, in phase 9
SOURCES = {
    "emission": ("hipstr_tpu_torch/csrc/emission.cu",
                 "hipstr_tpu/ops/pallas_emission.py:62"),
    "segment": ("hipstr_tpu_torch/csrc/segment.cu",
                "hipstr_tpu/ops/pallas_hmm2.py:69"),
    "flank_scan": ("hipstr_tpu_torch/csrc/flank_scan.cu",
                   "hipstr_tpu/ops/pallas_hmm.py:55"),
    "segment_scan": ("hipstr_tpu_torch/csrc/segment_scan.cu",
                     "hipstr_tpu/ops/pallas_hmm.py:130"),
}
SENTINEL = -1.0e20   # values at or below are NEG-derived padding
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# float32 and float64 outside the tensor cores, and device memory
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
REAL_REPS = 20                  # launches per real-shape timing
FLUSH_BYTES = 64 << 20          # written before each L2-flushed launch
TOP_SHAPES = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def log_shapes(label: str, shapes: dict) -> None:
    """The launch-shape histogram of each kernel, most frequent first."""
    for name, hist in shapes.items():
        log(f"{label}: {name} shapes " + ", ".join(
            f"{s}x{n}" for s, n in hist.most_common()))


def check_no_jax() -> None:
    """Fail if JAX or any module of the JAX package is loaded."""
    loaded = [m for m, mod in sys.modules.items() if mod is not None and (
        m == "jax" or m.startswith("jax.") or m == "hipstr_tpu"
        or m.startswith("hipstr_tpu."))]
    if loaded:
        raise AssertionError(f"loaded: {sorted(loaded)[:10]}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def phase_env():
    import torch
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from hipstr_tpu_torch import kernels
    nvcc = kernels.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1]
    log(f"nvcc {nvcc}: {ver}")
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as exc:
        log(f"triton does not import: {exc}")
    card = nvidia_smi_line()
    log(card)
    from hipstr_tpu_torch import native
    log(f"native host library loaded: {native._load() is not None}")
    return card


# ---------------------------------------------------------------- phase 2
def ptxas_report(text: str):
    """Per kernel instance in nvcc's `-Xptxas -v` output: (instance,
    registers, stack frame bytes, spill store bytes, spill load bytes).
    The instance is the mangled name's kernel and template arguments, as
    `flank_scan_kernel<f,4,0>` (type f/d, lanes a thread, shared lanes)."""
    import re
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)I(.*?)EEv", m.group(1))
            args = re.findall(r"L[ib](\d+)E|^([fd])", k.group(2)) if k else []
            name = (f"{k.group(1)}<" + ",".join(a or b for a, b in args)
                    + ">") if k else m.group(1)
            cur = dict(instance=name, registers=None, stack=None,
                       spill_stores=None, spill_loads=None)
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def phase_build():
    from hipstr_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"built {len(kernels.LAUNCHES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    report = {}
    for name in kernels.LAUNCHES:
        info = kernels.BUILD_INFO[name]
        log(f"built {name}: nvcc {info['seconds']:.2f} s")
        report[name] = ptxas_report(info["ptxas"])
        for row in report[name]:
            log(f"  ptxas {row['instance']}: {row['registers']} registers, "
                f"{row['stack']} bytes stack frame, {row['spill_stores']} / "
                f"{row['spill_loads']} bytes spill stores / loads")
    # K4 and K3 carry their state in registers: say whether any instance
    # spilled or kept a stack frame
    heavy = [row["instance"] for name in ("flank_scan", "segment_scan")
             for row in report[name]
             if row["stack"] or row["spill_stores"] or row["spill_loads"]]
    log(f"ptxas: K4/K3 instances with a stack frame or spills: "
        f"{heavy or 'none'}")
    return report


# ---------------------------------------------------------------- phase 3
def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, ref, dtype_name: str) -> float:
    """Check got against ref within TOL; returns the max abs error over the
    log-likelihood-scale entries (ref > -1e6)."""
    import torch
    rtol, atol = TOL[(name, dtype_name)]
    real = ref > SENTINEL
    if not torch.equal(real, got > SENTINEL):
        raise AssertionError(f"{name} {dtype_name}: NEG sentinels differ")
    if not bool(torch.isfinite(got[real]).all()):
        raise AssertionError(f"{name} {dtype_name}: non-finite values")
    err = (got - ref).abs()
    bad = real & (err > atol + rtol * ref.abs())
    if bool(bad.any()):
        raise AssertionError(
            f"{name} {dtype_name}: {int(bad.sum())} entries beyond "
            f"rtol={rtol} atol={atol}; max err {float(err[real].max())}")
    scale = ref > -1.0e6
    return float(err[scale].max()) if bool(scale.any()) else 0.0


def reads(rng, G, P, L, device, period):
    """Random reads: codes (1% N), raw quality bytes, last columns that keep
    the stutter row's 6*period lanes of headroom."""
    import numpy as np
    import torch
    codes = rng.integers(0, 4, (G, P, L)).astype(np.int8)
    codes[rng.random((G, P, L)) < 0.01] = 4
    quals = rng.integers(35, 75, (G, P, L)).astype(np.uint8)
    last = rng.integers(L // 4, L - 6 * period, (G, P)).astype(np.int32)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(quals).to(device),
            torch.from_numpy(last).to(device))


def to_device(x, device, dt):
    import numpy as np
    import torch
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t.to(dt) if t.is_floating_point() else t


def check_emission(shape, dtype_name, device, rng):
    import numpy as np
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.hmm import expand_quals
    from hipstr_tpu_torch.ops.stutter_emission import stutter_emissions_plain
    G, O, P, L, B = (shape[k] for k in ("G", "O", "P", "L", "Bmax"))
    dt = resolve_dtype(dtype_name)
    codes, quals, _ = reads(rng, G, P, L, device, 4)
    blw, blc = expand_quals(quals, dt)
    codes = codes.int()
    brev = torch.from_numpy(rng.integers(0, 4, (G, O, B)).astype(np.int32)
                            ).to(device)
    blen_np = rng.integers(1, B + 1, (G, O)).astype(np.int32)
    blen_np[:, -1] = 0                      # a padded option in every locus
    blen = torch.from_numpy(blen_np).to(device)
    periods = torch.from_numpy(rng.integers(1, 5, G).astype(np.int32)
                               ).to(device)
    args = (codes, blw, blc, brev, blen, periods)
    got = stutter_emissions(*args)
    ref = stutter_emissions_plain(*args)
    torch.cuda.synchronize()
    err = compare("emission", got, ref, dtype_name)
    ms = cuda_ms(lambda: stutter_emissions(*args), 5)
    plain_ms = cuda_ms(lambda: stutter_emissions_plain(*args), 2)
    return err, ms, plain_ms, bound_emission(args, {}, dtype_name)["bound_ms"]


def real_locus(tmp):
    """One real locus of the slice's dataset, packed through the main
    path's host code and prepare_locus: (arrays, statics)."""
    from hipstr_tpu_torch.io.regions import read_regions
    from hipstr_tpu_torch.models.stutter import StutterModel
    from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline,
                                                     Logger, PipelineOptions)
    from hipstr_tpu_torch.pipeline.hap_aligner import prepare_locus
    opts = PipelineOptions(
        min_reads=15, use_unpaired=True, dtype="float32",
        def_stutter_model=StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2))
    p = GenotyperPipeline([f"{tmp}/sim.bam"], f"{tmp}/sim.fa", opts,
                          Logger(quiet=True))
    region = read_regions(f"{tmp}/regions.bed", 1)[0]
    g = p.prepare_locus_genotyper(region, p.fasta.get_sequence(region.chrom))
    seqs, quals, seeds = g.pool_inputs()
    return prepare_locus(g.align_haplotype(), seqs, quals, seeds, "float32")


def check_segment(shape, dtype_name, device, rng, fw, statics):
    """K2 at `shape` with the row structure (R, stutter row, active rows,
    transitions, repeat options) of a real prepared locus, random reads."""
    import numpy as np
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.hmm import expand_quals
    from hipstr_tpu_torch.ops.hmm2 import (segment_args, segment_forward_plain,
                                           segment_kernel)
    from hipstr_tpu_torch.pipeline.hap_aligner import stack_arrays
    G, O, P, L, B, H = (shape[k] for k in ("G", "O", "P", "L", "Bmax", "H"))
    R, sr, period, H_real = statics[0], statics[2], statics[4], statics[6]
    dt = resolve_dtype(dtype_name)
    hi = np.arange(H) % fw.row_char.shape[0]
    o_n = min(O, fw.rep_rev_codes.shape[0])
    b_n = min(B, fw.rep_rev_codes.shape[1])
    rep = np.zeros((O, B), np.int32)
    rep[:o_n, :b_n] = fw.rep_rev_codes[:o_n, :b_n]
    rep_len = np.zeros(O, np.int32)
    rep_len[:o_n] = np.minimum(fw.rep_len[:o_n], B)
    lpmf = np.zeros((O, fw.lpmf.shape[1]))
    lpmf[:o_n] = fw.lpmf[:o_n]
    meta = type(fw)(row_char=fw.row_char[hi], row_m2m=fw.row_m2m[hi],
                    row_m2i=fw.row_m2i[hi], row_m2d=fw.row_m2d[hi],
                    rep_rev_codes=rep, rep_len=rep_len, lpmf=lpmf,
                    hap_opt=fw.hap_opt[hi] % o_n, row_active=fw.row_active)
    tmeta = type(fw)(*[to_device(x, device, dt)
                       for x in stack_arrays([meta] * G)])
    codes, quals, last = reads(rng, G, P, L, device, period)
    h_real_np = np.where(np.arange(G) % 2 == 0, min(H_real, H), H)
    h_real = torch.from_numpy(h_real_np.astype(np.int32)).to(device)
    periods = torch.full((G,), period, dtype=torch.int32, device=device)
    blw, blc = expand_quals(quals, dt)
    E = stutter_emissions(codes.int().contiguous(), blw, blc,
                          tmeta.rep_rev_codes.int().contiguous(),
                          tmeta.rep_len.int().contiguous(), periods)
    args, _ = segment_args(codes, quals, last, tmeta, E, R, sr, h_real,
                           periods, dt)
    got = segment_kernel(*args, R=R, sr=sr)
    ref = segment_forward_plain(*args, R=R, sr=sr)
    torch.cuda.synchronize()
    err = compare("segment", got, ref, dtype_name)
    ms = cuda_ms(lambda: segment_kernel(*args, R=R, sr=sr), 5)
    plain_ms = cuda_ms(lambda: segment_forward_plain(*args, R=R, sr=sr), 2)
    b = bound_segment(args, dict(R=R, sr=sr), dtype_name)["bound_ms"]
    return err, ms, plain_ms, b, R


def scan_inputs(P, dtype_name, device, rng, arrays, statics, L=None):
    """K4/K3 inputs with the forward row structure, H and repeat options of
    a real locus and P random reads of L lanes (the locus's own L by
    default)."""
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    from hipstr_tpu_torch.ops.hmm import HapMeta, expand_quals, shift_right
    dt = resolve_dtype(dtype_name)
    R, sr, period = statics[0], statics[2], statics[4]
    L = L or arrays[0].codes.shape[1]
    codes, quals, last = (x[0] for x in reads(rng, 1, P, L, device, period))
    blw, blc = expand_quals(quals, dt)
    C = torch.cumsum(blc, dim=-1)
    meta = HapMeta(*[to_device(x, device, dt) for x in arrays[2]])
    return ((codes.int().contiguous(), blw, blc, C, shift_right(C, 0.0),
             last.int().contiguous()), meta, R, sr, period)


def check_flank_scan(P, dtype_name, device, rng, arrays, statics, L=None):
    """K4 over the phase-1 rows of a real locus from its row-0 state."""
    from hipstr_tpu_torch.ops.hmm import IMPOSSIBLE, emit_locus
    from hipstr_tpu_torch.ops.hmm_scan import (flank_scan_kernel,
                                               flank_scan_plain)
    import torch
    rd, meta, R, sr, _ = scan_inputs(P, dtype_name, device, rng, arrays,
                                     statics, L)
    codes, blw, blc, C, Csh, _ = rd
    M = emit_locus(codes, meta.row_char[:, 0], blc, blw) + Csh[:, None]
    state = (M, C[:, None].expand(M.shape).contiguous(),
             torch.full_like(M, IMPOSSIBLE))
    rows = [x[:, 1:sr].T.contiguous() for x in (
        meta.row_char, meta.row_m2m, meta.row_m2i, meta.row_m2d)]
    args = (*rd, *rows, meta.row_active[1:sr], *state)
    got = flank_scan_kernel(*args)
    ref = flank_scan_plain(*args)
    torch.cuda.synchronize()
    err = max(compare("flank_scan", g, r, dtype_name)
              for g, r in zip(got, ref))
    # device time: a loop of wrapper calls would time the host at this size
    ms = event_ms(lambda: flank_scan_kernel(*args), 5)
    plain_ms = cuda_ms(lambda: flank_scan_plain(*args), 2)
    return err, ms, plain_ms, bound_flank_scan(args, {}, dtype_name)["bound_ms"]


def check_segment_scan(P, dtype_name, device, rng, arrays, statics,
                       L=None):
    """K3 over the forward orientation of a real locus (E from K1)."""
    import torch
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.hmm_scan import (segment_scan_kernel,
                                               segment_scan_plain)
    rd, meta, R, sr, period = scan_inputs(P, dtype_name, device, rng,
                                          arrays, statics, L)
    codes, blw, blc = rd[:3]
    periods = torch.full((1,), period, dtype=torch.int32, device=device)
    E = stutter_emissions(codes[None], blw[None], blc[None],
                          meta.rep_rev_codes.int()[None],
                          meta.rep_len.int()[None], periods)[0]
    args = (*rd, meta, E, R, sr, period)
    got = segment_scan_kernel(*args)
    ref = segment_scan_plain(*args)
    torch.cuda.synchronize()
    err = compare("segment_scan", got, ref, dtype_name)
    ms = event_ms(lambda: segment_scan_kernel(*args), 5)
    plain_ms = cuda_ms(lambda: segment_scan_plain(*args), 2)
    return err, ms, plain_ms, bound_segment_scan(args, {}, dtype_name)[
        "bound_ms"]


def timed(r) -> str:
    """(err, kernel ms, plain ms, bound ms) as one line's part."""
    err, ms, plain, b = r
    return (f"err {err:.3e} kernel {ms:.3f} ms plain {plain:.3f} ms bound "
            f"{b:.4f} ms ({100 * b / ms:.1f} %)")


def phase_kernels(device, tmp):
    import numpy as np
    arrays, statics = real_locus(tmp)
    P_real, L = arrays[0].codes.shape
    H, R = arrays[2].row_char.shape
    O = arrays[2].rep_len.shape[0]
    results = {}
    for label, shape, P in (("main", MAIN, P_real),
                            ("deep", DEEP, SCAN_DEEP_P)):
        for dtype_name in ("float32", "float64"):
            rng = np.random.default_rng(7)
            e = check_emission(shape, dtype_name, device, rng)
            *s, R2 = check_segment(shape, dtype_name, device, rng,
                                   arrays[2], statics)
            f = check_flank_scan(P, dtype_name, device, rng, arrays, statics)
            k3 = check_segment_scan(P, dtype_name, device, rng, arrays,
                                    statics)
            results[(label, dtype_name)] = dict(
                emission=e, segment=tuple(s), flank_scan=f, segment_scan=k3)
            log(f"{label} {dtype_name} G={shape['G']} O={shape['O']} "
                f"P={shape['P']} L={shape['L']} Bmax={shape['Bmax']} "
                f"H={shape['H']} R={R2}: emission {timed(e)} | segment "
                f"{timed(s)}")
            log(f"{label} {dtype_name} one locus P={P} H={H} L={L} O={O} "
                f"R={R} sr={statics[2]} period={statics[4]}: "
                f"flank_scan {timed(f)} | segment_scan {timed(k3)}")
    for shape in WIDE:
        for dtype_name in ("float32", "float64"):
            rng = np.random.default_rng(11)
            e = check_emission(shape, dtype_name, device, rng)
            s = check_segment(shape, dtype_name, device, rng, arrays[2],
                              statics)
            log(f"wide {dtype_name} G={shape['G']} P={shape['P']} "
                f"L={shape['L']}: emission err {e[0]:.3e} kernel "
                f"{e[1]:.3f} ms | segment err {s[0]:.3e} kernel "
                f"{s[1]:.3f} ms")
    # K4 and K3 have one instance per L bucket and type: each against its
    # plain version on the real locus's rows with reads of L lanes
    from hipstr_tpu_torch.kernels import WARP_LANES
    for L_b in WARP_LANES:
        for dtype_name in ("float32", "float64"):
            rng = np.random.default_rng(13)
            f = check_flank_scan(P_real, dtype_name, device, rng, arrays,
                                 statics, L_b)
            k3 = check_segment_scan(P_real, dtype_name, device, rng, arrays,
                                    statics, L_b)
            log(f"lanes {dtype_name} P={P_real} H={H} L={L_b}: flank_scan "
                f"err {f[0]:.3e} kernel {f[1]:.3f} ms | segment_scan err "
                f"{k3[0]:.3e} kernel {k3[1]:.3f} ms")
    return results


# ---------------------------------------------------------------- phase 4
def slice_args(tmp, mode, device_name="cuda"):
    """The slice's float32 run with the default model: `mode` is
    "batched" (in-process, --batch-loci 32) or "sequential"."""
    flags = (["--batch-loci", "32", "--host-workers", "1"]
             if mode == "batched" else ["--batch-loci", "0"])
    return ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
            "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--def-stutter-model", *flags, "--dtype",
            "float32", "--device", device_name, "--silent"]


def phase_slice(tmp, device_name="cuda"):
    import torch
    from hipstr_tpu_torch import cli, kernels
    args = slice_args(tmp, "batched", device_name)
    # warm the CUDA context and allocator on a few loci (not counted)
    cli.run(args + ["--str-vcf", f"{tmp}/warm.vcf", "--max-regions", "4"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipeline, counters = cli.run(args + ["--str-vcf", f"{tmp}/slice.vcf"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = {k: kernels.SHAPES[k].copy() for k in ("emission", "segment")}
    log_shapes("slice", shapes)
    dispatches = pipeline.last_run_stats["dispatches"]
    shards = pipeline.last_run_stats["card_shards"]
    device_wait = pipeline.timer.totals.get("Device fetch", 0.0)
    log(f"slice: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} dispatches={dispatches} "
        f"card-shards={shards} launches={launches}")
    log(f"slice: {SLICE_LOCI / wall:.3f} loci/s, wall {wall:.3f} s, "
        f"host {wall - device_wait:.3f} s, device wait {device_wait:.3f} s")
    log(pipeline.timer.summary())
    if counters.genotype_success != SLICE_LOCI or counters.genotype_fail:
        raise AssertionError("slice did not genotype every locus")
    for name in ("emission", "segment"):
        if launches[name] < 2 * shards:
            raise AssertionError(f"kernel {name}: {launches[name]} launches "
                                 f"for {shards} card-shards")
    for name in ("flank_scan", "segment_scan"):   # per-locus kernels only
        if launches[name]:
            raise AssertionError(f"kernel {name} launched on the batched "
                                 "path")
    check_no_jax()
    recs = vcf_body(f"{tmp}/slice.vcf")
    if len(recs) != SLICE_LOCI:
        raise AssertionError(f"slice VCF has {len(recs)} records")
    return launches, shapes, dict(loci_per_s=SLICE_LOCI / wall, wall_s=wall,
                                  host_s=wall - device_wait,
                                  device_wait_s=device_wait)


# ---------------------------------------------------------------- phase 5
def phase_sequential(tmp, device_name="cuda"):
    """The sequential run (--batch-loci 0) on the slice's loci."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.pipeline import hap_aligner
    args = slice_args(tmp, "sequential", device_name)
    cli.run(args + ["--str-vcf", f"{tmp}/seq_warm.vcf", "--max-regions",
                    "4"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    calls0 = hap_aligner.CALLS
    t0 = time.perf_counter()
    pipeline, counters = cli.run(args + ["--str-vcf", f"{tmp}/seq.vcf"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = {k: kernels.SHAPES[k].copy()
              for k in ("emission", "segment_scan")}
    log_shapes("sequential", shapes)
    n = hap_aligner.CALLS - calls0
    log(f"sequential: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} aligner calls={n} "
        f"launches={launches}")
    log(f"sequential: {SLICE_LOCI / wall:.3f} loci/s, wall {wall:.3f} s")
    log(pipeline.timer.summary())
    if counters.genotype_success != SLICE_LOCI or counters.genotype_fail:
        raise AssertionError("sequential run did not genotype every locus")
    want = dict(emission=2 * n, segment_scan=2 * n, segment=0, flank_scan=0)
    if n < SLICE_LOCI or launches != want:
        raise AssertionError(f"sequential: {n} aligner calls, launches "
                             f"{launches}, expected {want}")
    check_no_jax()
    recs = vcf_body(f"{tmp}/seq.vcf")
    if len(recs) != SLICE_LOCI:
        raise AssertionError(f"sequential VCF has {len(recs)} records")
    return launches, shapes, dict(loci_per_s=SLICE_LOCI / wall, wall_s=wall,
                                  aligner_calls=n)


# ---------------------------------------------------------------- phase 6
def slice_loci(tmp):
    """(region, aligner inputs) of the first-round alignment of every
    locus of the slice's dataset: the arguments of
    compute_hap_log_likelihoods before `dtype`."""
    from hipstr_tpu_torch.io.regions import read_regions
    from hipstr_tpu_torch.models.stutter import StutterModel
    from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline,
                                                     Logger, PipelineOptions)
    opts = PipelineOptions(
        min_reads=15, use_unpaired=True, dtype="float64",
        def_stutter_model=StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2))
    p = GenotyperPipeline([f"{tmp}/sim.bam"], f"{tmp}/sim.fa", opts,
                          Logger(quiet=True))
    loci = []
    for region in read_regions(f"{tmp}/regions.bed", SLICE_LOCI):
        g = p.prepare_locus_genotyper(region,
                                      p.fasta.get_sequence(region.chrom))
        if g is None:
            raise AssertionError(f"no genotyper for {region}")
        loci.append((region, (g.align_haplotype(), *g.pool_inputs())))
    return loci


@contextlib.contextmanager
def flank_mode():
    """While active, the genotyper's aligner calls run flank mode (K1 + K4,
    the stutter and forced-match rows in plain torch) in place of the
    sequential path's fused mode (K1 + K3)."""
    import functools
    from hipstr_tpu_torch.pipeline import genotyper
    orig = genotyper.compute_hap_log_likelihoods
    genotyper.compute_hap_log_likelihoods = functools.partial(orig,
                                                              mode="flank")
    try:
        yield
    finally:
        genotyper.compute_hap_log_likelihoods = orig


def want_launches(mode: str, n: int) -> dict:
    """Kernel launches of n aligner calls in `mode`: two K1 and two K3
    (fused) or four K4 (flank: two scans an orientation)."""
    return dict(emission=2 * n, segment=0,
                segment_scan=2 * n if mode == "fused" else 0,
                flank_scan=4 * n if mode == "flank" else 0)


def phase_modes(tmp, device, device_name="cuda"):
    """Flank mode (K1 + K4) against fused mode (K1 + K3, the sequential
    path's): (a) per aligner call, on the first-round alignment of every
    locus of the slice, float32 and float64, and traced; (b) the
    sequential slice through the CLI in float32, SEQ_MODE_RUNS runs of
    each mode in turn."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.pipeline import hap_aligner
    loci = slice_loci(tmp)
    n = len(loci)
    modes = ("flank", "fused")
    dtypes = ("float32", "float64")
    for dtype in dtypes:        # warm-up, not counted
        for mode in modes:
            hap_aligner.compute_hap_log_likelihoods(
                *loci[0][1], dtype=dtype, device=device, mode=mode)
    kernels.reset_launches()
    ms, worst = {}, {}
    for dtype in dtypes:
        rtol, atol = ((MODES_TOL, MODES_TOL) if dtype == "float64"
                      else TOL[("segment_scan", "float32")])
        seconds = dict.fromkeys(modes, 0.0)
        worst[dtype] = 0.0
        for i, (region, locus) in enumerate(loci):
            ll = {}
            for mode in modes if i % 2 else modes[::-1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                # ends in a copy to the host, which waits for the device
                ll[mode] = hap_aligner.compute_hap_log_likelihoods(
                    *locus, dtype=dtype, device=device, mode=mode)
                seconds[mode] += time.perf_counter() - t0
            diff = np.abs(ll["flank"] - ll["fused"])
            if not np.all(diff <= atol + rtol * np.abs(ll["flank"])):
                raise AssertionError(f"modes {dtype} differ by {diff.max()} "
                                     f"at {region}")
            worst[dtype] = max(worst[dtype], float(diff.max()))
        ms[dtype] = {m: 1e3 * seconds[m] / n for m in modes}
        log(f"modes {dtype}: {n} loci, max |LL flank - LL fused| "
            f"{worst[dtype]:.3e}; ms per aligner call flank "
            f"{ms[dtype]['flank']:.3f} fused {ms[dtype]['fused']:.3f}")
    launches = dict(kernels.LAUNCHES)
    want = {k: len(dtypes) * (want_launches("flank", n)[k]
                              + want_launches("fused", n)[k])
            for k in launches}
    if launches != want:
        raise AssertionError(f"modes: launches {launches}, expected {want}")
    # the device's work per aligner call, float32, by the profiler
    traced = {}
    for mode in modes:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _, locus in loci:
                hap_aligner.compute_hap_log_likelihoods(
                    *locus, dtype="float32", device=device, mode=mode)
            torch.cuda.synchronize()
        busy, kernel_events = device_events(prof)
        copies = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.name.startswith(("Memcpy", "Memset")))
        traced[mode] = dict(kernels_per_call=kernel_events / n,
                            copies_per_call=copies / n,
                            device_busy_ms_per_call=1e3 * busy / n)
        log(f"modes float32 traced, {mode}: per aligner call "
            f"{kernel_events / n:.1f} device kernels (the port's "
            f"{sum(want_launches(mode, 1).values())} among them), "
            f"{copies / n:.1f} copies and fills, device busy "
            f"{1e3 * busy / n:.3f} ms")
    check_no_jax()
    # (b) the sequential slice in float32, each mode in turn
    runs = {m: [] for m in modes}
    bodies = {}
    for i in range(SEQ_MODE_RUNS):
        for mode in modes if i % 2 == 0 else modes[::-1]:
            out = f"{tmp}/seq_{mode}_{i}.vcf"
            torch.cuda.synchronize()
            kernels.reset_launches()
            calls0 = hap_aligner.CALLS
            with flank_mode() if mode == "flank" else contextlib.nullcontext():
                t0 = time.perf_counter()
                _, counters = cli.run(slice_args(tmp, "sequential",
                                                 device_name)
                                      + ["--str-vcf", out])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            calls = hap_aligner.CALLS - calls0
            launches_run = dict(kernels.LAUNCHES)
            if (counters.genotype_success, counters.genotype_fail) != (
                    SLICE_LOCI, 0) or calls < SLICE_LOCI \
                    or launches_run != want_launches(mode, calls):
                raise AssertionError(
                    f"sequential {mode} run {i}: success="
                    f"{counters.genotype_success} fail="
                    f"{counters.genotype_fail}, {calls} aligner calls, "
                    f"launches {launches_run}")
            body = vcf_body(out)
            if bodies.setdefault(mode, body) != body:
                raise AssertionError(f"sequential {mode} run {i}: VCF differs "
                                     "from the mode's first run")
            runs[mode].append(dict(loci_per_s=SLICE_LOCI / wall,
                                   wall_s=wall, aligner_calls=calls))
            log(f"sequential f32 {mode} run {i}: {SLICE_LOCI / wall:.3f} "
                f"loci/s, wall {wall:.3f} s, {calls} aligner calls, "
                f"launches {launches_run}")
    if bodies["fused"] != vcf_body(f"{tmp}/seq.vcf"):
        raise AssertionError("sequential fused VCF differs from phase 5's")
    same = hold_bodies("sequential f32 fused vs flank", bodies["fused"],
                       bodies["flank"])
    check_no_jax()
    seq = {m: dict(runs=r, median_loci_per_s=float(np.median(
        [x["loci_per_s"] for x in r]))) for m, r in runs.items()}
    log(f"sequential f32 median loci/s: flank "
        f"{seq['flank']['median_loci_per_s']:.3f}, fused "
        f"{seq['fused']['median_loci_per_s']:.3f}; fused VCF {same}/"
        f"{SLICE_LOCI} records byte-identical to the flank VCF")
    loci_inputs = [locus for _, locus in loci]
    return launches, loci_inputs, dict(
        loci=n, max_abs_diff=worst, ms_per_call=ms, traced_f32=traced,
        sequential_f32=seq, fused_vs_flank_byte_identical=same)


# ---------------------------------------------------------------- phase 7
def phase_em_sequential(tmp, device_name="cuda"):
    """The sequential run without a stutter model: the host EM."""
    from hipstr_tpu_torch import cli
    pipeline, counters = cli.run(
        ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
         "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
         "--use-unpaired", "--batch-loci", "0", "--max-regions",
         str(EM_LOCI), "--dtype", "float32", "--device", device_name,
         "--silent", "--str-vcf", f"{tmp}/em.vcf"])
    recs = vcf_body(f"{tmp}/em.vcf")
    log(f"sequential EM: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} em_fail={counters.em_fail} "
        f"records={len(recs)}")
    if counters.genotype_fail or len(recs) != counters.genotype_success \
            or not recs:
        raise AssertionError("sequential EM run failed")
    check_no_jax()


def em_args(tmp, out, workers):
    """The slice's batched run (phase 4) without a stutter model."""
    return ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
            "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--batch-loci", str(EM_BATCH),
            "--host-workers", str(workers), "--dtype", "float32",
            "--device", "cuda", "--silent", "--str-vcf", out]


def device_events(prof):
    """(device busy s, kernel launches) of a torch.profiler run: the union
    of the card's event intervals, and its events other than copies and
    fills."""
    from torch.autograd import DeviceType
    ev = sorted(((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda x: x[0])
    busy, cur_start, cur_end = 0.0, None, None
    for start, stop, _ in ev:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, stop
        else:
            cur_end = max(cur_end, stop)
    if cur_end is not None:
        busy += cur_end - cur_start
    kernels = sum(1 for *_, name in ev
                  if not name.startswith(("Memcpy", "Memset")))
    return busy * 1e-6, kernels


@contextlib.contextmanager
def watchdog(seconds: int):
    """Print every thread's stack and exit non-zero if the block runs past
    `seconds`: a hung run ends with its stacks, not at the call's limit."""
    import faulthandler
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def em_slice_run(tmp, out, workers):
    """One EM run of the slice: (pipeline, counters, wall s, launches)."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with watchdog(POOL_WATCHDOG_S):
        pipeline, counters = cli.run(em_args(tmp, out, workers))
    torch.cuda.synchronize()
    return pipeline, counters, time.perf_counter() - t0, dict(
        kernels.LAUNCHES)


def em_run_stats(label, pipeline, counters, wall, launches):
    """Check and log one EM run of the slice; returns its numbers."""
    rs = pipeline.last_run_stats
    t = pipeline.timer.totals
    device_wait = t.get("Device fetch", 0.0)
    em_s = t.get("Stutter estimation (device)", 0.0)
    log(f"EM {label}: success={counters.genotype_success} "
        f"em_fail={counters.em_fail} fail={counters.genotype_fail} "
        f"dispatches={rs['dispatches']} card-shards={rs['card_shards']} "
        f"launches={launches}")
    log(f"EM {label}: {SLICE_LOCI / wall:.3f} loci/s, wall {wall:.3f} s, "
        f"host {wall - device_wait:.3f} s, device wait {device_wait:.3f} s, "
        f"Stutter estimation (device) {em_s:.3f} s in {rs['em_waves']} "
        f"waves, iterations {rs['em_iter_hist']}")
    # a pooled run's wall less its workers' start (spawn to first reply)
    start = t.get("Worker start", 0.0)
    if start:
        log(f"EM {label}: workers' start {start:.3f} s; after it "
            f"{SLICE_LOCI / (wall - start):.3f} loci/s over "
            f"{wall - start:.3f} s")
    log(pipeline.timer.summary())
    if counters.genotype_success + counters.em_fail != SLICE_LOCI \
            or counters.genotype_fail:
        raise AssertionError(f"EM {label}: not every locus settled")
    if not rs["em_waves"]:
        raise AssertionError(f"EM {label}: no device EM wave")
    for name in ("emission", "segment"):
        if launches[name] < 2 * rs["card_shards"]:
            raise AssertionError(f"EM {label}: kernel {name}: "
                                 f"{launches[name]} launches for "
                                 f"{rs['card_shards']} card-shards")
    for name in ("flank_scan", "segment_scan"):
        if launches[name]:
            raise AssertionError(f"EM {label}: kernel {name} launched on "
                                 "the batched path")
    check_no_jax()
    return dict(loci_per_s=SLICE_LOCI / wall, wall_s=wall,
                host_s=wall - device_wait, device_wait_s=device_wait,
                em_device_s=em_s, em_waves=rs["em_waves"],
                em_iter_hist=rs["em_iter_hist"], worker_start_s=start,
                success=counters.genotype_success, em_fail=counters.em_fail)


def phase_em(tmp):
    """(a) the slice without a stutter model, in-process, and its device
    idle share; (b) the same run pooled."""
    import torch
    from hipstr_tpu_torch import cli
    from torch.profiler import ProfilerActivity, profile
    # warm the device EM's ops on a few loci (not counted)
    cli.run(em_args(tmp, f"{tmp}/em_warm.vcf", 1) + ["--max-regions", "4"])
    a = em_run_stats("in-process", *em_slice_run(tmp, f"{tmp}/em_a.vcf", 1))
    # the device-idle share of the same run, traced (the tracing slows
    # the host, so its wall is its own)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cli.run(em_args(tmp, f"{tmp}/em_prof.vcf", 1))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, n_kernels = device_events(prof)
    a.update(profiled_wall_s=wall, device_busy_s=busy,
             device_idle_share=(1 - busy / wall) if busy else None,
             profiled_kernels=n_kernels)
    log(f"EM in-process, traced: wall {wall:.3f} s, device busy "
        f"{busy:.4f} s ({n_kernels} kernels): idle share "
        + (f"{100 * (1 - busy / wall):.2f} %" if busy else
           "not measured (the profiler saw no device time)"))
    check_no_jax()

    n_cores = len(os.sched_getaffinity(0))
    log(f"EM pooled: --host-workers -1 resolves to "
        f"{cli.resolve_host_workers(-1, torch.device('cuda'), n_cores)} "
        f"on this machine's {n_cores} cores")
    run_b = em_slice_run(tmp, f"{tmp}/em_b.vcf", EM_POOL_WORKERS)
    b = em_run_stats(f"pooled ({EM_POOL_WORKERS} workers)", *run_b)
    # run_pooled raises unless every worker kept CUDA uninitialised and
    # loaded no JAX: their reports
    reports = run_b[0].last_run_stats["workers"]
    log(f"EM pooled: worker reports {reports}")
    if len(reports) != EM_POOL_WORKERS or any(
            r["cuda_initialized"] or r["jax_loaded"] for r in reports):
        raise AssertionError("EM pooled: a worker touched CUDA or JAX")
    got, want = vcf_body(f"{tmp}/em_b.vcf"), vcf_body(f"{tmp}/em_a.vcf")
    if len(got) != len(want):
        raise AssertionError(f"EM pooled: {len(got)} records, in-process "
                             f"{len(want)}")
    same = sum(x == y for x, y in zip(got, want))
    for x, y in zip(got, want):
        if x != y and not within_drift_bands(x, y):
            raise AssertionError(f"EM pooled vs in-process outside the drift "
                                 f"bands:\n  pooled {x.strip()}\n  in-process "
                                 f"{y.strip()}")
    log(f"EM pooled vs in-process: {len(got)} records, {same} "
        f"byte-identical, the rest within the drift bands; bodies "
        f"byte-identical: {got == want}")
    b.update(records=len(got), byte_identical_records=same,
             child_import_s=child_import_s(EM_POOL_WORKERS))
    return dict(in_process=a, pooled=b)


def child_import_s(n: int, module: str = "hipstr_tpu_torch.parallel.workers",
                   tag: str = "EM pooled") -> dict:
    """Wall seconds for n fresh interpreters started together, as a pool's
    workers (or --workers children) are, to import nothing and to import
    `module` (torch and the port): the part of their start that is not
    the first locus."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    out = {}
    for label, code in (("bare", "pass"), (module, f"import {module}")):
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code], env=env)
                 for _ in range(n)]
        if any(p.wait() for p in procs):
            raise AssertionError(f"a child importing {label!r} failed")
        out[label] = time.perf_counter() - t0
    log(f"{tag}: {n} fresh interpreters started together: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in out.items()))
    return out


def slice_em_problems(tmp):
    """(EMProblem, host EM inputs) of every locus of the slice, staged as
    the batched run stages them."""
    from hipstr_tpu_torch.io.regions import read_regions
    from hipstr_tpu_torch.ops.em_batched import EMProblem
    from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline,
                                                     Logger, PipelineOptions)
    p = GenotyperPipeline([f"{tmp}/sim.bam"], f"{tmp}/sim.fa",
                          PipelineOptions(min_reads=15, use_unpaired=True),
                          Logger(quiet=True))
    out = []
    for region in read_regions(f"{tmp}/regions.bed", SLICE_LOCI):
        prep = p.prepare_reads(region, p.fasta.get_sequence(region.chrom))
        inputs = p.stutter_em_inputs(prep.alns_by_rg, prep.log_p1s,
                                     prep.log_p2s, region)
        out.append((EMProblem.build(prep.haploid, region.period, *inputs),
                    (prep.haploid, region.period, *inputs)))
    return out


def phase_em_train(tmp, device):
    """(c) the card's em_train_batch on the slice's EM problems, in waves
    of EM_BATCH: float64 against the host EM on the CPU, float32 against
    float64; seconds per wave; torch ops and kernel launches per
    iteration."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from hipstr_tpu_torch.ops import em_batched
    from hipstr_tpu_torch.ops.em import EMStutterGenotyper
    staged = slice_em_problems(tmp)
    waves = [staged[i:i + EM_BATCH] for i in range(0, len(staged), EM_BATCH)]
    rtol, atol = EM_TOL
    out = dict(waves=[], f64_max_rel_err=0.0, f32_max_abs_diff=0.0)
    for wave in waves:
        arrays, (Rm, Am, Sm) = em_batched.pack_problems([w[0] for w in wave])
        res, secs = {}, {}
        for name, dt in (("float32", torch.float32),
                         ("float64", torch.float64)):
            em_batched.em_train_batch(arrays, Sm, device, dt)   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = em_batched.em_train_batch(arrays, Sm, device, dt)
            res[name] = {k: v.cpu().numpy() for k, v in r.items()}
            secs[name] = time.perf_counter() - t0
        f64, f32 = res["float64"], res["float32"]
        for g, (_, raw) in enumerate(wave):
            host = EMStutterGenotyper(*raw, 0).train()
            sm = host.stutter_model
            want = np.array([sm.in_geom, sm.in_up, sm.in_down, sm.out_geom,
                             sm.out_up, sm.out_down])
            if bool(f64["converged"][g]) != host.converged or \
                    int(f64["iters"][g]) != host.num_iterations:
                raise AssertionError(
                    f"EM locus {g}: card converged={f64['converged'][g]} "
                    f"iters={f64['iters'][g]}, host {host.converged} "
                    f"{host.num_iterations}")
            err = np.abs(f64["params"][g] - want)
            if np.any(err > atol + rtol * np.abs(want)):
                raise AssertionError(f"EM locus {g}: card f64 params "
                                     f"{f64['params'][g]}, host {want}")
            out["f64_max_rel_err"] = max(out["f64_max_rel_err"], float(
                np.max(err / np.maximum(np.abs(want), atol))))
        d32 = float(np.max(np.abs(f32["params"].astype(np.float64)
                                  - f64["params"])))
        out["f32_max_abs_diff"] = max(out["f32_max_abs_diff"], d32)
        it = f64["iters"]
        # loop passes the call made: the last iteration, rounded up to the
        # host's read of `active`
        passes = min(100, -(-int(it.max()) // em_batched.SYNC_EVERY)
                     * em_batched.SYNC_EVERY)
        out["waves"].append(dict(
            G=len(wave), Rm=Rm, Am=Am, Sm=Sm, f32_s=secs["float32"],
            f64_s=secs["float64"], iters_max=int(it.max()),
            iters_mean=float(it.mean()), loop_passes=passes,
            f32_converged=int(f32["converged"].sum()),
            f32_iters_equal=bool(np.array_equal(f32["iters"], it))))
        log(f"EM wave G={len(wave)} Rm={Rm} Am={Am} Sm={Sm}: f32 "
            f"{secs['float32']:.4f} s, f64 {secs['float64']:.4f} s, "
            f"iterations max {int(it.max())} mean {float(it.mean()):.2f}, "
            f"f32 vs f64 params max |diff| {d32:.3e}")

    # torch ops and kernel launches per iteration, on the first wave in
    # float32: a call's count less the count of a call with no iteration
    arrays, (_, _, Sm) = em_batched.pack_problems([w[0] for w in waves[0]])

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for max_iter in (0, 100):
        with CountOps() as ops:
            em_batched.em_train_batch(arrays, Sm, device, torch.float32,
                                      max_iter=max_iter)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            em_batched.em_train_batch(arrays, Sm, device, torch.float32,
                                      max_iter=max_iter)
            torch.cuda.synchronize()
        counts[max_iter] = (ops.n, device_events(prof)[1])
    passes = out["waves"][0]["loop_passes"]
    out["ops_per_iter"] = (counts[100][0] - counts[0][0]) / passes
    out["kernels_per_iter"] = ((counts[100][1] - counts[0][1]) / passes
                               if counts[100][1] else None)
    log(f"EM float64 on the card vs the host EM: {len(staged)} loci, "
        f"converged flags and iterations equal, params max rel err "
        f"{out['f64_max_rel_err']:.3e} (rtol {rtol}, atol {atol}); float32 "
        f"vs float64 params max |diff| {out['f32_max_abs_diff']:.3e}")
    log(f"EM per iteration (wave 1, float32, {passes} loop passes): "
        f"{out['ops_per_iter']:.1f} torch ops, "
        + (f"{out['kernels_per_iter']:.1f} kernel launches"
           if out["kernels_per_iter"] is not None else
           "kernel launches not measured (the profiler saw none)")
        + f"; setup {counts[0][0]} ops, {counts[0][1]} kernels")
    check_no_jax()
    return out


# ---------------------------------------------------------------- phase 8
def vcf_body(path):
    return [l for l in open(path) if not l.startswith("#")]


def values_within(name: str, va: str, vb: str) -> bool:
    """One field's values (| or , separated): equal, or floats that are not
    integers within the golden suites' drift bands (0.5 for GLDIFF, 0.2
    otherwise)."""
    if va == vb:
        return True
    xa, xb = va.replace("|", ",").split(","), vb.replace("|", ",").split(",")
    if len(xa) != len(xb):
        return False
    try:
        xs = [(float(x), float(y)) for x, y in zip(xa, xb)]
    except ValueError:
        return False
    if name == "GT" or any(x.is_integer() and y.is_integer() for x, y in xs):
        return False
    band = 0.5 if name == "GLDIFF" else 0.2
    return all(abs(x - y) <= band for x, y in xs)


def within_drift_bands(a: str, b: str) -> bool:
    """Sites, genotype and integer fields equal, float fields (INFO's
    learned stutter parameters among them) within the golden suites' drift
    bands."""
    fa, fb = a.rstrip("\n").split("\t"), b.rstrip("\n").split("\t")
    if fa[:7] != fb[:7] or fa[8] != fb[8] or len(fa) != len(fb):
        return False
    ia = [kv.partition("=") for kv in fa[7].split(";")]
    ib = [kv.partition("=") for kv in fb[7].split(";")]
    if [k for k, _, _ in ia] != [k for k, _, _ in ib] or not all(
            values_within(k, va, vb) for (k, _, va), (_, _, vb) in zip(ia, ib)):
        return False
    fmt = fa[8].split(":")
    for sa, sb in zip(fa[9:], fb[9:]):
        pa, pb = sa.split(":"), sb.split(":")
        if len(pa) != len(pb) or not all(
                values_within(n, va, vb) for n, va, vb in zip(fmt, pa, pb)):
            return False
    return True


def hold_to_reference(label: str, out: str, ref: str,
                      show: bool = True) -> int:
    """The VCF body at `out` against the reference body at `ref`: the same
    records, each byte-identical or within the drift bands (each record
    that differs is logged when `show`).  Returns the byte-identical
    count."""
    return hold_bodies(label, vcf_body(out), vcf_body(ref), show)


def hold_bodies(label: str, got, want, show: bool = True) -> int:
    """hold_to_reference on VCF bodies (lists of record lines)."""
    if len(got) != len(want):
        raise AssertionError(f"{label} VCF: {len(got)} records, reference "
                             f"{len(want)}")
    diffs = [(a, b) for a, b in zip(got, want) if a != b]
    for a, b in diffs:
        if show:
            log(f"{label} differs from the reference:\n  port {a.strip()}"
                f"\n  ref  {b.strip()}")
        if not within_drift_bands(a, b):
            raise AssertionError(f"{label} VCF outside the golden drift "
                                 "bands")
    log(f"{label} cross-check: {len(got)} records, "
        f"{len(got) - len(diffs)} byte-identical to the reference")
    return len(got) - len(diffs)


def phase_em_reference(tmp, device_name="cuda"):
    """(d) the float64 VCF of the reference dataset without a stutter model
    (the device EM), in-process and pooled, against
    tests/data/torch_port_ref_em_f64.vcf."""
    from hipstr_tpu_torch import cli
    from hipstr_tpu_torch.utils.simdata import (REFERENCE_EM_ARGS,
                                                reference_loci, write_sim)
    write_sim(tmp, reference_loci())
    for label, workers in (("in-process", 1), ("pooled", EM_POOL_WORKERS)):
        out = f"{tmp}/ref64_em_{label}.vcf"
        with watchdog(POOL_WATCHDOG_S):
            pipeline, _ = cli.run(
                ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
                 "--regions", f"{tmp}/regions.bed", "--str-vcf", out,
                 "--dtype", "float64", "--device", device_name, "--silent",
                 "--host-workers", str(workers)] + REFERENCE_EM_ARGS)
        if not pipeline.last_run_stats["em_waves"]:
            raise AssertionError(f"f64 EM {label}: no device EM wave")
        hold_to_reference(f"f64 EM {label}", out, REF_EM_VCF)
    check_no_jax()


def phase_reference(tmp, device_name="cuda"):
    """The float64 VCF of the reference dataset, batched (K1 + K2) and
    sequential (K1 + K3), against tests/data/torch_port_ref_f64.vcf."""
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.utils.simdata import (REFERENCE_ARGS,
                                                reference_loci, write_sim)
    write_sim(tmp, reference_loci())
    for label, extra in (("batched", ["--host-workers", "1"]),
                         ("sequential", ["--batch-loci", "0"])):
        out = f"{tmp}/ref64_{label}.vcf"
        kernels.reset_launches()
        cli.run(["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
                 "--regions", f"{tmp}/regions.bed", "--str-vcf", out,
                 "--dtype", "float64", "--device", device_name, "--silent"]
                + REFERENCE_ARGS + extra)
        check_mode_launches(f"f64 {label}", dict(kernels.LAUNCHES),
                            label == "batched", True)
        hold_to_reference(f"f64 {label}", out, REF_VCF)

# ---------------------------------------------------------------- phase 9
# The least time the card could take for a kernel's work on these inputs:
# the larger of its operations over the peak rate of its type (an exp or a
# log counted as one operation, and also reported on its own) and its
# bytes over the memory rate (each input read once, each output written
# once).  Only the work these inputs need is counted: the real block
# lengths (K1), the active rows (K2, K3, K4), the emission planes of the
# options real haplotypes use (K2, K3).
#
#   per DP cell (lane x row) of a flank row: 16 operations (em select, the
#     insert chain's 5, M's 6, D's 3, 1 for the max-scan)
#   row 0 and the forced-match row: 2 per lane; the stutter row: 13 terms
#     of 8 operations (2 of them exp) and one log per lane
#   K1, per lane of a real option (blen > 0) and block step (blen + 1 of
#     them): 7 prefix updates of 2 operations, 12 log-sum-exp terms of 4
#     (one exp), 6 insertion-shift updates of 5; per lane 6*period
#     insertion-prefix steps of 2 operations and 13 outputs (a log each)
FLANK_OPS, EDGE_OPS, STUTTER_OPS = 16, 2, 13 * 8 + 1
K1_STEP_OPS, K1_STEP_EXP = 7 * 2 + 12 * 4 + 6 * 5, 12


def bound(ops, nbytes, exp_log, dtype_name):
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(ops=ops, bytes=nbytes, exp_log=exp_log,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def used_planes(hap_opt, h_real):
    """Emission planes (locus, option) that real haplotypes read."""
    return sum(len(set(ho[:hr].tolist())) for ho, hr in zip(hap_opt, h_real))


def bound_emission(args, kwargs, dtype_name):
    codes, blw, blc, brev, blen, periods = (x.cpu() for x in args)
    G, P, L = codes.shape
    O, B = brev.shape[1:]
    sz = blc.element_size()
    steps = (blen + 1) * (blen > 0)                          # [G, O]
    lanes_real = int((blen > 0).sum()) * P * L
    per = periods.long()[:, None].expand(G, O)[blen > 0]
    ops = P * L * (K1_STEP_OPS * int(steps.sum()) + 12 * int(per.sum())) \
        + lanes_real * 13
    exp_log = P * L * K1_STEP_EXP * int(steps.sum()) + lanes_real * 13
    nbytes = G * P * L * (4 + 2 * sz) + G * O * (B + 1) * 4 + G * 4 \
        + G * O * 13 * P * L * sz
    return bound(ops, nbytes, exp_log, dtype_name)


def bound_segment(args, kwargs, dtype_name):
    R, sr = kwargs["R"], kwargs["sr"]
    codes, blc = args[0], args[2]
    hap_opt, bounds = args[11].cpu(), args[14].cpu()
    G, P, L = codes.shape
    H, O = args[6].shape[1], args[10].shape[1]
    sz = blc.element_size()
    start1, end3, h_real = (bounds[:, k].long() for k in range(3))
    flank = (sr - start1) + (end3 - sr - 2)                  # [G]
    per_lane = FLANK_OPS * flank + 2 * EDGE_OPS + STUTTER_OPS
    lanes = h_real * P * L
    ops = int((lanes * per_lane).sum())
    exp_log = int(lanes.sum()) * (2 * 13 + 1)
    nbytes = G * P * L * (4 + 4 * sz) + G * P * 4 + G * H * R * (4 + 3 * sz) \
        + used_planes(hap_opt, h_real.tolist()) * 13 * P * L * sz \
        + G * H * (8 + 13 * sz) + G * 16 + G * H * R * P * sz
    return bound(ops, nbytes, exp_log, dtype_name)


def bound_flank_scan(args, kwargs, dtype_name):
    codes, blc, active = args[0], args[2], args[10].cpu()
    P, L = codes.shape
    n_rows, H = args[6].shape
    sz = blc.element_size()
    ops = FLANK_OPS * int(active.bool().sum()) * P * H * L
    nbytes = P * L * (4 + 4 * sz) + P * 4 + n_rows * H * (4 + 3 * sz) \
        + n_rows * 4 + 6 * P * H * L * sz + n_rows * P * H * sz
    return bound(ops, nbytes, 0, dtype_name)


def bound_segment_scan(args, kwargs, dtype_name):
    codes, blc, meta, R, sr = args[0], args[2], args[6], args[8], args[9]
    P, L = codes.shape
    H = meta.row_char.shape[0]
    sz = blc.element_size()
    active = meta.row_active.cpu().bool()
    flank = int(active[1:sr].sum()) + int(active[sr + 2:].sum())
    lanes = P * H * L
    ops = lanes * (FLANK_OPS * flank + 2 * EDGE_OPS + STUTTER_OPS)
    planes = len(set(meta.hap_opt.cpu().tolist()))
    nbytes = P * L * (4 + 4 * sz) + P * 4 + H * R * (4 + 3 * sz) + R * 4 \
        + planes * 13 * P * L * sz + H * (8 + 13 * sz) + R * P * H * sz
    return bound(ops, nbytes, lanes * (2 * 13 + 1), dtype_name)


class Capture:
    """While active, calls to `module.attr` (a kernel wrapper) go through,
    and the arguments of the first call of each wanted shape (any shape
    when `wanted` is None) are kept, cloned."""

    def __init__(self, module, attr, shape_of, wanted=None):
        self.module, self.attr = module, attr
        self.shape_of, self.wanted = shape_of, wanted
        self.args = {}

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)

        def wrapper(*args, **kwargs):
            s = self.shape_of(*args)
            if (self.wanted is None or s in self.wanted) \
                    and s not in self.args:
                self.args[s] = (clone(args), dict(kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def tree_map(fn, x):
    """fn applied to every tensor of x, through tuples, lists and
    NamedTuples (such as HapMeta); anything else (ints) passes through."""
    import torch
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        parts = [tree_map(fn, v) for v in x]
        if hasattr(x, "_fields"):
            return type(x)(*parts)
        return type(x)(parts)
    return x


def clone(x):
    return tree_map(lambda t: t.clone(), x)


def as_dtype(x, dt):
    """x with every floating tensor converted to dt."""
    return tree_map(lambda t: t.to(dt).contiguous() if t.is_floating_point()
                    else t, x)


def event_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of one `fn()` over `reps` launches, CUDA events
    around each launch, after one warm-up.  The launches are queued behind
    a device sleep, so the host's wrapper time does not show as device
    idle.  With `flush` (a tensor of FLUSH_BYTES) the tensor is written
    before every launch, so each launch finds L2 cold."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def top(hist, n=TOP_SHAPES):
    return [s for s, _ in hist.most_common(n)]


def shape_emission(codes, blw, blc, brev, *rest):
    return (codes.shape[0], brev.shape[1], codes.shape[1], codes.shape[2],
            brev.shape[2])


def shape_segment(*args):
    codes, row_char, E = args[0], args[6], args[10]
    return (codes.shape[0], row_char.shape[1], codes.shape[1],
            codes.shape[2], row_char.shape[2], E.shape[1])


def shape_flank_scan(*args):
    P, L = args[0].shape
    n_rows, H = args[6].shape
    return (P, H, L, n_rows)


def shape_segment_scan(*args):
    P, L = args[0].shape
    meta = args[6]
    return (P, meta.row_char.shape[0], L, args[8], meta.lpmf.shape[0])


def time_real(name, kernel, plain, bound_fn, args, kwargs, shape, count,
              flush):
    """One kernel at one captured shape, float32 and float64: error
    against the plain version, warm and flushed times, plain time, bound."""
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    rows = []
    for dtype_name in ("float32", "float64"):
        a = as_dtype(args, resolve_dtype(dtype_name))
        got, ref = kernel(*a, **kwargs), plain(*a, **kwargs)
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            err = max(compare(name, g, r, dtype_name)
                      for g, r in zip(got, ref))
        else:
            err = compare(name, got, ref, dtype_name)
        warm = event_ms(lambda: kernel(*a, **kwargs), REAL_REPS)
        cold = event_ms(lambda: kernel(*a, **kwargs), REAL_REPS, flush)
        plain_ms = cuda_ms(lambda: plain(*a, **kwargs), 1)
        b = bound_fn(a, kwargs, dtype_name)
        row = dict(shape=list(shape), launches_at_shape=count,
                   dtype=dtype_name, max_abs_err=err, ms=cold, ms_warm=warm,
                   plain_ms=plain_ms, share=b["bound_ms"] / cold, **b)
        log(f"real {name} {shape}x{count} {dtype_name}: err {err:.3e} "
            f"L2-flushed {cold:.4f} ms warm {warm:.4f} ms plain "
            f"{plain_ms:.3f} ms | bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} ({b['ops']:.3e} ops, {b['bytes']:.3e} bytes, "
            f"{b['exp_log']:.3e} exp/log): {100 * row['share']:.1f} % of "
            f"the bound")
        rows.append(row)
    return rows


def phase_real_shapes(tmp, device, slice_shapes, seq_shapes, loci):
    """Each kernel at its path's two most frequent launch shapes, on the
    arguments that path passed (captured in a second run of it)."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.ops import hmm2, hmm_scan
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.stutter_emission import stutter_emissions_plain
    from hipstr_tpu_torch.pipeline.hap_aligner import \
        compute_hap_log_likelihoods
    base = ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
            "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--def-stutter-model", "--dtype", "float32",
            "--device", "cuda", "--silent"]
    k1 = Capture(hmm2, "stutter_emissions", shape_emission,
                 top(slice_shapes["emission"]))
    k2 = Capture(hmm2, "segment_kernel", shape_segment,
                 top(slice_shapes["segment"]))
    with k1, k2:
        cli.run(base + ["--batch-loci", "32", "--host-workers", "1",
                        "--str-vcf", f"{tmp}/cap.vcf"])
    k3 = Capture(hmm_scan, "segment_scan_kernel", shape_segment_scan,
                 top(seq_shapes["segment_scan"]))
    with k3:
        cli.run(base + ["--batch-loci", "0", "--str-vcf", f"{tmp}/cap0.vcf"])
    # K4 leaves the CLI's paths: its shapes are flank mode's on the loci
    # of phase 6
    kernels.reset_launches()
    k4 = Capture(hmm_scan, "flank_scan_kernel", shape_flank_scan)
    with k4:
        for locus in loci:
            compute_hap_log_likelihoods(*locus, dtype="float32",
                                        device=device, mode="flank")
    k4_shapes = kernels.SHAPES["flank_scan"].copy()
    log_shapes("flank mode", {"flank_scan": k4_shapes})
    hists = dict(emission=slice_shapes["emission"],
                 segment=slice_shapes["segment"],
                 flank_scan=k4_shapes,
                 segment_scan=seq_shapes["segment_scan"])
    table = {
        "emission": (k1, stutter_emissions, stutter_emissions_plain,
                     bound_emission),
        "segment": (k2, hmm2.segment_kernel, hmm2.segment_forward_plain,
                    bound_segment),
        "flank_scan": (k4, hmm_scan.flank_scan_kernel,
                       hmm_scan.flank_scan_plain, bound_flank_scan),
        "segment_scan": (k3, hmm_scan.segment_scan_kernel,
                         hmm_scan.segment_scan_plain, bound_segment_scan),
    }
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    results, held = {}, {}
    for name, (cap, kernel, plain, bound_fn) in table.items():
        results[name] = []
        for shape in top(hists[name]):
            if shape not in cap.args:
                raise AssertionError(f"{name}: shape {shape} not captured")
            args, kwargs = cap.args[shape]
            results[name] += time_real(name, kernel, plain, bound_fn, args,
                                       kwargs, shape, hists[name][shape],
                                       flush)
            held.setdefault(name, []).append(
                (kernel, plain, shape,
                 tree_map(lambda t: t.to("cpu"), args), kwargs))
    del flush
    return results, held


# ---------------------------------------------------------------- phase 13
def phase_bench():
    """13a: the port bench once, --runs 3, the default model, shallow and
    deep, in-process and with the product-default --host-workers: every
    locus genotyped, two K1 and two K2 launches per card-shard; then a
    small bench in a fresh process."""
    from hipstr_tpu_torch import bench, kernels
    results = {}
    for label, workers in (("in-process", "1"), ("default workers", "-1")):
        kernels.reset_launches()
        t0 = time.perf_counter()
        with watchdog(BENCH_WATCHDOG_S):
            res = bench.main(BENCH_ARGS + ["--host-workers", workers])
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n = res["card_shards"]
        if not all(x and math.isfinite(x) and x > 0 for x in (
                res["kernel_ms_per_locus"], res["kernel_deep_ms_per_locus"],
                res["fetch_ms"], res["peak_device_mib"])):
            raise AssertionError(f"bench {label}: a device number is "
                                 "missing")
        log(f"bench {label} ({res['host_workers']} host workers): "
            f"{res['value']:.3f} loci/s deep (runs {res['loci_per_sec_runs']}"
            f"), {res['shallow_loci_per_sec']:.3f} shallow, kernel "
            f"{res['kernel_ms_per_locus']:.4f} / "
            f"{res['kernel_deep_ms_per_locus']:.4f} ms per locus, "
            f"{res['dispatches']} dispatches in {n} card-shards over "
            f"{res['device']['cards']} card(s), launches {launches}, "
            f"{wall:.1f} s")
        if (res["success"], res["fail"]) != (res["n_loci"], 0) or (
                res["shallow_success"], res["shallow_fail"]) != (
                res["shallow_n_loci"], 0):
            raise AssertionError(f"bench {label}: not every locus genotyped")
        if not n or launches["emission"] != 2 * n \
                or launches["segment"] != 2 * n \
                or launches["flank_scan"] or launches["segment_scan"]:
            raise AssertionError(f"bench {label}: launches {launches} for "
                                 f"{n} card-shards")
        if res["launches"] != launches:
            raise AssertionError(f"bench {label}: it counted "
                                 f"{res['launches']}, the kernels {launches}")
        check_no_jax()
        results[label] = dict(res, wall_s=wall)
    results["fresh process"] = bench_fresh_process()
    return results


def bench_fresh_process() -> dict:
    """The bench as a user starts it, in a fresh process (CUDA not yet
    initialised), at a small size: exit 0, every locus genotyped, two K1
    and two K2 launches per card-shard, sharded over every visible card."""
    import torch
    argv = [sys.executable, "-m", "hipstr_tpu_torch.bench", "--runs", "1",
            "--loci", "4", "--deep-loci", "0", "--batch-loci", "4",
            "--host-workers", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_WATCHDOG_S)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"bench in a fresh process: exit "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    n, launches = res["card_shards"], res["launches"]
    if (res["success"], res["fail"]) != (res["n_loci"], 0) or not n \
            or launches != dict(emission=2 * n, segment=2 * n,
                                flank_scan=0, segment_scan=0) \
            or res["device"]["cards"] != torch.cuda.device_count():
        raise AssertionError(f"bench in a fresh process: {res}")
    log(f"bench in a fresh process: {res['value']:.3f} loci/s on "
        f"{res['n_loci']} loci, {res['dispatches']} dispatches in {n} "
        f"card-shards over {res['device']['cards']} card(s), launches "
        f"{launches}, {wall:.1f} s with the interpreter's start")
    return dict(res, wall_s=wall)


class LeaderCapture(Capture):
    """While active, keeps on the host the arguments of the kernel's most
    frequent launch shape so far (taken when that shape takes the lead),
    so at the end those of the run's most frequent shape, in one pass."""

    def __init__(self, module, attr, shape_of):
        super().__init__(module, attr, shape_of)
        self.counts = Counter()
        self.leader = None

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)

        def wrapper(*args, **kwargs):
            s = self.shape_of(*args)
            self.counts[s] += 1
            if self.leader is None or (
                    s != self.leader
                    and self.counts[s] > self.counts[self.leader]):
                self.leader = s
                self.args = {s: (tree_map(lambda t: t.to("cpu", copy=True),
                                          args), dict(kwargs))}
            return self.orig(*args, **kwargs)

        setattr(self.module, self.attr, wrapper)
        return self


def integer_fields_equal(a: str, b: str) -> bool:
    """Sites, genotypes and every field whose values are all integers
    equal (floats not compared)."""
    fa, fb = a.rstrip("\n").split("\t"), b.rstrip("\n").split("\t")
    if fa[:7] != fb[:7] or fa[8] != fb[8] or len(fa) != len(fb):
        return False

    def ints(v):
        try:
            return [int(x) for x in re.split(r"[|,;/]", v)]
        except ValueError:
            return None

    pairs = [(ka, va, vb) for (ka, _, va), (_, _, vb) in zip(
        (kv.partition("=") for kv in fa[7].split(";")),
        (kv.partition("=") for kv in fb[7].split(";")))]
    fmt = fa[8].split(":")
    for sa, sb in zip(fa[9:], fb[9:]):
        pairs += list(zip(fmt, sa.split(":"), sb.split(":")))
    for name, va, vb in pairs:
        if name == "GT" and va != vb:
            return False
        if ints(vb) is not None and ints(va) != ints(vb):
            return False
    return True


def check_flat(bands) -> dict:
    """Max RSS and peak device memory flat from locus SOAK_FLAT_FROM on:
    no full band's value over SOAK_FLAT times the first such band's."""
    later = [b for b in bands if b["loci"] == SOAK_BAND
             and int(b["band"].split("-")[0]) >= SOAK_FLAT_FROM]
    if not later:
        raise AssertionError(f"soak: no full band from locus "
                             f"{SOAK_FLAT_FROM}: {bands}")
    growth = {}
    for key in ("max_rss_mb", "peak_device_mib"):
        ref = later[0][key]
        growth[key] = max(b[key] for b in later) / ref
        if growth[key] > SOAK_FLAT:
            raise AssertionError(f"soak: {key} grew {growth[key]:.3f}x after "
                                 f"band {later[0]['band']}: "
                                 f"{[b[key] for b in later]}")
    return growth


def phase_soak(tmp, device):
    """13b: the reduced soak (SOAK_LOCI x 20 samples x 30 reads, phased
    SNPs) in float32 in-process: every locus genotyped, memory flat, two
    K1 and two K2 launches per dispatch; its 2-locus prefix in float64
    batched and sequential byte-identical to the anchor, the float32
    run's first records equal to it in genotypes and integer fields.
    Returns the run's result and the captures of K1's and K2's most
    frequent launch shapes."""
    import torch
    from hipstr_tpu_torch import kernels
    from hipstr_tpu_torch.ops import hmm2
    from hipstr_tpu_torch.tools import soak
    t0 = time.perf_counter()
    gen_s = soak.ensure_dataset(tmp, SOAK_LOCI, SOAK_SAMPLES, SOAK_READS, log)
    log(f"soak dataset: {SOAK_LOCI} loci x {SOAK_SAMPLES} samples x "
        f"{SOAK_READS} reads in {gen_s:.1f} s")
    torch.cuda.synchronize()
    kernels.reset_launches()
    k1 = LeaderCapture(hmm2, "stutter_emissions", shape_emission)
    k2 = LeaderCapture(hmm2, "segment_kernel", shape_segment)
    with k1, k2:
        res = soak.run(tmp, device, window_s=SOAK_WINDOW_S, band=SOAK_BAND,
                       log=log)
    launches = dict(kernels.LAUNCHES)
    shapes = {k: kernels.SHAPES[k].copy() for k in ("emission", "segment")}
    log_shapes("soak", shapes)
    log(soak.band_table(res["bands"]))
    n = res["card_shards"]
    log(f"soak: success={res['success']} fail={res['fail']} "
        f"{res['loci_per_s']:.3f} loci/s, wall {res['wall_s']:.1f} s, "
        f"max RSS {res['max_rss_mb']:.0f} MB, peak device "
        f"{res['peak_device_mib']} MiB, {res['dispatches']} dispatches in "
        f"{n} card-shards over {res['device']['cards']} card(s), launches "
        f"{launches}")
    if (res["success"], res["fail"]) != (SOAK_LOCI, 0):
        raise AssertionError("soak: not every locus genotyped")
    if not n or launches["emission"] != 2 * n \
            or launches["segment"] != 2 * n \
            or launches["flank_scan"] or launches["segment_scan"]:
        raise AssertionError(f"soak: launches {launches} for {n} "
                             "card-shards")
    for cap, name in ((k1, "emission"), (k2, "segment")):
        if cap.counts != shapes[name]:
            raise AssertionError(f"soak: {name} captured shapes differ")
    res["memory_growth"] = check_flat(res["bands"])
    log(f"soak: memory from locus {SOAK_FLAT_FROM} on, largest band over "
        f"the first: {res['memory_growth']}")
    check_no_jax()

    want = vcf_body(SOAK_VCF)
    for batch, label in ((32, "batched"), (0, "sequential")):
        out = f"{tmp}/prefix_{label}.vcf"
        kernels.reset_launches()
        pre = soak.run(tmp, device, dtype="float64", batch_size=batch,
                       max_regions=len(want), out=out, window_s=1e9,
                       log=log)
        check_mode_launches(f"soak f64 {label} prefix",
                            dict(kernels.LAUNCHES), batch > 0, True)
        got = vcf_body(out)
        if (pre["success"], pre["fail"]) != (len(want), 0) or got != want:
            hold_bodies(f"soak f64 {label} prefix", got, want)
            raise AssertionError(f"soak f64 {label} prefix: not "
                                 "byte-identical to the anchor")
        log(f"soak f64 {label} prefix: {len(got)} records byte-identical to "
            f"{os.path.relpath(SOAK_VCF, ROOT)}, launches "
            f"{dict(kernels.LAUNCHES)}")
    got = vcf_body(f"{tmp}/out.vcf")[:len(want)]
    same = sum(a == b for a, b in zip(got, want))
    if not all(integer_fields_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("soak f32 prefix: genotypes or integer fields "
                             "differ from the anchor")
    log(f"soak f32 prefix: genotypes and integer fields equal to the "
        f"anchor, {same}/{len(want)} records byte-identical")
    check_no_jax()
    res.update(phase_s=time.perf_counter() - t0, generate_s=gen_s,
               f32_prefix_byte_identical=same)
    return res, {"emission": k1, "segment": k2}


def phase_soak_kernels(device, captures):
    """13c: K1 and K2 on the soak's arguments at their most frequent launch
    shape, float32 and float64: against the plain version, timed, beside
    the bound."""
    import torch
    from hipstr_tpu_torch.ops import hmm2
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.stutter_emission import stutter_emissions_plain
    table = {"emission": (stutter_emissions, stutter_emissions_plain,
                          bound_emission),
             "segment": (hmm2.segment_kernel, hmm2.segment_forward_plain,
                         bound_segment)}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    results = {}
    for name, (kernel, plain, bound_fn) in table.items():
        cap = captures[name]
        args, kwargs = cap.args[cap.leader]
        args = tree_map(lambda t: t.to(device), args)
        results[name] = time_real(name, kernel, plain, bound_fn, args,
                                  kwargs, cap.leader,
                                  cap.counts[cap.leader], flush)
    del flush
    check_no_jax()
    return results


# --------------------------------------------------------------- phase 10
def phase_golden(tmp):
    """Every golden configuration on the card, float64 batched and
    sequential and float32 batched, against its float64 anchor; each run's
    launches counted from 0."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.utils.simdata import (GOLDEN_CONFIGS, golden_args,
                                                write_golden)
    out = {}
    for name, (dataset, _) in GOLDEN_CONFIGS.items():
        d = f"{tmp}/{name}"
        write_golden(d, **dataset)
        for label, dtype, extra in GOLDEN_RUNS:
            vcf = f"{d}/{label.replace(' ', '_')}.vcf"
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            _, counters = cli.run(golden_args(name, d, vcf) + [
                "--dtype", dtype, "--device", "cuda"] + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if counters.genotype_fail:
                raise AssertionError(f"golden {name} {label}: fail="
                                     f"{counters.genotype_fail}")
            check_mode_launches(f"golden {name} {label}", launches,
                                "--batch-loci" not in extra, True)
            same = hold_to_reference(
                f"golden {name} {label}", vcf,
                os.path.join(ROOT, "tests", "data",
                             f"torch_port_golden_{name}_f64.vcf"),
                show=dtype == "float64")
            n = len(vcf_body(vcf))
            loci = dataset["loci"]
            log(f"golden {name} {label}: {n} records, {same} byte-identical "
                f"to the f64 anchor, wall {wall:.3f} s, {loci / wall:.3f} "
                f"loci/s, launches {launches}")
            out[f"{name} {label}"] = dict(records=n, byte_identical=same,
                                          wall_s=wall, loci_per_s=loci / wall,
                                          launches=launches)
        check_no_jax()
    return out


# --------------------------------------------------------------- phase 11
def denovo_finder(args):
    """The port's DenovoFinder in-process; (wall s, the dispatches it
    made)."""
    import torch
    from hipstr_tpu_torch import denovo_finder as finder
    from hipstr_tpu_torch.denovo import likelihoods
    likelihoods.DISPATCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if finder.main(args):
        raise AssertionError(f"denovo_finder {args} failed")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, list(likelihoods.DISPATCHES)


def dispatch_stats(dispatches) -> dict:
    """Jobs, dispatches, their seconds (upload to results on the host),
    the largest dispatch's bytes and jobs per allele bucket; every dispatch
    within the budget (or a single job)."""
    from hipstr_tpu_torch.denovo.likelihoods import DISPATCH_BYTES
    over = [x for x in dispatches
            if x["bytes"] > DISPATCH_BYTES and x["jobs"] > 1]
    if over:
        raise AssertionError(f"dispatches over the budget: {over[:3]}")
    buckets = {}
    for x in dispatches:
        buckets[x["Ap"]] = buckets.get(x["Ap"], 0) + x["jobs"]
    return dict(jobs=sum(x["jobs"] for x in dispatches),
                dispatches=len(dispatches),
                dispatch_s=sum(x["s"] for x in dispatches),
                max_dispatch_bytes=max((x["bytes"] for x in dispatches),
                                       default=0),
                jobs_per_bucket=dict(sorted(buckets.items())))


def phase_denovo_chain(tmp):
    """(a) the de novo golden suite's trio: genotyped on the card in float64
    against its anchor, then both scans with --device-batch 256
    byte-identical to the JAX DenovoFinder's anchors."""
    from hipstr_tpu_torch import cli
    from hipstr_tpu_torch.utils.simdata import (DENOVO_GENOTYPE_ARGS,
                                                write_phased_snps,
                                                write_trio_denovo)
    locs = write_trio_denovo(tmp)
    snps = write_phased_snps(tmp, [l.chrom for l in locs])
    str_vcf = f"{tmp}/str.vcf"
    cli.run(["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
             "--regions", f"{tmp}/regions.bed", "--str-vcf", str_vcf,
             "--dtype", "float64", "--device", "cuda", "--silent",
             "--host-workers", "1"] + DENOVO_GENOTYPE_ARGS)
    same = hold_to_reference("de novo STR f64", str_vcf, DENOVO_STR_VCF)
    out = dict(str_records=len(vcf_body(str_vcf)), str_byte_identical=same)
    for scan in ("trio", "family"):
        vcf = f"{tmp}/{scan}.vcf"
        wall, dispatches = denovo_finder(
            ["--fam", f"{tmp}/trio.fam", "--str-vcf", str_vcf,
             "--denovo-vcf", vcf, "--device", "cuda", "--device-batch",
             "256"] + (["--snp-vcf", snps] if scan == "family" else []))
        got = vcf_body(vcf)
        want = vcf_body(os.path.join(ROOT, "tests", "data",
                                     f"torch_port_denovo_{scan}_f64.vcf"))
        if got != want or not got:
            for a, b in zip(got, want):
                if a != b:
                    log(f"de novo {scan} differs:\n  port {a.strip()}\n  "
                        f"ref  {b.strip()}")
            raise AssertionError(f"de novo {scan} scan: {len(got)} records, "
                                 f"not the anchor's {len(want)}")
        stats = dispatch_stats(dispatches)
        log(f"de novo chain {scan} scan: {len(got)} records byte-identical "
            f"to the anchor, wall {wall:.3f} s, {stats}")
        out[scan] = dict(wall_s=wall, **stats)
    check_no_jax()
    return out


HOST_FINDER = ("import sys\n"
               "from hipstr_tpu_torch.denovo_finder import main\n"
               "rc = main(sys.argv[1:])\n"
               "assert not [m for m in sys.modules if sys.modules[m] is not "
               "None and m.split('.')[0] in ('jax', 'hipstr_tpu')]\n"
               "sys.exit(rc)\n")


def phase_denovo_cohort(tmp, card):
    """(b) the synthetic 1000-record, 100-family cohort: both scans on the
    card, and the first COHORT_HOST_RECORDS records on the host path in two
    processes (no card, no JAX) run beside them."""
    import torch
    from hipstr_tpu_torch.utils.simdata import write_denovo_cohort
    t0 = time.perf_counter()
    fam, str_vcf, snp_vcf = write_denovo_cohort(tmp)
    lines = open(str_vcf).read().splitlines(keepends=True)
    header = [l for l in lines if l.startswith("#")]
    body = [l for l in lines if not l.startswith("#")]
    n_samples = len(header[-1].split("\t")) - 9
    head = f"{tmp}/head.vcf"
    with open(head, "w") as fh:
        fh.writelines(header + body[:COHORT_HOST_RECORDS])
    log(f"de novo cohort: {len(body)} records, {n_samples} samples, "
        f"written in {time.perf_counter() - t0:.2f} s")
    scans = {"trio": [], "family": ["--snp-vcf", snp_vcf]}
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    procs = {scan: subprocess.Popen(
        [sys.executable, "-c", HOST_FINDER, "--fam", fam, "--str-vcf", head,
         "--denovo-vcf", f"{tmp}/host_{scan}.vcf", "--device", "cpu",
         "--device-batch", "0"] + extra, env=env, cwd=ROOT)
        for scan, extra in scans.items()}
    out = {}
    try:
        for scan, extra in scans.items():
            torch.cuda.reset_peak_memory_stats()
            vcf = f"{tmp}/card_{scan}.vcf"
            wall, dispatches = denovo_finder(
                ["--fam", fam, "--str-vcf", str_vcf, "--denovo-vcf", vcf,
                 "--device", "cuda", "--device-batch", "256"] + extra)
            stats = dispatch_stats(dispatches)
            peak = torch.cuda.max_memory_allocated()
            n = len(vcf_body(vcf))
            if n != len(body):
                raise AssertionError(f"cohort {scan}: {n} records")
            log(f"de novo cohort {scan} scan on the card: {n} records in "
                f"{wall:.3f} s = {n / wall:.3f} records/s, {stats}, peak "
                f"device memory {peak / 2**20:.1f} MiB ({card})")
            out[scan] = dict(records=n, wall_s=wall, records_per_s=n / wall,
                             peak_device_bytes=peak, **stats)
        t0 = time.perf_counter()
        for scan, proc in procs.items():
            if proc.wait(timeout=HOST_WATCHDOG_S):
                raise AssertionError(f"cohort host {scan} scan failed")
        log(f"de novo cohort: host runs done {time.perf_counter() - t0:.3f} "
            "s after the card's")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for scan in scans:
        host = vcf_body(f"{tmp}/host_{scan}.vcf")
        card_lines = vcf_body(f"{tmp}/card_{scan}.vcf")[:len(host)]
        if len(host) != COHORT_HOST_RECORDS or host != card_lines:
            raise AssertionError(f"cohort {scan}: the card's first "
                                 f"{len(host)} records differ from the "
                                 "host path's")
        log(f"de novo cohort {scan}: the first {len(host)} records equal "
            "on the card and the host path")
    check_no_jax()
    return out


# --------------------------------------------------------------- phase 12
def trace_kernels(path: str, names) -> dict:
    """Kernel events of a torch.profiler trace, by kernel: events of
    category "kernel" whose name holds `<name>_kernel` (the __global__
    names of csrc/*.cu)."""
    import re
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    pats = {n: re.compile(rf"\b{n}_kernel\b") for n in names}
    return {n: sum(1 for e in events if e.get("cat") == "kernel"
                   and pat.search(e.get("name", ""))) for n, pat in pats.items()}


def half_unit(token: str) -> float:
    """Half a unit in the last digit of a value printed with %g (six
    significant digits)."""
    v = abs(float(token))
    return 0.5 * 10.0 ** (math.floor(math.log10(v)) - 5) if v else 0.0


def hold_models(label: str, got: str, want: str, learned: dict) -> None:
    """A stutter-model file that the device EM learned on the card against
    the JAX host EM's (both as text): the same loci and periods, and each
    parameter equal or, where a printed digit differs, both values printed
    and the card's unrounded value within rtol 1e-8 (the EM parity rule) of
    the anchor's, beyond its printed rounding."""
    if got == want:
        return
    def cols(text):
        return {(t[0], int(t[1]), int(t[2])): t[3:]
                for t in (l.split() for l in text.splitlines() if l)}
    g, w = cols(got), cols(want)
    if g.keys() != w.keys():
        raise AssertionError(f"{label}: models for {sorted(g)}, anchor "
                             f"{sorted(w)}")
    names = ("in_geom", "in_down", "in_up", "out_geom", "out_down", "out_up")
    for key, want_toks in w.items():
        if len(g[key]) != 7 or len(want_toks) != 7 or \
                g[key][6] != want_toks[6]:
            raise AssertionError(f"{label}: {key} card {g[key]}, anchor "
                                 f"{want_toks} (six parameters and the "
                                 "period)")
        for name, gt, wt in zip(names, g[key], want_toks):
            if gt == wt:
                continue
            exact = getattr(learned[key], name)
            log(f"{label} {key} {name}: card {gt} ({exact!r}), JAX host EM "
                f"{wt}")
            if abs(exact - float(wt)) > EM_TOL[0] * abs(float(wt)) + \
                    half_unit(wt):
                raise AssertionError(f"{label}: {name} of {key} outside "
                                     "rtol 1e-8")


def check_mode_launches(label, launches, batched, genotyped) -> None:
    """K1 + K2 (batched) or K1 + K3 (sequential) launched when a locus was
    genotyped, and no other kernel."""
    used, unused = (("emission", "segment"), ("flank_scan", "segment_scan")) \
        if batched else (("emission", "segment_scan"), ("segment",
                                                        "flank_scan"))
    if any(launches[k] for k in unused) or (
            genotyped and not all(launches[k] for k in used)):
        raise AssertionError(f"{label}: launches {launches}")


def phase_cli_modes(tmp, device_name="cuda"):
    """(a) every CLI mode of the JAX tests (utils.simdata.MODE_CONFIGS) on
    the card, float64 batched and sequential and float32 batched, against
    its float64 anchors; each mode's launches counted from 0."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.utils.simdata import (MODE_CONFIGS, mode_products,
                                                mode_runs, mode_vcf_body,
                                                product_digest)
    with open(MODES_JSON) as fh:
        anchors = json.load(fh)
    out = {}
    for name, mode in MODE_CONFIGS.items():
        d = f"{tmp}/{name}"
        os.makedirs(d)
        mode.write(d)
        anchor = os.path.join(ROOT, "tests", "data",
                              f"torch_port_mode_{name}_f64.vcf")
        want = vcf_body(anchor) if os.path.exists(anchor) else []
        for label, dtype, extra in GOLDEN_RUNS:
            o = f"{d}/{label.replace(' ', '_')}"
            os.makedirs(o)
            batched = "--batch-loci" not in extra
            torch.cuda.synchronize()
            kernels.reset_launches()
            walls, learned, genotyped = [], {}, 0
            for run_label, args in mode_runs(name, d, o):
                t0 = time.perf_counter()
                pipeline, counters = cli.run(
                    args + ["--dtype", dtype, "--device", device_name]
                    + extra)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if counters.genotype_fail:
                    raise AssertionError(f"mode {name} {label} {run_label}: "
                                         f"fail={counters.genotype_fail}")
                genotyped += counters.genotype_success
                if "--stutter-out" in args:
                    learned = pipeline._stutter_out
                    if batched and not pipeline.last_run_stats["em_waves"]:
                        raise AssertionError(f"mode {name} {label}: no "
                                             "device EM wave")
            launches = dict(kernels.LAUNCHES)
            check_mode_launches(f"mode {name} {label}", launches, batched,
                                genotyped)
            got = mode_vcf_body(name, o)
            products = {k: product_digest(k, v)
                        for k, v in mode_products(name, d, o).items()}
            if products.keys() != anchors[name].keys():
                raise AssertionError(f"mode {name} {label}: outputs "
                                     f"{sorted(products)}")
            same_products = [k for k in products
                             if products[k]["sha256"] ==
                             anchors[name][k]["sha256"]]
            if dtype == "float64":
                if got != want:
                    hold_bodies(f"mode {name} {label}", got, want)
                    raise AssertionError(f"mode {name} {label}: VCF bodies "
                                         "differ from the f64 anchor")
                for k in products:
                    # the device EM's models (batched runs on the card) are
                    # held at rtol 1e-8; the sequential run's host EM, a copy
                    # of the JAX one, and every other output byte for byte
                    if k.endswith(".txt") and batched:
                        hold_models(f"mode {name} {label} {k}",
                                    products[k]["text"],
                                    anchors[name][k]["text"], learned)
                    elif products[k] != anchors[name][k]:
                        raise AssertionError(f"mode {name} {label}: {k} "
                                             "differs from the f64 anchor")
                same = len(got)
            else:
                same = hold_bodies(f"mode {name} {label}", got, want,
                                   show=False)
            log(f"mode {name} {label}: {len(got)} records, {same} "
                f"byte-identical to the f64 anchor, outputs identical "
                f"{sorted(same_products)} of {sorted(products)}, run walls "
                + ", ".join(f"{w:.3f}" for w in walls)
                + f" s, launches {launches}")
            out[f"{name} {label}"] = dict(
                records=len(got), byte_identical=same, run_walls_s=walls,
                outputs_identical=len(same_products),
                outputs=len(products), launches=launches)
        check_no_jax()
    return out


def port_command(tmp, out, extra, device_name="cuda"):
    """`python -m hipstr_tpu_torch.cli` on the reference dataset in float64
    on the card."""
    from hipstr_tpu_torch.utils.simdata import REFERENCE_ARGS
    return [sys.executable, "-m", "hipstr_tpu_torch.cli", "--bams",
            f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa", "--regions",
            f"{tmp}/regions.bed", "--str-vcf", out, "--dtype", "float64",
            "--device", device_name] + REFERENCE_ARGS + extra


def timed_run(cmd, label):
    """Run `cmd` under the scale-out watchdog; (wall s, stderr)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True,
                          timeout=SCALE_WATCHDOG_S)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"{label} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return wall, proc.stderr


def phase_workers(tmp, device_name="cuda"):
    """(b) --workers 2 on the card against one process, both profiled,
    merged into a bgzipped VCF with its tabix index; one process without
    the profiler gives the profiler's cost."""
    from hipstr_tpu_torch.io.bgzf import BgzfReader
    from hipstr_tpu_torch.io.vcf_read import VCFReader
    from hipstr_tpu_torch.utils.simdata import reference_loci, write_sim
    locs = reference_loci()
    write_sim(tmp, locs)
    want = vcf_body(REF_VCF)
    out = {}
    for label, extra, traced in (
            ("one process, no profiler", [], False),
            ("one process", [], True),
            ("--workers 2", ["--workers", "2"], True)):
        tag = f"{label.split()[-1]}{int(traced)}"
        vcf, trace = f"{tmp}/w{tag}.vcf.gz", f"{tmp}/trace_w{tag}"
        wall, _ = timed_run(port_command(tmp, vcf, extra + ["--silent"] + (
            ["--profile", trace] if traced else []), device_name), label)
        got = [l + "\n" for l in BgzfReader(vcf).read_all().decode()
               .splitlines() if l and not l.startswith("#")]
        if got != want:
            raise AssertionError(f"{label}: merged body differs from "
                                 "tests/data/torch_port_ref_f64.vcf")
        l0 = locs[0]
        hits = list(VCFReader(vcf).query(l0.chrom, l0.region.start - 5,
                                         l0.region.stop + 5))
        if len(hits) != 1:
            raise AssertionError(f"{label}: tabix query gave {len(hits)}")
        if not traced:
            log(f"{label} on the card: {len(got)} records equal to the f64 "
                f"anchor, .tbi query 1 hit, wall {wall:.3f} s")
            out[label] = dict(wall_s=wall)
            continue
        traces = sorted(os.listdir(trace))
        counts = [trace_kernels(f"{trace}/{t}", ("emission", "segment"))
                  for t in traces]
        sizes = [os.path.getsize(f"{trace}/{t}") for t in traces]
        if len(traces) != (2 if extra else 1) or not all(
                c["emission"] and c["segment"] for c in counts):
            raise AssertionError(f"{label}: traces {traces}, kernels {counts}")
        log(f"{label} on the card: {len(got)} records equal to the f64 "
            f"anchor, .tbi query 1 hit, wall {wall:.3f} s; traces "
            f"{sizes} bytes, K1/K2 events per process {counts}")
        out[label] = dict(wall_s=wall, trace_bytes=sizes,
                          trace_kernels=counts)
    leftovers = [f for f in os.listdir(tmp) if ".shard" in f]
    if leftovers:
        raise AssertionError(f"--workers left {leftovers}")
    out["child_import_s"] = child_import_s(2, "hipstr_tpu_torch.cli",
                                           "--workers 2")
    check_no_jax()
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_distributed(tmp, device_name="cuda"):
    """(c) --distributed: two gloo ranks on the one card."""
    want = vcf_body(REF_VCF)
    vcf = f"{tmp}/dist.vcf"
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(port_command(tmp, vcf, [
        "--quiet", "--host-workers", "1", "--distributed", "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
        str(rank)], device_name), cwd=ROOT, env=env, stderr=subprocess.PIPE,
        text=True)
        for rank in range(2)]
    try:
        errs = [p.communicate(timeout=SCALE_WATCHDOG_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError("--distributed: a rank failed:\n"
                             + "\n".join(e[-3000:] for e in errs))
    for rank, err in enumerate(errs):
        if f"[{rank}/2] global Summary: success={len(want)} fail=0" not in err:
            raise AssertionError(f"rank {rank}: no global summary:\n"
                                 f"{err[-3000:]}")
    if vcf_body(vcf) != want:
        raise AssertionError("--distributed: merged body differs from "
                             "tests/data/torch_port_ref_f64.vcf")
    leftovers = [f for f in os.listdir(tmp) if ".dshard" in f]
    if leftovers:
        raise AssertionError(f"--distributed left {leftovers}")
    log(f"--distributed, 2 gloo ranks on one card: {len(want)} records "
        f"equal to the f64 anchor, global summary on both ranks, wall "
        f"{wall:.3f} s")
    check_no_jax()
    return dict(wall_s=wall)


def phase_profile(tmp, device_name="cuda"):
    """(d) --profile in-process on the slice, batched and sequential: each
    VCF equal to the same run's without the profiler (phases 4 and 5), the
    trace holding each kernel the run launched."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    out = {}
    for mode, plain, names in (("batched", "slice.vcf",
                                ("emission", "segment")),
                               ("sequential", "seq.vcf",
                                ("emission", "segment_scan"))):
        vcf, trace = f"{tmp}/prof_{mode}.vcf", f"{tmp}/trace_{mode}"
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        cli.run(slice_args(tmp, mode, device_name) + [
            "--str-vcf", vcf, "--profile", trace])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: kernels.LAUNCHES[n] for n in names}
        if vcf_body(vcf) != vcf_body(f"{tmp}/{plain}"):
            raise AssertionError(f"--profile {mode}: VCF differs from the "
                                 "run without the profiler")
        traces = os.listdir(trace)
        size = os.path.getsize(f"{trace}/{traces[0]}")
        counts = trace_kernels(f"{trace}/{traces[0]}", names)
        if len(traces) != 1 or not all(counts.values()) or \
                counts != launches:
            raise AssertionError(f"--profile {mode}: traces {traces}, "
                                 f"kernel events {counts} for launches "
                                 f"{launches}")
        log(f"--profile {mode}: {SLICE_LOCI} loci, VCF equal to the run "
            f"without the profiler, wall {wall:.3f} s, trace {size} bytes, "
            f"kernel events {counts} for launches {launches}")
        out[mode] = dict(wall_s=wall, trace_bytes=size, trace_kernels=counts,
                         launches=launches)
    check_no_jax()
    return out


# --------------------------------------------------------------- phase 14
def sharded_run(label, argv, devices):
    """One CLI run with every batched dispatch sharded over `devices`,
    launches counted from 0: every locus genotyped, K1 and K2 launched
    twice per card-shard and no other kernel, a dispatch split over the
    shards; returns its numbers."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    cards = sorted(set(devices), key=str)
    for d in cards:
        torch.cuda.synchronize(d)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipeline, counters = cli.run(argv, devices=devices)
    for d in cards:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rs = pipeline.last_run_stats
    n = rs["card_shards"]
    log(f"shards {label}: {len(devices)} shards on {[str(d) for d in cards]}"
        f", success={counters.genotype_success} "
        f"fail={counters.genotype_fail}, {rs['dispatches']} dispatches in "
        f"{n} card-shards, launches {launches}, wall {wall:.3f} s")
    if counters.genotype_fail or not counters.genotype_success:
        raise AssertionError(f"shards {label}: not every locus genotyped")
    if launches != dict(emission=2 * n, segment=2 * n, flank_scan=0,
                        segment_scan=0):
        raise AssertionError(f"shards {label}: launches {launches} for {n} "
                             "card-shards")
    if rs["cards"] != len(cards) or rs["shards_per_dispatch"] != len(
            devices) or not rs["dispatches"] < n <= len(devices) * rs[
            "dispatches"]:
        raise AssertionError(f"shards {label}: no dispatch split over the "
                             f"shards: {rs}")
    check_no_jax()
    return dict(shards=len(devices), cards=len(cards),
                dispatches=rs["dispatches"], card_shards=n,
                launches=launches, wall_s=wall)


def hold_kernels_on(card, held) -> dict:
    """Each kernel at phase 9's shapes, on the arguments phase 9 captured,
    on `card`: float32 and float64 against its plain version there, at
    TOL; returns the largest error per kernel and type."""
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    out = {}
    for name, rows in held.items():
        for kernel, plain, shape, args, kwargs in rows:
            for dtype_name in ("float32", "float64"):
                a = as_dtype(tree_map(lambda t: t.to(card), args),
                             resolve_dtype(dtype_name))
                got, ref = kernel(*a, **kwargs), plain(*a, **kwargs)
                torch.cuda.synchronize(card)
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                if any(g.device != card for g in got):
                    raise AssertionError(f"{name} on {card}: result on "
                                         f"{[str(g.device) for g in got]}")
                err = max(compare(name, g, r, dtype_name)
                          for g, r in zip(got, ref))
                key = f"{name} {dtype_name}"
                out[key] = max(out.get(key, 0.0), err)
                log(f"{card} {name} {shape} {dtype_name}: err {err:.3e}")
    return out


def phase_shards(tmp, held):
    """14: the batched dispatch sharded over several devices.  Two shards
    on the first card: the slice in float32 (its VCF equal to phase 4's
    one-shard run) and the `default` golden configuration in float64
    (byte-identical to its anchor), K1 and K2 twice per card-shard.  With
    two or more cards, the same runs over every card, each kernel held to
    its plain version on the last card at phase 9's shapes, and
    graft_entry.dryrun_multichip over every card; with one card that leg
    is reported as not run."""
    import torch
    from hipstr_tpu_torch import cli
    from hipstr_tpu_torch.device import local_devices
    from hipstr_tpu_torch.graft_entry import dryrun_multichip
    from hipstr_tpu_torch.utils.simdata import golden_args
    golden = f"{tmp}/golden/default"
    anchor = os.path.join(ROOT, "tests", "data",
                          "torch_port_golden_default_f64.vcf")
    want_slice = vcf_body(f"{tmp}/slice/slice.vcf")

    def runs(label, devices):
        res = {}
        out = f"{tmp}/slice/shards_{label}.vcf"
        res["slice f32"] = sharded_run(
            f"{label} slice f32", slice_args(f"{tmp}/slice", "batched")
            + ["--str-vcf", out], devices)
        got = vcf_body(out)
        if got != want_slice:
            hold_bodies(f"shards {label} slice f32", got, want_slice)
            raise AssertionError(f"shards {label}: the slice's VCF differs "
                                 "from the one-shard run")
        out = f"{golden}/shards_{label}.vcf"
        res["golden default f64"] = sharded_run(
            f"{label} golden default f64", golden_args("default", golden, out)
            + ["--dtype", "float64", "--device", "cuda", "--host-workers",
               "1"], devices)
        got, want = vcf_body(out), vcf_body(anchor)
        if got != want:
            hold_bodies(f"shards {label} golden default f64", got, want)
            raise AssertionError(f"shards {label}: the golden VCF is not "
                                 "byte-identical to its anchor")
        log(f"shards {label}: slice f32 VCF equal to the one-shard run "
            f"({len(want_slice)} records), golden default f64 "
            f"byte-identical to {os.path.relpath(anchor, ROOT)}")
        return res

    cards = local_devices("cuda")
    out = {"one card": runs("one card", [cards[0]] * 2)}
    if len(cards) < 2:
        log(f"shards: cross-card leg NOT RUN: torch.cuda.device_count() = "
            f"{len(cards)}; it needs two or more cards")
        out["cross_card"] = f"not run: {len(cards)} card visible"
        return out
    out["every card"] = runs(f"{len(cards)} cards", cards)
    # the same slice in one shard on the first card, for the wall
    t0 = time.perf_counter()
    _, counters = cli.run(slice_args(f"{tmp}/slice", "batched") + [
        "--str-vcf", f"{tmp}/slice/one_shard.vcf"], devices=cards[:1])
    torch.cuda.synchronize(cards[0])
    wall = time.perf_counter() - t0
    if vcf_body(f"{tmp}/slice/one_shard.vcf") != want_slice:
        raise AssertionError("shards: the one-shard slice VCF differs")
    log(f"shards: slice f32 in one shard on {cards[0]}: wall {wall:.3f} s")
    out["one shard wall_s"] = wall
    out["kernels on the last card"] = hold_kernels_on(cards[-1], held)
    dryrun_multichip(len(cards), "cuda")
    out["cross_card"] = f"ran on {len(cards)} cards"
    check_no_jax()
    return out


def cross_card_main() -> int:
    """`--cross-card`: phase 14 alone on a host of two or more cards, with
    what it reads from earlier phases (1, 2, 4, 5, 6, 9's captures and the
    `default` golden dataset)."""
    import torch
    if torch.cuda.device_count() < 2:
        print("chip_smoke --cross-card: needs two or more visible cards",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    phase_env()
    phase_build()
    from hipstr_tpu_torch.device import resolve_device
    from hipstr_tpu_torch.utils.simdata import (trio_loci, write_golden,
                                                write_sim)
    device = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.makedirs(f"{tmp}/slice")
        write_sim(f"{tmp}/slice", trio_loci(SLICE_LOCI, SLICE_READS))
        _, slice_shapes, _ = phase_slice(f"{tmp}/slice")
        _, seq_shapes, _ = phase_sequential(f"{tmp}/slice")
        _, loci, _ = phase_modes(f"{tmp}/slice", device)
        _, held = phase_real_shapes(f"{tmp}/slice", device, slice_shapes,
                                    seq_shapes, loci)
        write_golden(f"{tmp}/golden/default", loci=3, samples=3, reads=40)
        t0 = time.perf_counter()
        shards = phase_shards(tmp, held)
        log(f"phase 14 (sharded dispatch) took "
            f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps({"shards": shards}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = phase_env()
    check_no_jax()
    ptxas = phase_build()
    check_no_jax()
    from hipstr_tpu_torch.device import resolve_device
    from hipstr_tpu_torch.utils.simdata import (reference_loci, trio_loci,
                                                write_sim)
    device = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.makedirs(f"{tmp}/slice")
        os.makedirs(f"{tmp}/ref")
        t0 = time.perf_counter()
        write_sim(f"{tmp}/slice", trio_loci(SLICE_LOCI, SLICE_READS))
        log(f"dataset: {SLICE_LOCI} loci x 3 samples x {SLICE_READS} reads "
            f"in {time.perf_counter() - t0:.2f} s")
        kres = phase_kernels(device, f"{tmp}/slice")
        check_no_jax()
        # each path's launches, counted from 0 over that path's run
        launches, slice_shapes, slice_stats = phase_slice(f"{tmp}/slice")
        seq_launches, seq_shapes, seq_stats = phase_sequential(
            f"{tmp}/slice")
        mode_launches, loci, mode_stats = phase_modes(f"{tmp}/slice", device)
        phase_em_sequential(f"{tmp}/slice")
        em_stats = phase_em(f"{tmp}/slice")
        em_stats["train"] = phase_em_train(f"{tmp}/slice", device)
        os.makedirs(f"{tmp}/ref_em")
        phase_em_reference(f"{tmp}/ref_em")
        phase_reference(f"{tmp}/ref")
        check_no_jax()
        real, held = phase_real_shapes(f"{tmp}/slice", device,
                                       slice_shapes, seq_shapes, loci)
        check_no_jax()
        t0 = time.perf_counter()
        golden = phase_golden(f"{tmp}/golden")
        log(f"phase 10 (golden) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        os.makedirs(f"{tmp}/denovo")
        denovo = dict(chain=phase_denovo_chain(f"{tmp}/denovo"),
                      cohort=phase_denovo_cohort(f"{tmp}/cohort", card))
        log(f"phase 11 (de novo) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for sub in ("modes", "workers", "dist"):
            os.makedirs(f"{tmp}/{sub}")
        scale = dict(cli_modes=phase_cli_modes(f"{tmp}/modes"))
        log(f"phase 12a (CLI modes) took {time.perf_counter() - t0:.1f} s")
        scale["workers"] = phase_workers(f"{tmp}/workers")
        write_sim(f"{tmp}/dist", reference_loci())
        scale["distributed"] = phase_distributed(f"{tmp}/dist")
        scale["profile"] = phase_profile(f"{tmp}/slice")
        log(f"phase 12 (CLI modes, scale-out, profiler) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        measuring = dict(bench=phase_bench())
        log(f"phase 13a (bench) took {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        soak_res, captures = phase_soak(f"{tmp}/soak", device)
        log(f"phase 13b (soak) took {time.perf_counter() - t1:.1f} s")
        soak_real = phase_soak_kernels(device, captures)
        measuring["soak"] = {k: v for k, v in soak_res.items()
                             if k != "windows"}
        log(f"phase 13 (bench, soak, soak shapes) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        shards = phase_shards(tmp, held)
        log(f"phase 14 (sharded dispatch) took "
            f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps({"slice": slice_stats, "sequential": seq_stats,
                    "modes": mode_stats, "em": em_stats, "golden": golden,
                    "denovo": denovo, "scale": scale, "card": card,
                    "measuring": measuring, "shards": shards,
                    "ptxas": {k: ptxas[k] for k in ("flank_scan",
                                                    "segment_scan")}}))
    # K3 from the sequential path (phase 5), K4 from flank mode (phase 6)
    launches.update(segment_scan=seq_launches["segment_scan"],
                    flank_scan=mode_launches["flank_scan"])
    main32 = kres[("main", "float32")]
    summary = {"kernels": []}
    for name, (src, rep) in SOURCES.items():
        r = real[name][0]            # the most frequent shape, float32
        summary["kernels"].append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], ms_warm=r["ms_warm"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            share=r["share"], exp_log=r["exp_log"], shape=r["shape"],
            library_ms=None, main_shape_ms=main32[name][1],
            main_shape_bound_ms=main32[name][3]))
        if name in soak_real:        # phase 13c: the soak's shape, f32
            s = soak_real[name][0]
            summary["kernels"][-1].update(
                soak_launches=soak_res["launches"][name],
                soak_shape=s["shape"], soak_ms=s["ms"],
                soak_plain_ms=s["plain_ms"], soak_bound_ms=s["bound_ms"],
                soak_bound_by=s["bound_by"],
                soak_max_abs_err=s["max_abs_err"])
    if not all(k["launches"] > 0 for k in summary["kernels"]):
        raise AssertionError(f"a kernel was never launched: {summary}")
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cross_card_main() if sys.argv[1:] == ["--cross-card"]
             else main())
