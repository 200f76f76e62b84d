#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hipstr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. environment: torch/CUDA/nvcc versions, triton, the card's name and
     power limit, whether the native host library loaded;
  2. build: the four CUDA kernels (K1 emission, K2 segment, K4 flank scan,
     K3 fused segment) from hipstr_tpu_torch/csrc, one nvcc each, all at
     once;
  3. each kernel against its plain PyTorch version on the card, float32
     and float64, at the main-path shape and a deep shape, with times;
  4. the batched slice: `hipstr_tpu_torch.cli` in-process on 60 simulated
     30x trio loci (float32, --batch-loci 32); 60/60 genotyped, K1 and K2
     launched at least twice per dispatch, K3 and K4 never, JAX never
     imported;
  5. the sequential slice: the same run with --batch-loci 0; 60/60
     genotyped, per aligner call two K1 and four K4 launches, no K2 or K3;
  6. the two per-locus modes on the 60 real loci: the first-round
     alignment of each in float64, flank mode (K4) against fused mode
     (K3), LL within 1e-8;
  7. the sequential run without a stutter model (host EM) on 8 loci;
  8. float64 cross-check: the port's VCF on the dataset behind
     tests/data/torch_port_ref_f64.vcf, batched and sequential, against
     that file.

Prints the kernel summary as one JSON line, then as the last line
{"ok": true, "device": {...}}.  Needs one visible CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_f64.vcf")
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
SCAN_DEEP_P = 1024   # K3/K4 deep shape: the largest pool bucket
MODES_TOL = 1e-8     # flank vs fused LL, float64 (rtol and atol)
EM_LOCI = 8
SOURCES = {   # kernel -> (source, the TPU kernel it replaces)
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


def log(msg: str) -> None:
    print(msg, flush=True)


def check_no_jax() -> None:
    if sys.modules.get("jax") is not None:
        raise AssertionError("jax was imported")


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
    from hipstr_tpu_torch.host import native
    log(f"native host library loaded: {native._load() is not None}")
    return card


# ---------------------------------------------------------------- phase 2
def phase_build():
    from hipstr_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"built {len(kernels.LAUNCHES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in kernels.LAUNCHES:
        info = kernels.BUILD_INFO[name]
        log(f"built {name}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


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
    return err, ms, plain_ms


def real_locus(tmp):
    """One real locus of the slice's dataset, packed through the main
    path's host code and prepare_locus: (arrays, statics)."""
    from hipstr_tpu_torch.host import (GenotyperPipeline, Logger,
                                       PipelineOptions, StutterModel,
                                       read_regions)
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
    return err, ms, plain_ms, R


def scan_inputs(P, dtype_name, device, rng, arrays, statics):
    """K4/K3 inputs with the forward row structure, H, L and repeat options
    of a real locus and P random reads."""
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    from hipstr_tpu_torch.ops.hmm import HapMeta, expand_quals, shift_right
    dt = resolve_dtype(dtype_name)
    R, sr, period = statics[0], statics[2], statics[4]
    L = arrays[0].codes.shape[1]
    codes, quals, last = (x[0] for x in reads(rng, 1, P, L, device, period))
    blw, blc = expand_quals(quals, dt)
    C = torch.cumsum(blc, dim=-1)
    meta = HapMeta(*[to_device(x, device, dt) for x in arrays[2]])
    return ((codes.int().contiguous(), blw, blc, C, shift_right(C, 0.0),
             last.int().contiguous()), meta, R, sr, period)


def check_flank_scan(P, dtype_name, device, rng, arrays, statics):
    """K4 over the phase-1 rows of a real locus from its row-0 state."""
    from hipstr_tpu_torch.ops.hmm import IMPOSSIBLE, emit_locus
    from hipstr_tpu_torch.ops.hmm_scan import (flank_scan_kernel,
                                               flank_scan_plain)
    import torch
    rd, meta, R, sr, _ = scan_inputs(P, dtype_name, device, rng, arrays,
                                     statics)
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
    ms = cuda_ms(lambda: flank_scan_kernel(*args), 5)
    plain_ms = cuda_ms(lambda: flank_scan_plain(*args), 2)
    return err, ms, plain_ms


def check_segment_scan(P, dtype_name, device, rng, arrays, statics):
    """K3 over the forward orientation of a real locus (E from K1)."""
    import torch
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.hmm_scan import (segment_scan_kernel,
                                               segment_scan_plain)
    rd, meta, R, sr, period = scan_inputs(P, dtype_name, device, rng,
                                          arrays, statics)
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
    ms = cuda_ms(lambda: segment_scan_kernel(*args), 5)
    plain_ms = cuda_ms(lambda: segment_scan_plain(*args), 2)
    return err, ms, plain_ms


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
            e_err, e_ms, e_plain = check_emission(shape, dtype_name, device,
                                                  rng)
            s_err, s_ms, s_plain, R2 = check_segment(
                shape, dtype_name, device, rng, arrays[2], statics)
            f = check_flank_scan(P, dtype_name, device, rng, arrays, statics)
            k3 = check_segment_scan(P, dtype_name, device, rng, arrays,
                                    statics)
            results[(label, dtype_name)] = dict(
                emission=(e_err, e_ms, e_plain), segment=(s_err, s_ms, s_plain),
                flank_scan=f, segment_scan=k3)
            log(f"{label} {dtype_name} G={shape['G']} O={shape['O']} "
                f"P={shape['P']} L={shape['L']} Bmax={shape['Bmax']} "
                f"H={shape['H']} R={R2}: "
                f"emission err {e_err:.3e} kernel {e_ms:.3f} ms plain "
                f"{e_plain:.3f} ms | segment err {s_err:.3e} kernel "
                f"{s_ms:.3f} ms plain {s_plain:.3f} ms")
            log(f"{label} {dtype_name} one locus P={P} H={H} L={L} O={O} "
                f"R={R} sr={statics[2]} period={statics[4]}: "
                f"flank_scan err {f[0]:.3e} kernel {f[1]:.3f} ms plain "
                f"{f[2]:.3f} ms | segment_scan err {k3[0]:.3e} kernel "
                f"{k3[1]:.3f} ms plain {k3[2]:.3f} ms")
    return results


# ---------------------------------------------------------------- phase 4
def phase_slice(tmp, device_name="cuda"):
    import torch
    from hipstr_tpu_torch import cli, kernels
    args = ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
            "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--def-stutter-model", "--batch-loci", "32",
            "--dtype", "float32", "--device", device_name, "--silent"]
    # warm the CUDA context and allocator on a few loci (not counted)
    cli.run(args + ["--str-vcf", f"{tmp}/warm.vcf", "--max-regions", "4"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipeline, counters = cli.run(args + ["--str-vcf", f"{tmp}/slice.vcf"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    dispatches = pipeline.last_run_stats["dispatches"]
    device_wait = pipeline.timer.totals.get("Device fetch", 0.0)
    log(f"slice: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} dispatches={dispatches} "
        f"launches={launches}")
    log(f"slice: {SLICE_LOCI / wall:.3f} loci/s, wall {wall:.3f} s, "
        f"host {wall - device_wait:.3f} s, device wait {device_wait:.3f} s")
    log(pipeline.timer.summary())
    if counters.genotype_success != SLICE_LOCI or counters.genotype_fail:
        raise AssertionError("slice did not genotype every locus")
    for name in ("emission", "segment"):
        if launches[name] < 2 * dispatches:
            raise AssertionError(f"kernel {name}: {launches[name]} launches "
                                 f"for {dispatches} dispatches")
    for name in ("flank_scan", "segment_scan"):   # per-locus kernels only
        if launches[name]:
            raise AssertionError(f"kernel {name} launched on the batched "
                                 "path")
    check_no_jax()
    recs = vcf_body(f"{tmp}/slice.vcf")
    if len(recs) != SLICE_LOCI:
        raise AssertionError(f"slice VCF has {len(recs)} records")
    return launches, dict(loci_per_s=SLICE_LOCI / wall, wall_s=wall,
                          host_s=wall - device_wait,
                          device_wait_s=device_wait)


# ---------------------------------------------------------------- phase 5
def phase_sequential(tmp, device_name="cuda"):
    """The sequential run (--batch-loci 0) on the slice's loci."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.pipeline import hap_aligner
    args = ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
            "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--def-stutter-model", "--batch-loci", "0",
            "--dtype", "float32", "--device", device_name, "--silent"]
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
    n = hap_aligner.CALLS - calls0
    log(f"sequential: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} aligner calls={n} "
        f"launches={launches}")
    log(f"sequential: {SLICE_LOCI / wall:.3f} loci/s, wall {wall:.3f} s")
    log(pipeline.timer.summary())
    if counters.genotype_success != SLICE_LOCI or counters.genotype_fail:
        raise AssertionError("sequential run did not genotype every locus")
    want = dict(emission=2 * n, flank_scan=4 * n, segment=0, segment_scan=0)
    if n < SLICE_LOCI or launches != want:
        raise AssertionError(f"sequential: {n} aligner calls, launches "
                             f"{launches}, expected {want}")
    check_no_jax()
    recs = vcf_body(f"{tmp}/seq.vcf")
    if len(recs) != SLICE_LOCI:
        raise AssertionError(f"sequential VCF has {len(recs)} records")
    return launches, dict(loci_per_s=SLICE_LOCI / wall, wall_s=wall,
                          aligner_calls=n)


# ---------------------------------------------------------------- phase 6
def phase_modes(tmp, device):
    """Flank mode (K4) against fused mode (K3) on the first-round
    alignment of every locus of the slice, float64."""
    import numpy as np
    import torch
    from hipstr_tpu_torch import kernels
    from hipstr_tpu_torch.host import (GenotyperPipeline, Logger,
                                       PipelineOptions, StutterModel,
                                       read_regions)
    from hipstr_tpu_torch.pipeline.hap_aligner import \
        compute_hap_log_likelihoods
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
            raise AssertionError(f"modes: no genotyper for {region}")
        loci.append((region, (g.align_haplotype(), *g.pool_inputs())))
    modes = ("flank", "fused")
    for mode in modes:      # warm-up, not counted
        compute_hap_log_likelihoods(*loci[0][1], dtype="float64",
                                    device=device, mode=mode)
    kernels.reset_launches()
    seconds = dict.fromkeys(modes, 0.0)
    worst = 0.0
    for region, locus in loci:
        ll = {}
        for mode in modes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # ends in a copy to the host, which waits for the device
            ll[mode] = compute_hap_log_likelihoods(
                *locus, dtype="float64", device=device, mode=mode)
            seconds[mode] += time.perf_counter() - t0
        diff = np.abs(ll["flank"] - ll["fused"])
        if not np.all(diff <= MODES_TOL + MODES_TOL * np.abs(ll["flank"])):
            raise AssertionError(f"modes differ by {diff.max()} at "
                                 f"{region}")
        worst = max(worst, float(diff.max()))
    launches = dict(kernels.LAUNCHES)
    n = len(loci)
    want = dict(emission=4 * n, flank_scan=4 * n, segment=0,
                segment_scan=2 * n)
    if launches != want:
        raise AssertionError(f"modes: launches {launches}, expected {want}")
    check_no_jax()
    ms = {m: 1e3 * seconds[m] / n for m in modes}
    log(f"modes: {n} loci, max |LL flank - LL fused| {worst:.3e}; "
        f"ms per call flank {ms['flank']:.3f} fused {ms['fused']:.3f}; "
        f"launches={launches}")
    return launches, dict(loci=n, max_abs_diff=worst, flank_ms=ms["flank"],
                          fused_ms=ms["fused"])


# ---------------------------------------------------------------- phase 7
def phase_em(tmp, device_name="cuda"):
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


# ---------------------------------------------------------------- phase 8
def vcf_body(path):
    return [l for l in open(path) if not l.startswith("#")]


def within_drift_bands(a: str, b: str) -> bool:
    """Genotype and integer fields equal, float fields within the golden
    suites' drift bands (0.5 for GLDIFF, 0.2 otherwise)."""
    fa, fb = a.rstrip("\n").split("\t"), b.rstrip("\n").split("\t")
    if fa[:9] != fb[:9] or len(fa) != len(fb):
        return False
    fmt = fa[8].split(":")
    for sa, sb in zip(fa[9:], fb[9:]):
        pa, pb = sa.split(":"), sb.split(":")
        if len(pa) != len(pb):
            return False
        for name, va, vb in zip(fmt, pa, pb):
            if va == vb:
                continue
            try:
                xs = [(float(x), float(y)) for x, y in
                      zip(va.split("|"), vb.split("|"))]
            except ValueError:
                return False
            if name == "GT" or any(x.is_integer() and y.is_integer()
                                   for x, y in xs):
                return False
            band = 0.5 if name == "GLDIFF" else 0.2
            if any(abs(x - y) > band for x, y in xs):
                return False
    return True


def phase_reference(tmp, device_name="cuda"):
    """The float64 VCF of the reference dataset, batched and sequential,
    against tests/data/torch_port_ref_f64.vcf."""
    from hipstr_tpu_torch import cli
    from hipstr_tpu_torch.utils.simdata import (REFERENCE_ARGS,
                                                reference_loci, write_sim)
    write_sim(tmp, reference_loci())
    want = vcf_body(REF_VCF)
    for label, extra in (("batched", []), ("sequential", ["--batch-loci",
                                                          "0"])):
        out = f"{tmp}/ref64_{label}.vcf"
        cli.run(["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
                 "--regions", f"{tmp}/regions.bed", "--str-vcf", out,
                 "--dtype", "float64", "--device", device_name, "--silent"]
                + REFERENCE_ARGS + extra)
        got = vcf_body(out)
        if len(got) != len(want):
            raise AssertionError(f"f64 {label} VCF: {len(got)} records, "
                                 f"reference {len(want)}")
        diffs = [(a, b) for a, b in zip(got, want) if a != b]
        for a, b in diffs:
            log(f"f64 {label} differs from the reference:\n  port "
                f"{a.strip()}\n  ref  {b.strip()}")
            if not within_drift_bands(a, b):
                raise AssertionError(f"f64 {label} VCF outside the golden "
                                     "drift bands")
        log(f"f64 cross-check ({label}): {len(got)} records, "
            f"{len(got) - len(diffs)} byte-identical to the reference")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = phase_env()
    phase_build()
    from hipstr_tpu_torch.device import resolve_device
    from hipstr_tpu_torch.utils.simdata import trio_loci, write_sim
    device = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.makedirs(f"{tmp}/slice")
        os.makedirs(f"{tmp}/ref")
        t0 = time.perf_counter()
        write_sim(f"{tmp}/slice", trio_loci(SLICE_LOCI, SLICE_READS))
        log(f"dataset: {SLICE_LOCI} loci x 3 samples x {SLICE_READS} reads "
            f"in {time.perf_counter() - t0:.2f} s")
        kres = phase_kernels(device, f"{tmp}/slice")
        # each path's launches, counted from 0 over that path's run
        launches, slice_stats = phase_slice(f"{tmp}/slice")
        seq_launches, seq_stats = phase_sequential(f"{tmp}/slice")
        mode_launches, mode_stats = phase_modes(f"{tmp}/slice", device)
        phase_em(f"{tmp}/slice")
        phase_reference(f"{tmp}/ref")
    check_no_jax()
    log(json.dumps({"slice": slice_stats, "sequential": seq_stats,
                    "modes": mode_stats, "card": card}))
    launches.update(flank_scan=seq_launches["flank_scan"],
                    segment_scan=mode_launches["segment_scan"])
    main32 = kres[("main", "float32")]
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": main32[name][0],
         "ms": main32[name][1], "plain_ms": main32[name][2]}
        for name, (src, rep) in SOURCES.items()]}
    if not all(k["launches"] > 0 for k in summary["kernels"]):
        raise AssertionError(f"a kernel was never launched: {summary}")
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
